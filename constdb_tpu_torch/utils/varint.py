"""Variable-width integer encoding for the snapshot format.

The port's own copy of the reference package's utils/varint.py.  Same
capability as reference src/snapshot.rs:25-37/244-264 (1/2/4/9-byte
envelope selected by magnitude, tag in the top 2 bits), redesigned to be
well-defined for the full signed 64-bit range:

  tag 0 (1 byte):  value in [0, 2^6)       0b00vvvvvv
  tag 1 (2 bytes): value in [0, 2^14)      0b01vvvvvv vvvvvvvv   (big-endian)
  tag 2 (4 bytes): value in [0, 2^30)      0b10vvvvvv ...        (big-endian)
  tag 3 (9 bytes): any u64                 0b11000000 + 8 BE bytes

Signed values use zigzag mapping (the reference's encoder silently corrupts
negatives — SURVEY.md §2.6).
"""

from __future__ import annotations

_TAG3 = 0b11000000


def write_uvarint(out: bytearray, v: int) -> None:
    if v < 0:
        raise ValueError("uvarint must be non-negative")
    if v < 1 << 6:
        out.append(v)
    elif v < 1 << 14:
        out += (v | (0b01 << 14)).to_bytes(2, "big")
    elif v < 1 << 30:
        out += (v | (0b10 << 30)).to_bytes(4, "big")
    elif v < 1 << 64:
        out.append(_TAG3)
        out += v.to_bytes(8, "big")
    else:
        raise ValueError("uvarint out of range")


def zigzag(v: int) -> int:
    return (v << 1) ^ (v >> 63) if v < 0 else v << 1


def unzigzag(u: int) -> int:
    return (u >> 1) ^ -(u & 1)


def write_varint(out: bytearray, v: int) -> None:
    if not (-(1 << 63) <= v < (1 << 63)):
        raise ValueError("varint out of i64 range")
    write_uvarint(out, zigzag(v))


def read_uvarint(buf, pos: int) -> tuple[int, int]:
    """-> (value, next_pos). Raises IndexError on truncated input."""
    flag = buf[pos]
    tag = flag >> 6
    if tag == 0:
        return flag, pos + 1
    if tag == 1:
        end = pos + 2
        if end > len(buf):
            raise IndexError("truncated varint")
        v = int.from_bytes(buf[pos:end], "big") & ((1 << 14) - 1)
        if v < 1 << 6:
            raise ValueError("non-canonical varint (overlong 2-byte form)")
        return v, end
    if tag == 2:
        end = pos + 4
        if end > len(buf):
            raise IndexError("truncated varint")
        v = int.from_bytes(buf[pos:end], "big") & ((1 << 30) - 1)
        if v < 1 << 14:
            raise ValueError("non-canonical varint (overlong 4-byte form)")
        return v, end
    if flag != _TAG3:
        raise ValueError("non-canonical varint (tag-3 flag low bits set)")
    end = pos + 9
    if end > len(buf):
        raise IndexError("truncated varint")
    v = int.from_bytes(buf[pos + 1:end], "big")
    if v < 1 << 30:
        raise ValueError("non-canonical varint (overlong 9-byte form)")
    return v, end


def read_varint(buf, pos: int) -> tuple[int, int]:
    u, nxt = read_uvarint(buf, pos)
    return unzigzag(u), nxt


class VarintReader:
    """Cursor-style reader over a bytes-like object."""

    __slots__ = ("buf", "pos")

    def __init__(self, buf, pos: int = 0):
        self.buf = buf
        self.pos = pos

    def uvarint(self) -> int:
        v, self.pos = read_uvarint(self.buf, self.pos)
        return v

    def varint(self) -> int:
        v, self.pos = read_varint(self.buf, self.pos)
        return v

    def take(self, n: int) -> bytes:
        end = self.pos + n
        if end > len(self.buf):
            raise IndexError("truncated bytes")
        b = bytes(self.buf[self.pos:end])
        self.pos = end
        return b

    def byte(self) -> int:
        b = self.buf[self.pos]
        self.pos += 1
        return b

    @property
    def remaining(self) -> int:
        return len(self.buf) - self.pos
