"""Chunked compression framing: the compressed snapshot container.

The port's own copy of the reference package's utils/compressio.py.  In
the reference the same framing also carries replication payloads and
full/delta-sync windows; in the port it serves the on-disk snapshot
container (persist/snapshot.py), which is magic-tagged so plain snapshot
files stay loadable beside it.

Layout (all integers little-endian):

    magic   b"CSTPUZ1\\n" (8 bytes)
    alg     1 byte — 1 = zlib (streams), 2 = lzma (bulk containers);
            a decoder seeing an unknown alg raises, never guesses
    chunk*:
        comp_len  u32 (0 terminates the stream)
        filt      u8 — pre-compression filter: 0 = none, 1 = stride-8
                  byte transposition (below)
        raw_len   u32
        crc       u32 — crc32 of the RAW chunk bytes (post-unfilter, so
                  the check covers the whole decode pipeline)
        payload   comp_len bytes
    end     u32 0

The transposition filter is the classic columnar shuffle: a chunk of a
snapshot stream is dominated by little-endian i64 planes (HLC uuid
columns), whose high bytes are near-constant and whose low bytes drift
slowly when the dump iterates keys in creation order.  Regrouping every
8th byte turns those planes into long near-constant lanes that deflate
crushes — measured 3-4x smaller containers on uuid-ordered keyspace
dumps, while pure-text chunks keep filter 0 (the writer picks per chunk
by trial when asked to).

Integrity is STRUCTURAL and per-chunk: every decoder validates magic,
alg, chunk geometry (bounded lengths, so a crafted header cannot force
an unbounded allocation before validation catches up), the filter tag,
the declared raw length, and the raw crc.  Any defect — truncation, bit
flip, trailing garbage — raises `CompressFormatError`; a consumer never
acts on bytes it could not fully validate.  The snapshot loader
surfaces it as InvalidSnapshot through its normal corruption path.
"""

from __future__ import annotations

import zlib
from typing import IO, Optional

import numpy as np

from ..errors import CstError

try:
    import lzma
except ImportError:  # pragma: no cover - stripped-down stdlib
    lzma = None

MAGIC = b"CSTPUZ1\n"
ALG_ZLIB = 1
ALG_LZMA = 2      # the bulk-container alg: ~20% smaller than zlib on
#                   transposed columnar streams at ~30MB/s (preset 1);
#                   decoders accept both, writers fall back to zlib on
#                   a stripped stdlib without the lzma module

FILT_NONE = 0
FILT_TRANSPOSE8 = 1

# hard ceilings: chunk geometry a decoder accepts before allocating.
# Writers never exceed _CHUNK_RAW; anything larger is corruption.
_CHUNK_RAW = 1 << 22
_HEAD = len(MAGIC) + 1
_DEFAULT_CHUNK = 1 << 18


class CompressFormatError(CstError):
    """Malformed/corrupt compressed container (any transport)."""


def _check_alg(alg: int) -> None:
    if alg == ALG_LZMA and lzma is None:  # pragma: no cover
        raise CompressFormatError("lzma container on an lzma-less build")
    if alg not in (ALG_ZLIB, ALG_LZMA):
        raise CompressFormatError(f"unknown compression alg {alg}")


def _alg_tag(alg: str) -> int:
    if alg == "lzma" and lzma is not None:
        return ALG_LZMA
    return ALG_ZLIB


def _deflate(raw: bytes, level: int, alg: int) -> bytes:
    if alg == ALG_LZMA:
        # preset 1: the speed/ratio knee for one-pass bulk streams
        # (higher presets pay seconds per 100MB for a few percent)
        return lzma.compress(raw, preset=min(max(level // 4, 1), 6))
    return zlib.compress(raw, level)


def _transpose8(raw: bytes) -> bytes:
    """Stride-8 byte transposition (self-inverse up to reshape order):
    byte i of little-endian word j moves to lane i — i64 planes become
    8 contiguous lanes of their per-byte streams."""
    a = np.frombuffer(raw, dtype=np.uint8)
    n8 = len(a) - (len(a) % 8)
    return a[:n8].reshape(-1, 8).T.tobytes() + raw[n8:]


def _untranspose8(data: bytes) -> bytes:
    a = np.frombuffer(data, dtype=np.uint8)
    n8 = len(a) - (len(a) % 8)
    return a[:n8].reshape(8, -1).T.tobytes() + data[n8:]


def _filter_chunk(raw: bytes, level: int, filt: str, alg: int):
    """-> (filt_tag, compressed) for one raw chunk.  "auto" picks the
    smaller rendering — the bulk paths' choice, where bytes-on-wire
    beat encode CPU; "none"/"transpose" pin the filter (payloads that
    already delta-encode their uuid columns pin "none": the trial rarely
    pays there).  Under lzma the "auto"
    trial uses a cheap zlib-1 proxy so the expensive compressor runs
    once per chunk, on the chosen rendering."""
    if filt == "none":
        return FILT_NONE, _deflate(raw, level, alg)
    t8 = _transpose8(raw)
    if filt == "transpose":
        return FILT_TRANSPOSE8, _deflate(t8, level, alg)
    if alg == ALG_LZMA:
        if len(zlib.compress(t8, 1)) >= len(zlib.compress(raw, 1)):
            return FILT_NONE, _deflate(raw, level, alg)
        return FILT_TRANSPOSE8, _deflate(t8, level, alg)
    # zlib auto: the probe outputs ARE the final renderings — return
    # the winner instead of recompressing it identically
    zt = zlib.compress(t8, level)
    zr = zlib.compress(raw, level)
    if len(zt) < len(zr):
        return FILT_TRANSPOSE8, zt
    return FILT_NONE, zr


def _unfilter(data: bytes, filt: int) -> bytes:
    if filt == FILT_NONE:
        return data
    if filt == FILT_TRANSPOSE8:
        return _untranspose8(data)
    raise CompressFormatError(f"unknown chunk filter {filt}")


# ------------------------------------------------------------- one-shot

def compress_bytes(data: bytes, level: int = 1,
                   chunk: int = _DEFAULT_CHUNK,
                   filt: str = "none", alg: str = "zlib") -> bytes:
    """Frame `data` as one container."""
    alg_tag = _alg_tag(alg)
    out = bytearray(MAGIC)
    out.append(alg_tag)
    mv = memoryview(data)
    for lo in range(0, len(mv), chunk):
        raw = bytes(mv[lo:lo + chunk])
        tag, comp = _filter_chunk(raw, level, filt, alg_tag)
        out += len(comp).to_bytes(4, "little")
        out.append(tag)
        out += len(raw).to_bytes(4, "little")
        out += zlib.crc32(raw).to_bytes(4, "little")
        out += comp
    out += (0).to_bytes(4, "little")
    return bytes(out)


def decompress_bytes(data: bytes, max_raw: int = 1 << 31) -> bytes:
    """Validate + inflate one container.  Raises CompressFormatError on
    ANY defect — the caller either gets the exact original bytes or an
    error, never a prefix.  One validation implementation for both
    transports: this is DecompressReader over a memory file plus the
    whole-buffer trailing-bytes check streams cannot make."""
    import io
    f = io.BytesIO(data)
    out = DecompressReader(f, max_raw=max_raw).read()
    if f.read(1):
        raise CompressFormatError("trailing bytes after container end")
    return out


def _inflate(comp: bytes, raw_len: int, alg: int = ALG_ZLIB) -> bytes:
    if alg == ALG_LZMA:
        try:
            d = lzma.LZMADecompressor()
            raw = d.decompress(comp, max_length=raw_len)
            if not d.eof or d.unused_data or len(raw) != raw_len:
                raise CompressFormatError("chunk lzma stream "
                                          "truncated/oversized")
            return raw
        except lzma.LZMAError as e:
            raise CompressFormatError(
                f"chunk inflate failed: {e}") from None
    try:
        d = zlib.decompressobj()
        raw = d.decompress(comp, raw_len)
        if d.unconsumed_tail or d.decompress(b"", 1):
            raise CompressFormatError("chunk inflates past its declared "
                                      "length")
        if not d.eof:
            raise CompressFormatError("chunk zlib stream truncated")
        if len(raw) != raw_len:
            raise CompressFormatError("chunk raw length mismatch")
        return raw
    except zlib.error as e:
        raise CompressFormatError(f"chunk inflate failed: {e}") from None


def is_compressed(head: bytes) -> bool:
    """Does `head` (>= 8 bytes) open a compressed container?"""
    return head[:len(MAGIC)] == MAGIC


# ------------------------------------------------------------- streaming

class CompressWriter:
    """File-object wrapper framing everything written through it.
    `write()` buffers to the chunk size, `finish()` flushes the tail and
    the end marker.  Presents only the `write` surface SnapshotWriter
    needs, so the snapshot container is this writer wrapped around the
    real file.  `filt="auto"` (the bulk default) picks the per-chunk
    filter by trial.  The working buffer is bounded by the chunk size."""

    def __init__(self, f: IO[bytes], level: int = 1,
                 chunk: int = _DEFAULT_CHUNK, filt: str = "auto",
                 alg: str = "lzma"):
        self._f = f
        self._level = level
        self._chunk = chunk
        self._filt = filt
        self._alg = _alg_tag(alg)
        self._buf = bytearray()
        self.raw_bytes = 0
        f.write(MAGIC + bytes([self._alg]))

    def write(self, data: bytes) -> None:
        self._buf += data
        self.raw_bytes += len(data)
        while len(self._buf) >= self._chunk:
            self._emit(bytes(self._buf[:self._chunk]))
            del self._buf[:self._chunk]

    def _emit(self, raw: bytes) -> None:
        tag, comp = _filter_chunk(raw, self._level, self._filt,
                                  self._alg)
        head = len(comp).to_bytes(4, "little") + bytes([tag]) \
            + len(raw).to_bytes(4, "little") \
            + zlib.crc32(raw).to_bytes(4, "little")
        self._f.write(head + comp)

    def finish(self) -> None:
        if self._buf:
            self._emit(bytes(self._buf))
            self._buf.clear()
        self._f.write((0).to_bytes(4, "little"))


class DecompressReader:
    """File-object wrapper inflating a container incrementally with the
    same per-chunk validation as `decompress_bytes`.  `read(n)` returns
    exactly `n` bytes until the validated stream is exhausted — the
    surface SnapshotLoader consumes.  `head`: bytes the caller already
    consumed while sniffing the magic.  `max_raw` caps the cumulative
    inflated size (a corrupt length field must not OOM the consumer
    before validation catches up)."""

    def __init__(self, f: IO[bytes], head: bytes = b"",
                 max_raw: int = 1 << 62):
        self._f = f
        self._buf = bytearray()
        self._raw_total = 0
        self._max_raw = max_raw
        self._done = False
        need = _HEAD - len(head)
        head = head + (f.read(need) if need > 0 else b"")
        if len(head) < _HEAD or head[:len(MAGIC)] != MAGIC:
            raise CompressFormatError("bad compressed-container magic")
        self._alg = head[len(MAGIC)]
        _check_alg(self._alg)

    def _take(self, n: int) -> bytes:
        data = self._f.read(n)
        if len(data) != n:
            raise CompressFormatError("truncated compressed container")
        return data

    def _pump(self) -> bool:
        if self._done:
            return False
        comp_len = int.from_bytes(self._take(4), "little")
        if comp_len == 0:
            self._done = True
            return False
        filt = self._take(1)[0]
        raw_len = int.from_bytes(self._take(4), "little")
        crc = int.from_bytes(self._take(4), "little")
        if raw_len > _CHUNK_RAW or comp_len > _CHUNK_RAW + 1024:
            raise CompressFormatError("chunk lengths out of range")
        self._raw_total += raw_len
        if self._raw_total > self._max_raw:
            raise CompressFormatError("container exceeds the raw size cap")
        raw = _unfilter(_inflate(self._take(comp_len), raw_len,
                                 self._alg), filt)
        if zlib.crc32(raw) != crc:
            raise CompressFormatError("chunk crc mismatch")
        self._buf += raw
        return True

    def read(self, n: Optional[int] = None) -> bytes:
        if n is None:
            while self._pump():
                pass
            out = bytes(self._buf)
            self._buf.clear()
            return out
        while len(self._buf) < n and self._pump():
            pass
        out = bytes(self._buf[:n])
        del self._buf[:n]
        return out
