"""Streaming checksums for the snapshot format.

The port's own copy of the reference package's utils/checksum.py.  Two
interchangeable algorithms, tagged in the snapshot header so the loader
always verifies with the right one:
  * "crc64"     — CRC-64/XZ, computed by the port's native extension
                  (native/crc64.cpp through native/pyext.cpp, built at
                  first use by utils/native.py; a failed build raises);
  * "blake2b64" — 8-byte BLAKE2b via hashlib.

The port always has its native extension, so its default is CRC64 (the
reference writes BLAKE2b-64 when its own library is not built).  Files
of either package load in the other: the header names the algorithm.
`_crc64_py` is the table-driven Python CRC the tests hold the native one
against.
"""

from __future__ import annotations

import hashlib
from typing import Optional

_POLY = 0xC96C5795D7870F42  # CRC-64/XZ, reflected

_TABLE: Optional[list[int]] = None


def _table() -> list[int]:
    global _TABLE
    if _TABLE is None:
        t = []
        for i in range(256):
            crc = i
            for _ in range(8):
                crc = (crc >> 1) ^ _POLY if crc & 1 else crc >> 1
            t.append(crc)
        _TABLE = t
    return _TABLE


def _crc64_py(data: bytes, crc: int = 0) -> int:
    crc ^= 0xFFFFFFFFFFFFFFFF
    tab = _table()
    for b in data:
        crc = tab[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFFFFFFFFFF


def crc64(data, crc: int = 0) -> int:
    """CRC-64/XZ of `data` (any C-contiguous buffer), continuing from
    `crc` (streamable)."""
    from .native import load
    return load().ext.crc64(crc, data)


class StreamChecksum:
    """Running checksum with an algorithm tag byte for the snapshot header."""

    ALG_CRC64 = 1
    ALG_BLAKE2B64 = 2

    def __init__(self, alg: Optional[int] = None):
        if alg is None:
            alg = self.ALG_CRC64
        self.alg = alg
        if alg == self.ALG_CRC64:
            self._crc = 0
            self._h = None
        elif alg == self.ALG_BLAKE2B64:
            self._h = hashlib.blake2b(digest_size=8)
        else:
            raise ValueError(f"unknown checksum algorithm {alg}")

    def update(self, data) -> None:
        if self.alg == self.ALG_CRC64:
            self._crc = crc64(data, self._crc)
        else:
            self._h.update(data)

    def digest(self) -> int:
        if self.alg == self.ALG_CRC64:
            return self._crc
        return int.from_bytes(self._h.digest(), "big")
