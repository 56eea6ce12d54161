"""Byte-string helpers.

Capability parity with reference src/lib/utils.rs:3-61 (`bytes2i64`/`bytes2u64`)
and src/resp.rs:12-27 (interned int→bytes cache).
"""

from __future__ import annotations

from typing import Optional

# Interned encodings for small integers: the hot path for RESP integer replies.
_INT_CACHE_LO, _INT_CACHE_HI = -1, 10000
_INT_CACHE = [str(i).encode() for i in range(_INT_CACHE_LO, _INT_CACHE_HI)]


def i64_to_bytes(n: int) -> bytes:
    if _INT_CACHE_LO <= n < _INT_CACHE_HI:
        return _INT_CACHE[n - _INT_CACHE_LO]
    return str(n).encode()


def bytes2i64(b: bytes) -> Optional[int]:
    """ASCII → signed 64-bit int; None when not a canonical integer."""
    if not b:
        return None
    try:
        v = int(b)
    except ValueError:
        return None
    # Reject non-canonical forms ("+1", " 1", "01") like a strict ASCII parser.
    if str(v).encode() != b:
        return None
    if not (-(1 << 63) <= v < (1 << 63)):
        return None
    return v


def bytes2u64(b: bytes) -> Optional[int]:
    if not b:
        return None
    try:
        v = int(b)
    except ValueError:
        return None
    if str(v).encode() != b or not (0 <= v < (1 << 64)):
        return None
    return v
