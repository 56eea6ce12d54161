"""Staging index tables, pure-Python tier.

The port's own copy of the pure-Python tier of the reference package's
utils/native_tables.py: `_PyStrTable`, `_PyI64Dict` and `nonnull_mask`,
behind the same `StrTable` / `I64Dict` factories, so `KeySpace` and the
engines call the identical API.  The C++ tiers (native/tables.cpp and its
CPython extension) are not part of the port yet; they come in a later
slice.

API shape is numpy-first: batch methods take/return int64 arrays.
"""

from __future__ import annotations

import numpy as np

_I64 = np.int64


def nonnull_mask(items: list) -> np.ndarray:
    """Bool ndarray marking entries that are not None."""
    return np.fromiter((v is not None for v in items), dtype=bool,
                       count=len(items))


class _PyStrTable:
    """bytes -> dense id, insertion-ordered."""

    __slots__ = ("_d", "_items")

    def __init__(self, cap_hint: int = 16):
        self._d: dict[bytes, int] = {}
        self._items: list[bytes] = []

    def __len__(self) -> int:
        return len(self._d)

    def get_or_insert(self, b: bytes) -> int:
        i = self._d.get(b, -1)
        if i < 0:
            i = len(self._items)
            self._d[b] = i
            self._items.append(b)
        return i

    def lookup(self, b: bytes) -> int:
        return self._d.get(b, -1)

    def get_or_insert_batch(self, items: list) -> tuple[np.ndarray, int]:
        """-> (ids[n], n_new).  New ids are sequential from the previous
        table size, in first-occurrence order."""
        before = len(self._items)
        gi = self.get_or_insert
        out = np.fromiter((gi(b) for b in items), dtype=_I64, count=len(items))
        return out, len(self._items) - before

    def lookup_batch(self, items: list) -> np.ndarray:
        g = self._d.get
        return np.fromiter((g(b, -1) for b in items), dtype=_I64,
                           count=len(items))

    def bytes_of(self, idx: int) -> bytes:
        return self._items[idx]


class _PyI64Dict:
    """int64 -> int64 with batch ops and deletion."""

    __slots__ = ("_d",)

    def __init__(self, cap_hint: int = 16):
        self._d: dict[int, int] = {}

    def __len__(self) -> int:
        return len(self._d)

    def get(self, k: int, dflt: int = -1) -> int:
        return self._d.get(k, dflt)

    def put(self, k: int, v: int) -> None:
        self._d[k] = v

    def delete(self, k: int, dflt: int = -1) -> int:
        return self._d.pop(k, dflt)

    def lookup_batch(self, keys: np.ndarray, dflt: int = -1) -> np.ndarray:
        g = self._d.get
        return np.fromiter((g(k, dflt) for k in keys.tolist()), dtype=_I64,
                           count=len(keys))

    def put_batch(self, keys: np.ndarray, vals: np.ndarray) -> None:
        self._d.update(zip(keys.tolist(), vals.tolist()))

    def get_or_assign_batch(self, keys: np.ndarray, next_val: int
                            ) -> tuple[np.ndarray, int]:
        """Missing keys get sequential values from next_val (first-occurrence
        order).  -> (vals[n], n_new)."""
        d = self._d
        out = np.empty(len(keys), dtype=_I64)
        start = next_val
        for i, k in enumerate(keys.tolist()):
            v = d.get(k)
            if v is None:
                v = next_val
                d[k] = v
                next_val += 1
            out[i] = v
        return out, next_val - start


def StrTable(cap_hint: int = 16) -> _PyStrTable:
    return _PyStrTable(cap_hint)


def I64Dict(cap_hint: int = 16) -> _PyI64Dict:
    return _PyI64Dict(cap_hint)
