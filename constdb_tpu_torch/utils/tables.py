"""Staging index tables: the native C++ tier and the pure-Python tier.

The merge hot path resolves millions of (bytes -> id) and (int64 -> int64)
probes per batch.  The port's own C++ tables (native/tables.cpp) do them
through its CPython extension (native/pyext.cpp), with batch entry points
so Python crosses into C once per column, not once per row; the
extension walks a list of bytes directly.  Both are built with g++ at
first use (utils/native.py).

`StrTable`, `I64Dict` and `nonnull_mask` always take the native tier.  A
failed build or load raises: nothing falls back.  The pure tier
(`_PyStrTable`, `_PyI64Dict`, `_nonnull_mask_py`) is the tests' oracle,
called by name.  The reference's middle tier, its ctypes binding of the
same tables, is not ported.

API shape is numpy-first: batch methods take/return int64 arrays.
"""

from __future__ import annotations

import numpy as np

_I64 = np.int64


def _ext():
    from .native import load
    return load().ext


def _nonnull_mask_py(items) -> np.ndarray:
    return np.fromiter((v is not None for v in items), dtype=bool,
                       count=len(items))


def nonnull_mask(items: list) -> np.ndarray:
    """Writable bool ndarray marking entries that are not None.  Only an
    exact list takes the extension (its PyList_CheckExact); any other
    sized iterable takes the generator."""
    if type(items) is list:
        return np.frombuffer(_ext().nonnull_mask(items), dtype=bool)
    return _nonnull_mask_py(items)


def tier(table) -> str:
    """"native" or "pure": which tier a table object belongs to."""
    return "native" if isinstance(table, (_ExtStrTable, _ExtI64Dict)) \
        else "pure"


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


class _ExtStrTable:
    """bytes -> dense id through the C extension (no blob packing)."""

    __slots__ = ("_h", "_m")

    def __init__(self, cap_hint: int = 16):
        self._m = _ext()
        self._h = self._m.strtab_new(cap_hint)

    def __len__(self) -> int:
        return self._m.strtab_len(self._h)

    def get_or_insert(self, b: bytes) -> int:
        return self._m.strtab_get_or_insert(self._h, b)

    def lookup(self, b: bytes) -> int:
        return self._m.strtab_lookup(self._h, b)

    def get_or_insert_batch(self, items: list) -> tuple[np.ndarray, int]:
        out = np.empty(len(items), dtype=_I64)
        n_new = self._m.strtab_get_or_insert_batch(self._h, items, out)
        return out, n_new

    def lookup_batch(self, items: list) -> np.ndarray:
        out = np.empty(len(items), dtype=_I64)
        self._m.strtab_lookup_batch(self._h, items, out)
        return out

    def bytes_of(self, idx: int) -> bytes:
        return self._m.strtab_bytes_of(self._h, idx)


class _ExtI64Dict:
    """int64 -> int64 through the C extension."""

    __slots__ = ("_h", "_m")

    def __init__(self, cap_hint: int = 16):
        self._m = _ext()
        self._h = self._m.i64_new(cap_hint)

    def __len__(self) -> int:
        return self._m.i64_len(self._h)

    def get(self, k: int, dflt: int = -1) -> int:
        return self._m.i64_get(self._h, k, dflt)

    def put(self, k: int, v: int) -> None:
        self._m.i64_put(self._h, k, v)

    def delete(self, k: int, dflt: int = -1) -> int:
        return self._m.i64_del(self._h, k, dflt)

    def lookup_batch(self, keys: np.ndarray, dflt: int = -1) -> np.ndarray:
        keys = np.ascontiguousarray(keys, dtype=_I64)
        out = np.empty(len(keys), dtype=_I64)
        self._m.i64_lookup_batch(self._h, keys, dflt, out)
        return out

    def put_batch(self, keys: np.ndarray, vals: np.ndarray) -> None:
        keys = np.ascontiguousarray(keys, dtype=_I64)
        vals = np.ascontiguousarray(vals, dtype=_I64)
        self._m.i64_put_batch(self._h, keys, vals)

    def get_or_assign_batch(self, keys: np.ndarray, next_val: int
                            ) -> tuple[np.ndarray, int]:
        keys = np.ascontiguousarray(keys, dtype=_I64)
        out = np.empty(len(keys), dtype=_I64)
        n_new = self._m.i64_get_or_assign_batch(self._h, keys, next_val, out)
        return out, n_new


StrTable = _ExtStrTable
I64Dict = _ExtI64Dict
