"""Growable struct-of-arrays column group.

The keyspace's numeric plane lives in these instead of per-key heap objects:
columns are contiguous numpy arrays, so bulk merge stages to the device with
zero per-row Python work and merged columns write back with fancy indexing.
"""

from __future__ import annotations

import numpy as np


class Columns:
    """A set of equally-sized growable numpy columns (amortized doubling)."""

    def __init__(self, spec: dict[str, np.dtype], cap: int = 1024):
        self._spec = {k: np.dtype(v) for k, v in spec.items()}
        self._cap = max(cap, 16)
        self.n = 0
        for name, dt in self._spec.items():
            setattr(self, "_" + name, np.zeros(self._cap, dtype=dt))

    def _grow(self, need: int) -> None:
        cap = self._cap
        while cap < need:
            cap *= 2
        for name in self._spec:
            old = getattr(self, "_" + name)
            new = np.zeros(cap, dtype=old.dtype)
            new[: self.n] = old[: self.n]
            setattr(self, "_" + name, new)
        self._cap = cap
        self._drop_views()

    def _drop_views(self) -> None:
        for name in self._spec:
            self.__dict__.pop(name, None)

    def append(self, **vals) -> int:
        row = self.n
        if row >= self._cap:
            self._grow(row + 1)
        self.n = row + 1
        self._drop_views()  # length-n views are stale
        for name, v in vals.items():
            getattr(self, "_" + name)[row] = v
        return row

    def append_block(self, n: int, **arrays) -> np.ndarray:
        """Append n rows from aligned arrays; returns the new row indices."""
        start = self.n
        if start + n > self._cap:
            self._grow(start + n)
        self.n = start + n
        self._drop_views()
        for name, arr in arrays.items():
            getattr(self, "_" + name)[start:start + n] = arr
        return np.arange(start, start + n, dtype=np.int64)

    def col(self, name: str) -> np.ndarray:
        """Live view of a column (length n)."""
        return getattr(self, name)

    def __getattr__(self, name: str):
        # cols.ct -> live [0, n) view, CACHED as a real instance attribute so
        # repeat access costs a dict hit, not a slice build (the op path
        # touches columns ~10x per command).  append/_grow drop the caches.
        spec = object.__getattribute__(self, "_spec")
        if name in spec:
            view = object.__getattribute__(self, "_" + name)[
                : object.__getattribute__(self, "n")]
            object.__setattr__(self, name, view)
            return view
        raise AttributeError(name)

    def __len__(self) -> int:
        return self.n

    def nbytes(self) -> int:
        """Allocated bytes of every column (capacity, not just rows) —
        allocator-true accounting for INFO (reference src/lib.rs:63-78
        exposes jemalloc's allocated gauge; this is the store-exact part)."""
        return sum(getattr(self, "_" + name).nbytes for name in self._spec)

    def live_bytes(self) -> int:
        """LIVE row bytes (n rows x per-row width), independent of the
        pow2 capacity — the overload governor's accounting unit
        (server/overload.py): a hash-partitioned store's shards sum to
        exactly the single-store figure, which capacity-based accounting
        cannot (each shard rounds its capacity up separately)."""
        return self.n * sum(dt.itemsize for dt in self._spec.values())


class TensorCols(Columns):
    """Tensor contributor slots — the envelope half of the tensor plane
    (crdt/tensor.py): one row per (key, writer node), holding the LWW
    stamp (`uuid`), the avg-strategy contribution count (`cnt`), and the
    writer node id.  Payload arrays live in the keyspace's row-aligned
    `tns_payload` side list (and, under a resident engine, in the device
    payload pools of engine/cuda.py)."""

    def __init__(self) -> None:
        super().__init__({"kid": np.int64, "node": np.int64,
                          "uuid": np.int64, "cnt": np.int64}, cap=256)
