"""MergeEngine boundary: bulk CRDT merges over columnar batches.

This is the seam the north-star targets (BASELINE.json): snapshot ingest and
replica catch-up produce `ColumnarBatch`es (foreign CRDT state as
struct-of-arrays), and an engine merges them into the local `KeySpace`.
The CPU engine is the semantics reference; the torch engine (engine/cuda.py)
runs the same rules as batched scatter reductions on device.

The per-key loops this replaces in the reference:
`DB::merge_entry` → `Object::merge` → `Counter::merge` / `Set::merge` /
`Dict::merge` (reference src/db.rs:31-43, src/object.rs:63-83,
src/type_counter.rs:59-91, src/crdt/lwwhash.rs:176-181, 319-323).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional, Protocol

import numpy as np

from ..store.keyspace import KeySpace

_I64 = np.int64


@dataclass
class ColumnarBatch:
    """Foreign CRDT state in columnar form.

    Key-aligned arrays are indexed by *batch key position* (bki); counter and
    element rows point into the key arrays via `cnt_ki` / `el_ki`.
    """

    # keys
    keys: list = field(default_factory=list)           # bytes per batch key
    key_enc: np.ndarray = field(default_factory=lambda: np.zeros(0, np.int8))
    key_ct: np.ndarray = field(default_factory=lambda: np.zeros(0, _I64))
    key_mt: np.ndarray = field(default_factory=lambda: np.zeros(0, _I64))
    key_dt: np.ndarray = field(default_factory=lambda: np.zeros(0, _I64))
    key_expire: np.ndarray = field(default_factory=lambda: np.zeros(0, _I64))
    # registers (aligned with keys; unused slots hold None/0)
    reg_val: list = field(default_factory=list)
    reg_t: np.ndarray = field(default_factory=lambda: np.zeros(0, _I64))
    reg_node: np.ndarray = field(default_factory=lambda: np.zeros(0, _I64))
    # counter slots: (lifetime total @ uuid) + (delete-observed base @ base_t)
    cnt_ki: np.ndarray = field(default_factory=lambda: np.zeros(0, _I64))
    cnt_node: np.ndarray = field(default_factory=lambda: np.zeros(0, _I64))
    cnt_val: np.ndarray = field(default_factory=lambda: np.zeros(0, _I64))
    cnt_uuid: np.ndarray = field(default_factory=lambda: np.zeros(0, _I64))
    cnt_base: np.ndarray = field(default_factory=lambda: np.zeros(0, _I64))
    cnt_base_t: np.ndarray = field(default_factory=lambda: np.zeros(0, _I64))
    # elements (set members / dict fields)
    el_ki: np.ndarray = field(default_factory=lambda: np.zeros(0, _I64))
    el_member: list = field(default_factory=list)
    el_val: list = field(default_factory=list)
    el_add_t: np.ndarray = field(default_factory=lambda: np.zeros(0, _I64))
    el_add_node: np.ndarray = field(default_factory=lambda: np.zeros(0, _I64))
    el_del_t: np.ndarray = field(default_factory=lambda: np.zeros(0, _I64))
    # tensor contributor slots (crdt/tensor.py two-layer registers):
    # one row per (key, writer node) contribution — LWW stamp + count
    # columns, the packed per-key config riding every row (rows of one
    # key carry identical configs; the first merge fixes it), and the
    # payload as a flat array of the key's dtype (or raw LE bytes on
    # the wire — engines normalize via tensor.payload_array)
    tns_ki: np.ndarray = field(default_factory=lambda: np.zeros(0, _I64))
    tns_node: np.ndarray = field(default_factory=lambda: np.zeros(0, _I64))
    tns_uuid: np.ndarray = field(default_factory=lambda: np.zeros(0, _I64))
    tns_cnt: np.ndarray = field(default_factory=lambda: np.zeros(0, _I64))
    tns_cfg: list = field(default_factory=list)
    tns_payload: list = field(default_factory=list)
    # standalone key-level tombstones (snapshot DELETES section)
    del_keys: list = field(default_factory=list)
    del_t: np.ndarray = field(default_factory=lambda: np.zeros(0, _I64))
    # contract: at most one counter row per (key, node) and one element row
    # per (key, member).  True for snapshot dumps (batch_from_keyspace, the
    # snapshot loader); batches built from raw op streams must leave this
    # False so the engine's dense path (last-write-per-slot placement) is
    # skipped in favor of the duplicate-safe scatter reduction.
    rows_unique_per_slot: bool = False
    # identity tokens (not serialized): chunks sliced from batches that
    # SHARE their key/element plane objects — replica snapshots of one
    # keyspace — carry equal tokens, letting the engine resolve each
    # distinct shape once instead of once per replica (batch_chunks sets
    # them; engine/cuda.py merge_many / _merge_elem_rows memoize on them).
    # Equal tokens guarantee equal content: they embed the ids of the
    # parent objects plus the slice bounds, and `shape_refs` pins those
    # parents alive so the ids cannot be recycled while a chunk exists.
    key_shape: object = None
    el_shape: object = None
    shape_refs: object = field(default=None, repr=False)
    # hint: False = PROVABLY no element values (chunks inherit their
    # parent's one-time scan — any subset of an all-None list is all
    # None).  True/None = values may exist; consumers re-scan their own
    # (smaller) list with has_values().
    el_has_vals: object = None

    @property
    def n_keys(self) -> int:
        return len(self.keys)

    @property
    def n_rows(self) -> int:
        return (len(self.keys) + len(self.cnt_ki) + len(self.el_ki)
                + len(self.tns_ki))


def concat_batches(batches: list) -> ColumnarBatch:
    """Concatenate op-stream batches plane-wise into ONE wide batch
    (row-plane `*_ki` indices shifted past the earlier batches' keys).

    Sound for duplicate-safe consumers only: the result repeats key
    slots and row slots across the inputs, so it must land through the
    scatter-reduction paths (`rows_unique_per_slot` stays False —
    resolve_keys interns repeats, the fold_* reductions pick the same
    associative winners folding once as merging the inputs in order).
    This is what makes a replay MERGE ROUND genuinely wide: one key
    resolution and one vectorized pass per plane per round, instead of
    one per few-hundred-row record (persist/oplog.py _merge_round).

    Row order within each plane preserves input order, so the per-row
    planes (tensors) replay exactly as the sequential merges would."""
    if len(batches) == 1:
        return batches[0]
    out = ColumnarBatch()
    offs = np.cumsum([0] + [b.n_keys for b in batches[:-1]])

    def cat(name):
        return np.concatenate([getattr(b, name) for b in batches])

    def cat_ki(name):
        return np.concatenate([getattr(b, name) + off
                               for b, off in zip(batches, offs)])

    def cat_list(name):
        o = []
        for b in batches:
            o.extend(getattr(b, name))
        return o

    out.keys = cat_list("keys")
    out.key_enc = cat("key_enc")
    out.key_ct = cat("key_ct")
    out.key_mt = cat("key_mt")
    out.key_dt = cat("key_dt")
    out.key_expire = cat("key_expire")
    out.reg_val = cat_list("reg_val")
    out.reg_t = cat("reg_t")
    out.reg_node = cat("reg_node")
    out.cnt_ki = cat_ki("cnt_ki")
    out.cnt_node = cat("cnt_node")
    out.cnt_val = cat("cnt_val")
    out.cnt_uuid = cat("cnt_uuid")
    out.cnt_base = cat("cnt_base")
    out.cnt_base_t = cat("cnt_base_t")
    out.el_ki = cat_ki("el_ki")
    out.el_member = cat_list("el_member")
    out.el_val = cat_list("el_val")
    out.el_add_t = cat("el_add_t")
    out.el_add_node = cat("el_add_node")
    out.el_del_t = cat("el_del_t")
    out.tns_ki = cat_ki("tns_ki")
    out.tns_node = cat("tns_node")
    out.tns_uuid = cat("tns_uuid")
    out.tns_cnt = cat("tns_cnt")
    out.tns_cfg = cat_list("tns_cfg")
    out.tns_payload = cat_list("tns_payload")
    out.del_keys = cat_list("del_keys")
    out.del_t = cat("del_t")
    if all(b.el_has_vals is False for b in batches):
        out.el_has_vals = False
    return out


def has_values(vals: list) -> bool:
    """Single home for the has-element-values predicate (list.count scans
    at C speed; empty bytes count as values, only None is absent — the
    same distinction _pool_add's byte accounting makes)."""
    return len(vals) != vals.count(None)


@dataclass
class MergeStats:
    keys_seen: int = 0
    keys_created: int = 0
    type_conflicts: int = 0
    counter_rows: int = 0
    elem_rows: int = 0
    tensor_rows: int = 0
    # device-transfer accounting for THIS call (engine/cuda.py fills them
    # from its cumulative counters; host-only engines leave zeros).
    # dev_rounds_resident counts micro rounds merged in place against
    # resident device planes — the steady-state residency signal the
    # bench legs read.
    dev_upload_bytes: int = 0
    dev_download_bytes: int = 0
    dev_rounds_resident: int = 0
    # rows a flush actually downloaded during this call (auto-flushes);
    # the engine's cumulative attribute of the same name covers explicit
    # flush() calls too
    flush_rows_downloaded: int = 0

    def __iadd__(self, other: "MergeStats") -> "MergeStats":
        self.keys_seen += other.keys_seen
        self.keys_created += other.keys_created
        self.type_conflicts += other.type_conflicts
        self.counter_rows += other.counter_rows
        self.elem_rows += other.elem_rows
        self.tensor_rows += other.tensor_rows
        self.dev_upload_bytes += other.dev_upload_bytes
        self.dev_download_bytes += other.dev_download_bytes
        self.dev_rounds_resident += other.dev_rounds_resident
        self.flush_rows_downloaded += other.flush_rows_downloaded
        return self


class MergeEngine(Protocol):
    """The streaming merge surface callers (bench, replica link) rely on.

    `merge_many` folds a GROUP of batches in one pass per CRDT family —
    the pipelined engine overlaps host staging with device compute inside
    it.  Engines holding deferred device state set `needs_flush` and write
    it back on `flush` (host-only engines keep both trivial), so a caller
    can drive any engine with the same
    merge_many → … → flush cadence instead of hasattr probing."""

    name: str
    needs_flush: bool

    def merge(self, store: KeySpace, batch: ColumnarBatch) -> MergeStats: ...

    def merge_many(self, store: KeySpace,
                   batches: list) -> MergeStats: ...

    def flush(self, store: KeySpace) -> None: ...


def batch_from_keyspace(ks: KeySpace, include_deletes: bool = True,
                        key_sel: Optional[np.ndarray] = None) -> ColumnarBatch:
    """Dump a keyspace's full logical state as a batch (snapshot body /
    merge-test vehicle).  GC-freed element rows are excluded.

    `key_sel`: restrict the dump to these key rows (int64 kid array) —
    the range-scoped delta export the digest anti-entropy streams for
    divergent buckets (store/digest.py export_bucket_batch).  Counter
    and element rows of unselected keys are dropped and the survivors
    re-pointed at batch-local key positions.  `key_deletes` are NOT
    key-rows and ride unfiltered when `include_deletes` (scoped callers
    filter them by bucket themselves)."""
    b = ColumnarBatch()
    b.rows_unique_per_slot = True  # a state dump has one row per slot
    n = ks.keys.n
    if key_sel is None:
        b.keys = list(ks.key_bytes)
        b.key_enc = ks.keys.enc.copy()
        b.key_ct = ks.keys.ct.copy()
        b.key_mt = ks.keys.mt.copy()
        b.key_dt = ks.keys.dt.copy()
        b.key_expire = ks.keys.expire.copy()
        b.reg_val = list(ks.reg_val)
        b.reg_t = ks.keys.rv_t.copy()
        b.reg_node = ks.keys.rv_node.copy()

        b.cnt_ki = ks.cnt.kid.copy()
        b.cnt_node = ks.cnt.node.copy()
        b.cnt_val = ks.cnt.val.copy()
        b.cnt_uuid = ks.cnt.uuid.copy()
        b.cnt_base = ks.cnt.base.copy()
        b.cnt_base_t = ks.cnt.base_t.copy()

        live = ks.el.kid >= 0
        b.el_ki = ks.el.kid[live].copy()
        b.el_add_t = ks.el.add_t[live].copy()
        b.el_add_node = ks.el.add_node[live].copy()
        b.el_del_t = ks.el.del_t[live].copy()
        rows = np.nonzero(live)[0]
        b.el_member = [ks.el_member[r] for r in rows]
        b.el_val = [ks.el_val[r] for r in rows]
        _tns_dump(ks, b)
        assert n == len(b.keys)
    else:
        sel = np.asarray(key_sel, dtype=_I64)
        idx = sel.tolist()
        b.keys = [ks.key_bytes[i] for i in idx]
        b.key_enc = np.ascontiguousarray(ks.keys.enc[sel])
        b.key_ct = np.ascontiguousarray(ks.keys.ct[sel])
        b.key_mt = np.ascontiguousarray(ks.keys.mt[sel])
        b.key_dt = np.ascontiguousarray(ks.keys.dt[sel])
        b.key_expire = np.ascontiguousarray(ks.keys.expire[sel])
        b.reg_val = [ks.reg_val[i] for i in idx]
        b.reg_t = np.ascontiguousarray(ks.keys.rv_t[sel])
        b.reg_node = np.ascontiguousarray(ks.keys.rv_node[sel])

        posmap = np.full(n, -1, dtype=_I64)
        posmap[sel] = np.arange(len(sel), dtype=_I64)
        if ks.cnt.n:
            cm = np.nonzero(posmap[ks.cnt.kid] >= 0)[0]
            b.cnt_ki = posmap[ks.cnt.kid[cm]]
            b.cnt_node = np.ascontiguousarray(ks.cnt.node[cm])
            b.cnt_val = np.ascontiguousarray(ks.cnt.val[cm])
            b.cnt_uuid = np.ascontiguousarray(ks.cnt.uuid[cm])
            b.cnt_base = np.ascontiguousarray(ks.cnt.base[cm])
            b.cnt_base_t = np.ascontiguousarray(ks.cnt.base_t[cm])
        if ks.el.n:
            ekid = ks.el.kid
            em = np.nonzero((ekid >= 0) & (posmap[ekid] >= 0))[0]
            b.el_ki = posmap[ekid[em]]
            b.el_add_t = np.ascontiguousarray(ks.el.add_t[em])
            b.el_add_node = np.ascontiguousarray(ks.el.add_node[em])
            b.el_del_t = np.ascontiguousarray(ks.el.del_t[em])
            rows = em.tolist()
            b.el_member = [ks.el_member[r] for r in rows]
            b.el_val = [ks.el_val[r] for r in rows]
        if ks.tns.n:
            _tns_dump(ks, b, posmap=posmap)

    if include_deletes and ks.key_deletes:
        b.del_keys = list(ks.key_deletes.keys())
        b.del_t = np.fromiter(ks.key_deletes.values(), dtype=_I64, count=len(ks.key_deletes))
    return b


def _tns_dump(ks: KeySpace, b: ColumnarBatch,
              posmap: Optional[np.ndarray] = None) -> None:
    """Dump the tensor plane into a batch: real contributions only
    (neutral-stamped slots never ship — a fresh store materializes them
    on merge), each row carrying its key's packed config (computed once
    per key).  `posmap`: kid -> batch position for key_sel dumps."""
    from ..crdt import tensor as T
    from ..crdt.semantics import NEUTRAL_T

    n = ks.tns.n
    if not n:
        return
    sel = ks.tns.uuid[:n] != NEUTRAL_T
    if posmap is not None:
        sel &= posmap[ks.tns.kid[:n]] >= 0
    rows = np.nonzero(sel)[0]
    if not len(rows):
        return
    kids = ks.tns.kid[rows]
    b.tns_ki = kids.copy() if posmap is None else posmap[kids]
    b.tns_node = ks.tns.node[rows].copy()
    b.tns_uuid = ks.tns.uuid[rows].copy()
    b.tns_cnt = ks.tns.cnt[rows].copy()
    cfg_of: dict = {}
    cfgs = []
    for kid in kids.tolist():
        c = cfg_of.get(kid)
        if c is None:
            c = cfg_of[kid] = T.pack_config(ks.tns_meta[kid])
        cfgs.append(c)
    b.tns_cfg = cfgs
    b.tns_payload = [ks.tns_payload[r] for r in rows.tolist()]
