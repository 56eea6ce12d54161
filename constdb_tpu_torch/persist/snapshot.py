"""Snapshot chunking for streamed catch-up.

Only `batch_chunks` of the reference package's persist/snapshot.py is
ported in this slice: the snapshot file format, writer and loader are
later work.
"""

from __future__ import annotations

from typing import Iterator

import numpy as np

from ..engine.base import ColumnarBatch, has_values

_I64 = np.int64


def batch_chunks(batch: ColumnarBatch,
                 chunk_keys: int) -> Iterator[ColumnarBatch]:
    """Split a batch into key-range chunks of at most `chunk_keys` keys.

    Chunk boundaries are positional, so chunks of same-shape batches from
    different replicas stay slot-ALIGNED (the engine's fused dense-fold
    path relies on this — engine/tpu.py merge_many).  Counter/element rows
    are routed to the chunk owning their key and re-indexed chunk-locally;
    key-level delete tombstones ride the first chunk (merge order is
    immaterial: every component merge is commutative).
    """
    n = batch.n_keys
    if chunk_keys <= 0:
        chunk_keys = max(n, 1)

    if n == 0:
        if batch.del_keys:
            c = ColumnarBatch()
            c.rows_unique_per_slot = batch.rows_unique_per_slot
            c.del_keys = list(batch.del_keys)
            c.del_t = np.asarray(batch.del_t, dtype=_I64)
            yield c
        return

    # each chunk is a searchsorted slice.  When a plane's key ids are
    # already non-decreasing (true for keyspace dumps built in kid order,
    # and the common case generally) the slice is CONTIGUOUS: columns
    # become zero-copy views and the bytes lists plain list slices —
    # otherwise one stable sort per plane fixes the order first.
    cnt_arr = np.asarray(batch.cnt_ki)
    cnt_presorted = bool(len(cnt_arr) == 0 or (np.diff(cnt_arr) >= 0).all())
    cnt_order = None if cnt_presorted else np.argsort(cnt_arr, kind="stable")
    cnt_sorted = cnt_arr if cnt_presorted else cnt_arr[cnt_order]
    el_arr = np.asarray(batch.el_ki)
    el_presorted = bool(len(el_arr) == 0 or (np.diff(el_arr) >= 0).all())
    el_order = None if el_presorted else np.argsort(el_arr, kind="stable")
    el_sorted = el_arr if el_presorted else el_arr[el_order]
    tns_arr = np.asarray(batch.tns_ki)
    tns_presorted = bool(len(tns_arr) == 0
                         or (np.diff(tns_arr) >= 0).all())
    tns_order = None if tns_presorted \
        else np.argsort(tns_arr, kind="stable")
    tns_sorted = tns_arr if tns_presorted else tns_arr[tns_order]
    # one values scan for the whole batch; chunks inherit the hint (the
    # engine otherwise rescans per chunk per replica)
    el_hv = batch.el_has_vals
    if el_hv is None:
        el_hv = has_values(batch.el_val)

    for lo in range(0, n, chunk_keys):
        hi = min(n, lo + chunk_keys)
        c = ColumnarBatch()
        c.rows_unique_per_slot = batch.rows_unique_per_slot
        # identity tokens: replica chunks sliced from SHARED plane objects
        # compare equal, so the engine resolves each shape once (the
        # parent objects stay alive through the chunk's plane views)
        c.key_shape = (id(batch.keys), id(batch.key_enc), lo, hi)
        c.el_shape = (id(batch.el_ki), id(batch.el_member), lo, hi)
        c.shape_refs = (batch.keys, batch.key_enc, batch.el_ki,
                        batch.el_member)
        c.el_has_vals = el_hv
        c.keys = batch.keys[lo:hi]
        c.key_enc = batch.key_enc[lo:hi]
        c.key_ct = batch.key_ct[lo:hi]
        c.key_mt = batch.key_mt[lo:hi]
        c.key_dt = batch.key_dt[lo:hi]
        c.key_expire = batch.key_expire[lo:hi]
        c.reg_val = batch.reg_val[lo:hi]
        c.reg_t = batch.reg_t[lo:hi]
        c.reg_node = batch.reg_node[lo:hi]

        a, z = (int(x) for x in np.searchsorted(cnt_sorted, (lo, hi)))
        rows = slice(a, z) if cnt_presorted else cnt_order[a:z]
        c.cnt_ki = cnt_arr[rows] - lo
        c.cnt_node = np.asarray(batch.cnt_node)[rows]
        c.cnt_val = np.asarray(batch.cnt_val)[rows]
        c.cnt_uuid = np.asarray(batch.cnt_uuid)[rows]
        c.cnt_base = np.asarray(batch.cnt_base)[rows]
        c.cnt_base_t = np.asarray(batch.cnt_base_t)[rows]

        a, z = (int(x) for x in np.searchsorted(el_sorted, (lo, hi)))
        if el_presorted:
            rows = slice(a, z)
            c.el_member = batch.el_member[a:z]
            c.el_val = batch.el_val[a:z]
        else:
            rows = el_order[a:z]
            idx = rows.tolist()
            c.el_member = [batch.el_member[i] for i in idx]
            c.el_val = [batch.el_val[i] for i in idx]
        c.el_ki = el_arr[rows] - lo
        c.el_add_t = np.asarray(batch.el_add_t)[rows]
        c.el_add_node = np.asarray(batch.el_add_node)[rows]
        c.el_del_t = np.asarray(batch.el_del_t)[rows]

        if len(tns_arr):
            a, z = (int(x) for x in np.searchsorted(tns_sorted, (lo, hi)))
            if tns_presorted:
                rows = slice(a, z)
                c.tns_cfg = batch.tns_cfg[a:z]
                c.tns_payload = batch.tns_payload[a:z]
            else:
                rows = tns_order[a:z]
                idx = rows.tolist()
                c.tns_cfg = [batch.tns_cfg[i] for i in idx]
                c.tns_payload = [batch.tns_payload[i] for i in idx]
            c.tns_ki = tns_arr[rows] - lo
            c.tns_node = np.asarray(batch.tns_node)[rows]
            c.tns_uuid = np.asarray(batch.tns_uuid)[rows]
            c.tns_cnt = np.asarray(batch.tns_cnt)[rows]

        if lo == 0 and batch.del_keys:
            c.del_keys = list(batch.del_keys)
            c.del_t = np.asarray(batch.del_t, dtype=_I64)
        yield c
