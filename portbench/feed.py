"""The generated snapshots in the program's input format.

A full resync receives each replica's snapshot as key-range chunks; the
program takes them as `ColumnarBatch`es cut by its own chunker
(persist/snapshot.py `batch_chunks`), the replicas' chunks interleaved so
that every R consecutive chunks cover one key range.  The bytes columns
(keys, members, values) are built once here, in set-up, and the program
reads them as the snapshot loader would hand them over.
"""

from __future__ import annotations

import numpy as np


def replica_batches(snap: dict) -> list:
    """One ColumnarBatch per replica (rows unique per slot: snapshots).
    Key bytes, encodings and element keys and members are shared by the
    replicas, as the snapshots of one keyspace share them."""
    from constdb_tpu_torch.engine.base import ColumnarBatch

    R = snap["ct"].shape[0]
    keys = snap["keys"]
    members = [snap["member_pool"][i] for i in snap["el_member"].tolist()]
    no_vals = [None] * len(members)
    out = []
    for r in range(R):
        b = ColumnarBatch()
        b.rows_unique_per_slot = True
        b.keys = keys
        b.key_enc = snap["enc"]
        b.key_ct, b.key_mt, b.key_dt = (snap[c][r] for c in ("ct", "mt", "dt"))
        b.key_expire = np.zeros(len(keys), np.int64)
        b.reg_val = _values(snap["reg_val"][r], snap["reg_pool"])
        b.reg_t, b.reg_node = snap["reg_t"][r], snap["reg_node"][r]
        (b.cnt_ki, b.cnt_node, b.cnt_val, b.cnt_uuid, b.cnt_base,
         b.cnt_base_t) = (snap[c][r] for c in (
             "cnt_ki", "cnt_node", "cnt_val", "cnt_uuid", "cnt_base",
             "cnt_base_t"))
        b.el_ki = snap["el_ki"]
        b.el_member = members
        b.el_val = no_vals if not snap["el_pool"] else \
            _values(snap["el_val"][r], snap["el_pool"])
        b.el_add_t, b.el_add_node, b.el_del_t = (
            snap[c][r] for c in ("el_add_t", "el_add_node", "el_del_t"))
        out.append(b)
    return out


def _values(idx: np.ndarray, pool: list) -> list:
    """Pool indices (-1: no value) as the batch's bytes column."""
    lookup = [*pool, None]
    return [lookup[i] for i in idx.tolist()]


def interleaved_chunks(batches: list, chunk_keys: int) -> list:
    """The replicas' `chunk_keys`-key chunks in arrival order: chunk 0 of
    every replica, then chunk 1 of every replica, and so on."""
    from constdb_tpu_torch.persist.snapshot import batch_chunks

    per_replica = [list(batch_chunks(b, chunk_keys)) for b in batches]
    return [c for group in zip(*per_replica) for c in group]
