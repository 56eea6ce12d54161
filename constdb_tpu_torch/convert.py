"""State carried across from the reference package.

The reference package's `ColumnarBatch` and `KeySpace` reach the port as
plain numpy arrays, lists and dicts: whoever holds a reference object
extracts those (the tests do; this module never imports `constdb_tpu`),
and the functions here build the port's objects from them, so both
packages merge the very same bytes.

`batch_from_dict(d)`: `d` maps the reference `ColumnarBatch` field names
(BATCH_FIELDS) to their values.  Identity tokens (key_shape, el_shape,
shape_refs) name the reference's own objects and are not carried.

`keyspace_from_dict(d)`: `d` holds the reference `KeySpace` state under
KEYSPACE_FIELDS: each column group as {column name: array} ("keys",
"cnt", "el", "tns"), the side lists, the tensor configs (kid -> packed
config bytes), the key tombstones and the garbage heap.  The port's
indexes (key, member, element-combo, counter-rank and tensor-slot) are
rebuilt from the columns.
"""

from __future__ import annotations

import numpy as np

from .crdt import tensor as T
from .engine.base import ColumnarBatch
from .store.keyspace import KeySpace

_I64 = np.int64

BATCH_FIELDS = (
    "keys", "key_enc", "key_ct", "key_mt", "key_dt", "key_expire",
    "reg_val", "reg_t", "reg_node",
    "cnt_ki", "cnt_node", "cnt_val", "cnt_uuid", "cnt_base", "cnt_base_t",
    "el_ki", "el_member", "el_val", "el_add_t", "el_add_node", "el_del_t",
    "tns_ki", "tns_node", "tns_uuid", "tns_cnt", "tns_cfg", "tns_payload",
    "del_keys", "del_t", "rows_unique_per_slot", "el_has_vals")

# column group -> column names, as the reference KeySpace holds them
KEYSPACE_COLUMNS = {
    "keys": ("enc", "ct", "mt", "dt", "expire", "rv_t", "rv_node", "cnt_sum"),
    "cnt": ("kid", "node", "val", "uuid", "base", "base_t"),
    "el": ("kid", "add_t", "add_node", "del_t"),
    "tns": ("kid", "node", "uuid", "cnt"),
}
KEYSPACE_LISTS = ("key_bytes", "reg_val", "el_member", "el_val",
                  "tns_payload")
KEYSPACE_FIELDS = tuple(KEYSPACE_COLUMNS) + KEYSPACE_LISTS + (
    "tns_meta", "key_deletes", "garbage")


def _copy(v):
    if isinstance(v, np.ndarray):
        return v.copy()
    if isinstance(v, list):
        return [x.copy() if isinstance(x, np.ndarray) else x for x in v]
    return v


def batch_from_dict(d: dict) -> ColumnarBatch:
    """Port ColumnarBatch from the reference batch's fields."""
    missing = [f for f in BATCH_FIELDS if f not in d]
    if missing:
        raise KeyError(f"batch fields missing: {missing}")
    b = ColumnarBatch()
    for f in BATCH_FIELDS:
        setattr(b, f, _copy(d[f]))
    return b


def keyspace_from_dict(d: dict) -> KeySpace:
    """Port KeySpace from the reference keyspace's columns and lists."""
    missing = [f for f in KEYSPACE_FIELDS if f not in d]
    if missing:
        raise KeyError(f"keyspace fields missing: {missing}")
    ks = KeySpace()

    keys = d["keys"]
    n = len(d["key_bytes"])
    ks.keys.append_block(n, **{c: keys[c][:n] for c in KEYSPACE_COLUMNS["keys"]})
    ks.key_bytes.extend(d["key_bytes"])
    ks.reg_val.extend(d["reg_val"])
    ids, n_new = ks.key_index.get_or_insert_batch(list(d["key_bytes"]))
    if n_new != n or not np.array_equal(ids, np.arange(n)):
        raise ValueError("key bytes are not unique")

    cnt = d["cnt"]
    c = len(cnt["kid"])
    if c:
        ks.cnt.append_block(c, **{k: cnt[k] for k in KEYSPACE_COLUMNS["cnt"]})
        rows = np.arange(c, dtype=_I64)
        for node in np.unique(cnt["node"]).tolist():
            sel = np.nonzero(cnt["node"] == node)[0]
            ks.cnt_rows_assign(ks.rank_of(int(node)),
                               np.asarray(cnt["kid"])[sel].astype(_I64),
                               rows[sel])

    el = d["el"]
    e = len(el["kid"])
    if e:
        ks.el.append_block(e, **{k: el[k] for k in KEYSPACE_COLUMNS["el"]})
        ks.el_member.extend(d["el_member"])
        ks.el_val.extend(d["el_val"])
        kid = np.asarray(el["kid"], dtype=_I64)
        live = np.nonzero(kid >= 0)[0]
        ks.el_dead = e - len(live)
        if len(live):
            members = [d["el_member"][r] for r in live.tolist()]
            mids, _ = ks.member_index.get_or_insert_batch(members)
            ks.el_index.put_batch((kid[live] << KeySpace.MEMBER_BITS) | mids,
                                  live.astype(_I64))

    tns = d["tns"]
    t = len(tns["kid"])
    if t:
        ks.tns.append_block(t, **{k: tns[k] for k in KEYSPACE_COLUMNS["tns"]})
        for row, (kid, node) in enumerate(zip(
                np.asarray(tns["kid"]).tolist(),
                np.asarray(tns["node"]).tolist())):
            ks.tns_index.put((kid << KeySpace.NODE_RANK_BITS)
                             | ks.rank_of(node), row)
        for p in d["tns_payload"]:
            ks.tns_payload.append(None if p is None else np.array(p))
            if p is not None:
                ks.tns_bytes += ks.tns_payload[-1].nbytes
    ks.tns_meta = {int(k): T.unpack_config(v)
                   for k, v in d["tns_meta"].items()}

    ks.key_deletes = dict(d["key_deletes"])
    ks.garbage = list(d["garbage"])
    ks._garbage_seq = max((g[1] for g in ks.garbage), default=0)
    return ks
