"""The join of R replica snapshots, computed plainly.

The rules (the store's CRDT semantics, as the configurations state them):

* key envelope: create, modify and delete times merge as the maximum over
  the replicas; the expiry likewise;
* register: last writer wins on (time, writer node), larger wins; the
  value follows the winner;
* counter slot (key, node): the total is a last-writer-wins register on
  its uuid, the larger total on a tie; the delete-observed base likewise
  on its time; a key's sum is the sum over its slots of total - base,
  exact mod 2^64;
* element (key, member): the add side is last-writer-wins on (add time,
  add node), the value following it; the delete time is the maximum.
"""

from __future__ import annotations

import numpy as np

I64 = np.int64


def _lex_argmax(t: np.ndarray, node: np.ndarray) -> np.ndarray:
    """Per column of [R, n] arrays, the row of the largest (t, node)."""
    best = np.zeros(t.shape[1], I64)
    for r in range(1, t.shape[0]):
        bt = np.take_along_axis(t, best[None], 0)[0]
        bn = np.take_along_axis(node, best[None], 0)[0]
        win = (t[r] > bt) | ((t[r] == bt) & (node[r] > bn))
        best[win] = r
    return best


def _pick(a: np.ndarray, rows: np.ndarray) -> np.ndarray:
    return np.take_along_axis(a, rows[None], 0)[0]


def _last_per_group(group: np.ndarray, *order) -> np.ndarray:
    """Indices of the last row of each group after sorting by (group,
    *order), order keys last-significant first as np.lexsort takes them
    reversed: the row with the largest order tuple in each group."""
    idx = np.lexsort((*order[::-1], group))
    g = group[idx]
    last = np.ones(len(g), bool)
    last[:-1] = g[1:] != g[:-1]
    return idx[last]


def _values(pool: list, idx: np.ndarray) -> tuple:
    """Pool indices (-1: none) -> (has, values as numpy bytes)."""
    has = idx >= 0
    arr = np.array(pool if pool else [b""], dtype=object)
    vals = np.where(has, arr[np.where(has, idx, 0)], b"")
    return has, vals.astype(np.bytes_) if len(vals) else np.zeros(0, "S1")


def counter_slots(ki, node, val, uuid, base, base_t, n_keys: int) -> dict:
    """Rows (any order, repeats allowed) joined per (key, node) slot, and
    each key's sum."""
    slot = (ki.astype(I64) << 24) | node
    win = _last_per_group(slot, uuid, val)
    bwin = _last_per_group(slot, base_t, base)
    # both orders put the slots in the same (ascending slot) order
    out = {"c_key": ki[win], "c_node": node[win], "c_val": val[win],
           "c_uuid": uuid[win], "c_base": base[bwin],
           "c_base_t": base_t[bwin]}
    sums = np.zeros(n_keys, I64)
    np.add.at(sums, out["c_key"], out["c_val"] - out["c_base"])
    return out, sums


def snapshot_join(snap: dict) -> dict:
    """The joined keyspace of the generated snapshots (gen.snapshots), in
    the state form of reference/__init__.py."""
    n = len(snap["keys"])
    w = _lex_argmax(snap["reg_t"], snap["reg_node"])
    reg_has, reg_val = _values(snap["reg_pool"], _pick(snap["reg_val"], w))
    out = {"key": np.array(snap["keys"], dtype=np.bytes_),
           "enc": snap["enc"].astype(I64),
           "ct": snap["ct"].max(0), "mt": snap["mt"].max(0),
           "dt": snap["dt"].max(0), "expire": np.zeros(n, I64),
           "reg_has": reg_has, "reg_val": reg_val,
           "reg_t": _pick(snap["reg_t"], w),
           "reg_node": _pick(snap["reg_node"], w)}
    cols = [snap[c].ravel() for c in ("cnt_ki", "cnt_node", "cnt_val",
                                      "cnt_uuid", "cnt_base", "cnt_base_t")]
    slots, out["cnt_sum"] = counter_slots(*cols, n)
    out.update(slots)
    e = _lex_argmax(snap["el_add_t"], snap["el_add_node"])
    e_has, e_val = _values(snap["el_pool"], _pick(snap["el_val"], e))
    out.update(e_key=snap["el_ki"],
               e_member=np.array(snap["member_pool"],
                                 dtype=np.bytes_)[snap["el_member"]],
               e_add_t=_pick(snap["el_add_t"], e),
               e_add_node=_pick(snap["el_add_node"], e),
               e_del_t=snap["el_del_t"].max(0), e_has=e_has, e_val=e_val)
    return out
