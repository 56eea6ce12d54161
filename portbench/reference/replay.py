"""Peers' replication frames replayed plainly, on top of a keyspace.

Each frame is one operation by its origin node at its uuid; the rules
are the store's operation semantics:

* set: register last-writer-wins on (uuid, origin); data write;
* cntset: the origin's counter slot takes the total, last-writer-wins on
  uuid; data write;
* sadd / hset: each member's (field's) add side takes (uuid, origin,
  value) where larger; a repeat of one field in one frame leaves the
  last value; data write;
* srem / hdel: each member's delete time takes the uuid where larger;
  a member never added holds add side (0, 0); data write;
* delbytes: the key's delete time takes the uuid where larger;
* delset: the key's delete time likewise, and every member the key holds
  has its delete time raised to it; a member added later with an older
  uuid is deleted at the key's delete time.

A data write raises the key's create time to its uuid, every frame its
modify time; a key first made by a delete has create time 0.

A member's delete time is compared in the store's canonical form: a
delete time at or below the add time is inert (visibility and every later
merge are the same) and reads 0.  Two orders of one set's frames can
leave a member that no frame ever added with different delete times: a
delset applied before another peer's pending srem of that member lands
does not reach it.  Such a row's delete time is held to the range from
its own removes' latest to the latest of those and the key's delsets
(`e_del_t` .. `e_del_hi`); every other row is exact.
"""

from __future__ import annotations

import numpy as np

from .join import _last_per_group, counter_slots

I64 = np.int64
CLASSES = ("set", "cntset", "sadd", "srem", "hset", "hdel", "delbytes",
           "delset")
C = {name: k for k, name in enumerate(CLASSES)}
PREFIXES = (b"r", b"c", b"s", b"h")
PREFIX_OF = (0, 1, 2, 2, 3, 3, 0, 2)       # class -> prefix index
ENC_OF_PREFIX = (3, 0, 5, 4)               # bytes, counter, set, dict
NEUTRAL_T = -(1 << 62)


def _ops(peers: list) -> dict:
    """Every peer's fed frames as one set of arrays (peer order, frame
    order): peers = [(origin, ops dict truncated to the fed frames)]."""
    cat = {}
    for name in ("cls", "key", "uuid", "i", "total", "members", "fields"):
        cat[name] = np.concatenate([o[name] for _n, o in peers])
    cat["node"] = np.concatenate([np.full(len(o["cls"]), n, I64)
                                  for n, o in peers])
    # the order last-writer-wins decides by: the uuid, unless the caller
    # gives another (the check's control decides by arrival)
    cat["order"] = np.concatenate([o.get("order", o["uuid"])
                                   for _n, o in peers])
    return cat


def stream_replay(peers: list, mix: dict) -> dict:
    """The keyspace the fed frames make, in the state form (keys sorted
    by prefix then index)."""
    o = _ops(peers)
    cls = o["cls"].astype(I64)
    K = int(mix["keys_per_prefix"])
    kw = int(mix["key_digits"])
    gkey = np.asarray(PREFIX_OF, I64)[cls] * K + o["key"]
    keys, kidx = np.unique(gkey, return_inverse=True)
    n = len(keys)
    u, node = o["uuid"], o["node"]

    def kmax(sel, vals, fill=0):
        out = np.full(n, fill, I64)
        np.maximum.at(out, kidx[sel], vals[sel])
        return out

    data = (cls != C["delbytes"]) & (cls != C["delset"])
    dele = ~data
    st = {"key": np.array([PREFIXES[g // K] + b"%0*d" % (kw, g % K)
                           for g in keys.tolist()], dtype=np.bytes_),
          "enc": np.asarray(ENC_OF_PREFIX, I64)[keys // K],
          "ct": kmax(data, u), "mt": kmax(np.ones(len(u), bool), u),
          "dt": kmax(dele, u), "expire": np.zeros(n, I64)}

    # registers: the largest (uuid, origin) set
    sets = np.nonzero(cls == C["set"])[0]
    order = o["order"]
    w = sets[_last_per_group(kidx[sets], order[sets], node[sets])]
    st["reg_has"] = np.zeros(n, bool)
    st["reg_val"] = np.full(n, b"", dtype="S9")
    st["reg_t"] = np.zeros(n, I64)
    st["reg_node"] = np.zeros(n, I64)
    st["reg_has"][kidx[w]] = True
    st["reg_val"][kidx[w]] = [b"v%08d" % i for i in o["i"][w].tolist()]
    st["reg_t"][kidx[w]] = u[w]
    st["reg_node"][kidx[w]] = node[w]

    # counters: each origin's slot
    c = np.nonzero(cls == C["cntset"])[0]
    slots, st["cnt_sum"] = counter_slots(
        kidx[c], node[c], o["total"][c], u[c], np.zeros(len(c), I64),
        np.full(len(c), NEUTRAL_T, I64), n)
    st.update(slots)

    st.update(_elements(o, cls, kidx, keys // K, mix, n))
    return st


def _elements(o: dict, cls, kidx, key_prefix, mix: dict, n: int) -> dict:
    u, node = o["uuid"], o["node"]
    km, kf = int(mix["sadd_members"]), int(mix["hset_fields"])
    parts = []   # (frame rows, member codes, slot j, is add)
    for name, width, col, add in (("sadd", km, "members", True),
                                  ("srem", 1, "members", False),
                                  ("hset", kf, "fields", True),
                                  ("hdel", 1, "fields", False)):
        rows = np.nonzero(cls == C[name])[0]
        for j in range(width):
            parts.append((rows, o[col][rows, j], np.full(len(rows), j, I64),
                          add))
    f = np.concatenate([p[0] for p in parts])
    mem = np.concatenate([p[1] for p in parts]).astype(I64)
    j = np.concatenate([p[2] for p in parts])
    add = np.concatenate([np.full(len(p[0]), p[3]) for p in parts])
    slot = (kidx[f].astype(I64) << 16) | mem
    slots, e_idx = np.unique(slot, return_inverse=True)
    m = len(slots)

    # add side: the largest (uuid, origin, position in the frame)
    a = np.nonzero(add)[0]
    wa = a[_last_per_group(e_idx[a], o["order"][f[a]], node[f[a]], j[a])]
    add_t = np.zeros(m, I64)
    add_node = np.zeros(m, I64)
    add_t[e_idx[wa]] = u[f[wa]]
    add_node[e_idx[wa]] = node[f[wa]]
    has = np.zeros(m, bool)
    val = np.full(m, b"", dtype="S9")
    hs = wa[cls[f[wa]] == C["hset"]]
    has[e_idx[hs]] = True
    val[e_idx[hs]] = [b"v%07d%d" % (i, jj) for i, jj in
                      zip(o["i"][f[hs]].tolist(), j[hs].tolist())]

    # delete side: the row's own removes, and its key's delsets
    r = np.nonzero(~add)[0]
    own = np.zeros(m, I64)
    np.maximum.at(own, e_idx[r], u[f[r]])
    ds = np.nonzero(cls == C["delset"])[0]
    key_del = np.zeros(n, I64)
    np.maximum.at(key_del, kidx[ds], u[ds])
    e_key = slots >> 16
    both = np.maximum(own, key_del[e_key])
    added = add_t > 0
    lo = np.where(added, both, own)
    hi = both
    # canonical form: a delete time at or below the add time reads 0
    lo = np.where(lo > add_t, lo, 0)
    hi = np.where(hi > add_t, hi, 0)
    # members and fields are told apart by their key's prefix
    set_names = np.array([b"m%03d" % k for k in range(int(mix["set_members"]))],
                         dtype="S4")
    field_names = np.array([b"f%02d" % k for k in range(int(mix["hash_fields"]))],
                           dtype="S4")
    code = slots & 0xFFFF
    is_set = key_prefix[e_key] == PREFIXES.index(b"s")
    member = np.where(is_set, set_names[np.where(is_set, code, 0)],
                      field_names[np.where(is_set, 0, code)])
    return {"e_key": e_key, "e_member": member,
            "e_add_t": add_t, "e_add_node": add_node, "e_del_t": lo,
            "e_del_hi": hi, "e_has": has, "e_val": val}
