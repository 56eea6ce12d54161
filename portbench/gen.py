"""The benchmark's traffic generators: plain numpy, nothing of the program.

Two kinds of input, each made whole from a seed:

* `snapshots(cfg, seed)`: R replica snapshots of one keyspace, as plain
  arrays (the "raw form" that `feed.py` turns into the program's batches
  and that `reference/join.py` joins).  `cfg["shape"]` picks the layout:
  "mixed" is the reference bench's `make_workload` (bench.py; the port's
  copy is constdb_tpu_torch/workload.py), draw for draw: 40% PN-counters,
  30% LWW registers, 30% sets of `members_per_set` members, ~2% of keys
  tombstoned, 10% of members deleted, each replica with its own counter
  slot.  "hash" is the LWW-hash deployment: every replica writes every
  field of every key with its own (uuid, node) and a value from a pool.
* `peer_ops(mix, n_frames, seed)` and `encode_frames(ops, origin)`: one
  peer's replication stream, the frame mix of bench.py `--mode stream`
  (make_frame_log) drawn with numpy, and its RESP bytes rendered
  vectorised, shape class by shape class, with no Python loop per frame.
"""

from __future__ import annotations

import numpy as np

I64 = np.int64
SEQ_BITS = 22                # HLC uuid = (ms << SEQ_BITS) | seq
MS0 = 1_700_000_000_000      # fixed epoch, so uuids look like real HLC values
NEUTRAL_T = -(1 << 62)       # "never written": loses to every real time

ENC_COUNTER, ENC_BYTES, ENC_DICT, ENC_SET = 0, 3, 4, 5


def _uuids(rng, n: int, span_ms: int = 600_000) -> np.ndarray:
    ms = (rng.random(n) * span_ms).astype(I64)
    seq = (rng.random(n) * (1 << 10)).astype(I64)
    return ((MS0 + ms) << SEQ_BITS) | seq


def _pool(fmt: str, n: int) -> list:
    return [(fmt % i).encode() for i in range(n)]


def snapshots(cfg: dict, seed: int) -> dict:
    """The R replicas' snapshots of `cfg`'s keyspace.  -> dict of
    `keys` (list of bytes), `enc` [N] int8, per replica [R, N] `ct`,
    `mt`, `dt`, registers `reg_val` [R, N] (pool index, -1 none), `reg_t`,
    `reg_node`, counter rows [R, C] `cnt_ki`, `cnt_node`, `cnt_val`,
    `cnt_uuid`, `cnt_base`, `cnt_base_t`, element rows `el_ki` [M] and
    `el_member` [M] (shared by every replica), [R, M] `el_add_t`,
    `el_add_node`, `el_del_t`, `el_val` (pool index, -1 none), and the
    pools `reg_pool`, `member_pool`, `el_pool`."""
    shape = cfg["shape"]
    if shape == "mixed":
        return _mixed(cfg, seed)
    if shape == "hash":
        return _hash(cfg, seed)
    raise ValueError(f"unknown snapshot shape {shape!r}")


def _envelopes(rng, n: int, tomb: float) -> tuple:
    ct = _uuids(rng, n)
    mt = ct + (rng.integers(0, 1000, n) << SEQ_BITS)
    dt = np.where(rng.random(n) < tomb, mt + (1 << SEQ_BITS), 0).astype(I64)
    return ct, mt, dt


def _mixed(cfg: dict, seed: int) -> dict:
    n, R = int(cfg["n_keys"]), int(cfg["n_replicas"])
    mps = int(cfg["members_per_set"])
    rng = np.random.default_rng(seed)
    n_cnt = int(n * cfg["counter_share"])
    n_reg = int(n * cfg["register_share"])
    reg_pool = _pool(cfg["register_value_format"], cfg["register_pool"])
    member_pool = _pool(cfg["member_format"], cfg["member_pool"])
    reg_idx = rng.integers(0, len(reg_pool), n_reg)
    set_ki = np.repeat(np.arange(n_cnt + n_reg, n, dtype=I64), mps)
    member_idx = rng.integers(0, len(member_pool), len(set_ki))
    # one row per (key, member): keep each pair's first draw
    _, first = np.unique((set_ki << 32) | member_idx, return_index=True)
    first.sort()
    el_ki, el_member = set_ki[first], member_idx[first]
    M = len(el_ki)
    enc = np.full(n, ENC_SET, np.int8)
    enc[:n_cnt] = ENC_COUNTER
    enc[n_cnt:n_cnt + n_reg] = ENC_BYTES
    out = _empty(n, R, n_cnt, M)
    out.update(keys=[(cfg["key_format"] % i).encode() for i in range(n)],
               enc=enc, el_ki=el_ki, el_member=el_member,
               reg_pool=reg_pool, member_pool=member_pool, el_pool=[])
    reg = slice(n_cnt, n_cnt + n_reg)
    for r in range(R):
        out["ct"][r], out["mt"][r], out["dt"][r] = _envelopes(
            rng, n, cfg["tombstone_share"])
        out["reg_val"][r, reg] = reg_idx
        out["reg_t"][r, reg] = _uuids(rng, n_reg)
        out["reg_node"][r, reg] = r + 1
        # each replica's snapshot carries that replica's own counter slot
        out["cnt_ki"][r] = np.arange(n_cnt)
        out["cnt_node"][r] = r + 1
        out["cnt_val"][r] = rng.integers(-1000, 1000, n_cnt)
        out["cnt_uuid"][r] = _uuids(rng, n_cnt)
        out["el_add_t"][r] = _uuids(rng, M)
        out["el_add_node"][r] = r + 1
        out["el_del_t"][r] = np.where(rng.random(M) < cfg["member_delete_share"],
                                      _uuids(rng, M), 0)
    return out


def _hash(cfg: dict, seed: int) -> dict:
    n, R = int(cfg["n_keys"]), int(cfg["n_replicas"])
    nf = int(cfg["fields_per_key"])
    rng = np.random.default_rng(seed)
    el_pool = _pool(cfg["value_format"], cfg["value_pool"])
    M = n * nf
    out = _empty(n, R, 0, M)
    out.update(keys=[(cfg["key_format"] % i).encode() for i in range(n)],
               enc=np.full(n, ENC_DICT, np.int8),
               el_ki=np.repeat(np.arange(n, dtype=I64), nf),
               el_member=np.tile(np.arange(nf, dtype=I64), n),
               reg_pool=[], member_pool=_pool(cfg["field_format"], nf),
               el_pool=el_pool)
    for r in range(R):
        out["ct"][r], out["mt"][r], out["dt"][r] = _envelopes(
            rng, n, cfg["tombstone_share"])
        out["el_add_t"][r] = _uuids(rng, M)
        out["el_add_node"][r] = r + 1
        out["el_val"][r] = rng.integers(0, len(el_pool), M)
    return out


def _empty(n: int, R: int, C: int, M: int) -> dict:
    z = lambda *s: np.zeros(s, I64)  # noqa: E731
    return {"ct": z(R, n), "mt": z(R, n), "dt": z(R, n),
            "reg_val": np.full((R, n), -1, I64), "reg_t": z(R, n),
            "reg_node": z(R, n),
            "cnt_ki": z(R, C), "cnt_node": z(R, C), "cnt_val": z(R, C),
            "cnt_uuid": z(R, C), "cnt_base": z(R, C),
            "cnt_base_t": np.full((R, C), NEUTRAL_T, I64),
            "el_add_t": z(R, M), "el_add_node": z(R, M), "el_del_t": z(R, M),
            "el_val": np.full((R, M), -1, I64)}


# ------------------------------------------------------------ the stream

# frame classes, in the order of bench.py make_frame_log's thresholds
CLASSES = ("set", "cntset", "sadd", "srem", "hset", "hdel", "delbytes",
           "delset")
PREFIX = {"set": b"r", "delbytes": b"r", "cntset": b"c", "sadd": b"s",
          "srem": b"s", "delset": b"s", "hset": b"h", "hdel": b"h"}


def peer_ops(mix: dict, n_frames: int, seed) -> dict:
    """One peer's stream of `n_frames` REPLICATE frames: frame i (1-based)
    has uuid (MS0 + i) << SEQ_BITS and previous uuid that of frame i - 1
    (0 for the first).  -> arrays: `cls` (index into CLASSES), `key`
    (index under the class's prefix), `uuid`, `prev`, `total` (cntset),
    `members` [F, k] (sadd; srem uses column 0), `fields` [F, k] (hset;
    hdel uses column 0)."""
    rng = np.random.default_rng(seed)
    F = int(n_frames)
    cum = np.cumsum([mix["shares"][c] for c in CLASSES])
    if abs(cum[-1] - 1.0) > 1e-9:
        raise ValueError(f"frame shares sum to {cum[-1]}, not 1")
    cls = np.searchsorted(cum, rng.random(F), side="right").astype(np.int8)
    cls = np.minimum(cls, len(CLASSES) - 1)
    i = np.arange(1, F + 1, dtype=I64)
    uuid = (MS0 + i) << SEQ_BITS
    prev = np.concatenate([[0], uuid[:-1]]).astype(I64)
    lo, hi = mix["counter_total_range"]
    return {"cls": cls,
            "key": rng.integers(0, mix["keys_per_prefix"], F),
            "uuid": uuid, "prev": prev, "i": i,
            "total": rng.integers(lo, hi, F),
            "members": rng.integers(0, mix["set_members"],
                                    (F, mix["sadd_members"])),
            "fields": rng.integers(0, mix["hash_fields"],
                                   (F, mix["hset_fields"]))}


def _digits(v: np.ndarray, width: int) -> np.ndarray:
    """Non-negative ints as fixed-width ASCII decimal: [n, width] uint8."""
    p = 10 ** np.arange(width - 1, -1, -1, dtype=I64)
    return (48 + (v[:, None] // p) % 10).astype(np.uint8)


def _ndigits(v: np.ndarray) -> np.ndarray:
    """Decimal digit count of non-negative ints (0 has one)."""
    n = np.ones(len(v), I64)
    for k in range(1, 19):
        n += v >= 10 ** k
    return n


def _const(b: bytes, n: int) -> np.ndarray:
    return np.broadcast_to(np.frombuffer(b, np.uint8), (n, len(b)))


def _bulk(prefix: bytes, digits: np.ndarray) -> list:
    """Parts of a bulk string `prefix + digits` ([n, w] uint8)."""
    n, w = digits.shape
    head = b"$%d\r\n" % (len(prefix) + w) + prefix
    return [_const(head, n), digits, _const(b"\r\n", n)]


def _int(v: np.ndarray, width: int) -> list:
    """Parts of RESP integers of `width` digits (v >= 0)."""
    n = len(v)
    return [_const(b":", n), _digits(v, width), _const(b"\r\n", n)]


def encode_frames(ops: dict, mix: dict, origin: int) -> tuple:
    """The stream's RESP bytes, as make_frame_log + frame_log_bytes would
    write them (`*N` arrays: replicate, origin, prev, uuid, command, key,
    arguments; integers as `:`, the rest as bulk strings).  Frames fall
    into shape classes of one byte width each (class, counter total's
    sign and digit count, first frame or not); each class renders as one
    [n, width] block scattered to its frames' offsets.
    -> (bytes, frame end offsets [F])."""
    cls, F = ops["cls"], len(ops["cls"])
    kw = int(mix["key_digits"])
    tot = ops["total"]
    if F and int(ops["i"][-1]) >= 10 ** 7:
        raise ValueError("frame numbers must stay under 10**7 (the "
                         "values' digit widths)")
    # a counter total's width: its digit count and its sign
    tw = np.where(cls == CLASSES.index("cntset"),
                  _ndigits(np.abs(tot)) * 2 + (tot < 0), 0)
    first = (ops["prev"] == 0).astype(I64)
    shape = (cls.astype(I64) * 64 + tw) * 2 + first
    blocks = {}
    for code in np.unique(shape).tolist():
        sel = np.nonzero(shape == code)[0]
        blocks[code] = (sel, _render(ops, mix, sel, int(cls[sel[0]]),
                                     int(first[sel[0]]), kw, origin))
    width = np.zeros(F, I64)
    for sel, block in blocks.values():
        width[sel] = block.shape[1]
    end = np.cumsum(width)
    out = np.empty(int(end[-1]) if F else 0, np.uint8)
    for sel, block in blocks.values():
        pos = (end[sel] - block.shape[1])[:, None] + np.arange(block.shape[1])
        out[pos] = block
    return out.tobytes(), end


def _render(ops: dict, mix: dict, sel: np.ndarray, c: int, first: int,
            kw: int, origin: int) -> np.ndarray:
    name = CLASSES[c]
    n = len(sel)
    uuid = ops["uuid"][sel]
    args = {"set": 2, "cntset": 2, "sadd": 1 + mix["sadd_members"],
            "srem": 2, "hset": 1 + 2 * mix["hset_fields"], "hdel": 2,
            "delbytes": 1, "delset": 1}[name]
    parts = [_const(b"*%d\r\n$9\r\nreplicate\r\n" % (5 + args), n),
             *_int(np.full(n, origin, I64), len(str(origin))),
             *(_int(np.zeros(n, I64), 1) if first else _int(ops["prev"][sel], 19)),
             *_int(uuid, 19),
             _const(b"$%d\r\n%s\r\n" % (len(name), name.encode()), n),
             *_bulk(PREFIX[name], _digits(ops["key"][sel], kw))]
    if name == "set":
        parts += _bulk(b"v", _digits(ops["i"][sel], 8))
    elif name == "cntset":
        t = ops["total"][sel]
        neg = bool(t[0] < 0)
        w = int(_ndigits(np.abs(t[:1]))[0])
        parts += [_const(b":-" if neg else b":", n), _digits(np.abs(t), w),
                  _const(b"\r\n", n)]
    elif name in ("sadd", "srem"):
        k = mix["sadd_members"] if name == "sadd" else 1
        for j in range(k):
            parts += _bulk(b"m", _digits(ops["members"][sel, j], 3))
    elif name in ("hset", "hdel"):
        k = mix["hset_fields"] if name == "hset" else 1
        for j in range(k):
            parts += _bulk(b"f", _digits(ops["fields"][sel, j], 2))
            if name == "hset":
                parts += _bulk(b"v", np.concatenate(
                    [_digits(ops["i"][sel], 7),
                     _digits(np.full(n, j, I64), 1)], axis=1))
    return np.concatenate(parts, axis=1)

