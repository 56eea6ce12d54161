"""Workloads of the port: generators, chunker and oracles.

The snapshot catch-up is the port's own copy of the reference bench's
workload helpers (bench.py make_workload, chunk_batches, subsample_keys,
subsample_workload, oracle_canonical): R replica snapshots of one mixed
N-key keyspace, 40% PN-counters, 30% LWW registers, 30% sets of
`members_per_set` members, made from a seed with numpy.

`write_replica_files` and `file_catchup` take the same catch-up through
snapshot files: one file per replica, read back through one
`SectionDemux` each, the replicas' chunks interleaved as
`chunk_batches` interleaves them.  `sharded_file_catchup` takes it
through a hash-sharded store (store/sharded_keyspace.py) and then
consolidates the shards into one serving store.

The steady state has two more generators (see their docstrings):
`make_stream_workload`, a peer's replication stream as the coalescer
lands it, and `make_tensor_workload`, tensor-register contributions;
`replay_oracle` replays either through the CPU engine.  Through the
node: `make_frame_log` is the same stream as REPLICATE frames (bench.py
--mode stream's log), `replay_stream` drives its RESP bytes through a
node's parser and coalescer, `wire_frames` / `wire_replay` ship a
pusher's repl_log as its push loop splits it (REPLBATCH runs), and
`tensor_peer_frames` makes several peers' tensor contributions.

One shape is added: `aligned_counters=True` gives every replica's dump
the counter slots of all R writer nodes, the way a converged cluster's
snapshot holds them, each replica with its own view (value, uuid) of
every slot.  Counter rows then align across replicas and take the
device fold (K2 merge_counters); in the default shape each replica
carries only its own slot, so counter rows never align.
"""

from __future__ import annotations

import os
import sys
import time

import numpy as np

from .crdt import semantics as S
from .crdt import tensor as T
from .engine.base import ColumnarBatch
from .engine.cpu import CpuMergeEngine
from .persist.snapshot import (NodeMeta, SectionDemux, batch_chunks,
                               write_snapshot_file)
from .store.keyspace import KeySpace

_I64 = np.int64
SEQ_BITS = 22                # HLC uuid = (ms << SEQ_BITS) | seq
MS0 = 1_700_000_000_000      # fixed epoch so uuids look like real HLC values


def _uuids(rng, n, span_ms=600_000):
    ms = (rng.random(n) * span_ms).astype(_I64)
    seq = (rng.random(n) * (1 << 10)).astype(_I64)
    return ((MS0 + ms) << SEQ_BITS) | seq


_REG_POOL = 1024
_MEMBER_POOL = 4096


def _layout(rng, n_keys: int, members_per_set: int):
    """The keyspace layout of make_workload, the first draws of its rng:
    -> (counter keys, register keys, register value ids, set member
    rows' key ids, member ids)."""
    n_cnt = int(n_keys * 0.4)
    n_reg = int(n_keys * 0.3)
    reg_idx = rng.integers(0, _REG_POOL, n_reg)
    set_ki = np.repeat(np.arange(n_cnt + n_reg, n_keys, dtype=_I64),
                       members_per_set)
    member_idx = rng.integers(0, _MEMBER_POOL, len(set_ki))
    # batches declare rows_unique_per_slot: drop duplicate (key, member)
    # draws so the claim actually holds
    combo = (set_ki << 32) | member_idx
    _, first = np.unique(combo, return_index=True)
    first.sort()
    return n_cnt, n_reg, reg_idx, set_ki[first], member_idx[first]


def fold_widths(n_keys: int, seed: int, chunk_keys: int,
                members_per_set: int = 4) -> dict:
    """The aligned folds' widths of a catch-up of make_workload(n_keys,
    R, seed) in `chunk_keys`-key chunks, per chunk that holds such rows,
    without making the batches: {"reg": register keys, "el": set member
    rows}.  Every register holds a value in every replica and every
    replica holds the same member rows, so each chunk group's register
    and element rows align and fold in one [R, width] pass."""
    n_cnt, n_reg, _, set_ki, _ = _layout(np.random.default_rng(seed),
                                         n_keys, members_per_set)
    edges = np.arange(0, n_keys + chunk_keys, chunk_keys)
    reg = np.diff(np.clip(edges, n_cnt, n_cnt + n_reg))
    el = np.diff(np.searchsorted(set_ki, edges))
    return {"reg": [int(w) for w in reg if w],
            "el": [int(w) for w in el if w]}


def make_workload(n_keys: int, n_replicas: int, seed: int = 7,
                  members_per_set: int = 4,
                  aligned_counters: bool = False) -> list[ColumnarBatch]:
    """R snapshot batches over one mixed N-key keyspace.  Immutable
    columns (key bytes, enc, member bytes, slot layout) are built once and
    shared across batches, as replica snapshots of one keyspace share
    them.  `aligned_counters`: see the module docstring."""
    rng = np.random.default_rng(seed)
    keys = [b"k%010d" % i for i in range(n_keys)]
    n_cnt, n_reg, reg_idx, set_ki, member_idx = _layout(
        rng, n_keys, members_per_set)
    n_set = n_keys - n_cnt - n_reg
    enc = np.empty(n_keys, dtype=np.int8)
    enc[:n_cnt] = S.ENC_COUNTER
    enc[n_cnt:n_cnt + n_reg] = S.ENC_BYTES
    enc[n_cnt + n_reg:] = S.ENC_SET
    reg_pool = [b"v%06d" % i for i in range(_REG_POOL)]
    member_pool = [b"m%04d" % i for i in range(_MEMBER_POOL)]
    el_member = [member_pool[i] for i in member_idx]
    el_val = [None] * len(set_ki)
    if aligned_counters:
        # every dump holds all R writers' slots of every counter key
        cnt_ki = np.repeat(np.arange(n_cnt, dtype=_I64), n_replicas)
        cnt_node = np.tile(np.arange(1, n_replicas + 1, dtype=_I64), n_cnt)

    batches = []
    for r in range(n_replicas):
        b = ColumnarBatch()
        b.rows_unique_per_slot = True
        b.keys = keys
        b.key_enc = enc
        b.key_ct = _uuids(rng, n_keys)
        b.key_mt = b.key_ct + (rng.integers(0, 1000, n_keys) << SEQ_BITS)
        # ~2% of keys tombstoned later than their create time
        dt = np.where(rng.random(n_keys) < 0.02,
                      b.key_mt + (1 << SEQ_BITS), 0)
        b.key_dt = dt.astype(_I64)
        b.key_expire = np.zeros(n_keys, dtype=_I64)

        b.reg_val = [None] * n_cnt + [reg_pool[i] for i in reg_idx] + \
                    [None] * n_set
        b.reg_t = np.zeros(n_keys, dtype=_I64)
        b.reg_t[n_cnt:n_cnt + n_reg] = _uuids(rng, n_reg)
        b.reg_node = np.zeros(n_keys, dtype=_I64)
        b.reg_node[n_cnt:n_cnt + n_reg] = r + 1

        if aligned_counters:
            b.cnt_ki = cnt_ki
            b.cnt_node = cnt_node
        else:
            # each replica snapshot carries that replica's own counter slot
            b.cnt_ki = np.arange(n_cnt, dtype=_I64)
            b.cnt_node = np.full(n_cnt, r + 1, dtype=_I64)
        n_rows = len(b.cnt_ki)
        b.cnt_val = rng.integers(-1000, 1000, n_rows).astype(_I64)
        b.cnt_uuid = _uuids(rng, n_rows)
        b.cnt_base = np.zeros(n_rows, dtype=_I64)
        b.cnt_base_t = np.full(n_rows, S.NEUTRAL_T, dtype=_I64)

        b.el_ki = set_ki
        b.el_member = el_member
        b.el_val = el_val
        b.el_add_t = _uuids(rng, len(set_ki))
        b.el_add_node = np.full(len(set_ki), r + 1, dtype=_I64)
        b.el_del_t = np.where(rng.random(len(set_ki)) < 0.1,
                              _uuids(rng, len(set_ki)), 0).astype(_I64)
        batches.append(b)
    return batches


def chunk_batches(batches, chunk_keys: int) -> list[ColumnarBatch]:
    """Interleave replicas' snapshot chunks (the arrival order of a real
    multi-peer catch-up): groups of len(batches) consecutive chunks are
    slot-aligned."""
    per_replica = [list(batch_chunks(b, chunk_keys)) for b in batches]
    out = []
    for i in range(max(len(p) for p in per_replica)):
        for p in per_replica:
            if i < len(p):
                out.append(p[i])
    return out


def replica_meta(r: int) -> NodeMeta:
    """The NODE section of replica r's snapshot file."""
    return NodeMeta(node_id=r + 1, alias=f"replica{r + 1}",
                    addr=f"127.0.0.1:{7001 + r}",
                    repl_last_uuid=((MS0 + 600_000) << SEQ_BITS) + r)


def write_replica_files(batches, directory: str,
                        chunk_keys: int) -> list[str]:
    """Each replica's batch to its own snapshot file in `directory`
    (`chunk_keys`-key chunks, zlib level 1 sections, the default
    checksum), with replica_meta(r) as its NODE section and no replica
    records.  -> the paths, in replica order."""
    paths = []
    for r, b in enumerate(batches):
        path = os.path.join(directory, f"replica{r + 1}.snapshot")
        write_snapshot_file(path, replica_meta(r), [], [b],
                            chunk_keys=chunk_keys)
        paths.append(path)
    return paths


def file_catchup(eng, store: KeySpace, paths, group: int) -> dict:
    """A catch-up from R snapshot files: one SectionDemux per file, their
    chunks interleaved chunk by chunk (the order of chunk_batches, so
    every R consecutive chunks are slot-aligned), merged with
    `eng.merge_many` in groups of `group` chunks, then `eng.flush`.
    -> {"decode_s": seconds inside the demuxes' next() (read, inflate,
    decode), "chunks": chunks merged, "metas": each file's NodeMeta,
    "records": each file's replica records}."""
    files = [open(p, "rb") for p in paths]
    try:
        demux = [SectionDemux(f) for f in files]
        live = [d.batches() for d in demux]
        decode_s = 0.0
        n_chunks = 0
        pending = []
        while live:
            still = []
            for g in live:
                t0 = time.perf_counter()
                c = next(g, None)
                decode_s += time.perf_counter() - t0
                if c is None:
                    continue
                still.append(g)
                pending.append(c)
                if len(pending) == group:
                    eng.merge_many(store, pending)
                    n_chunks += len(pending)
                    pending = []
            live = still
        if pending:
            eng.merge_many(store, pending)
            n_chunks += len(pending)
        eng.flush(store)
    finally:
        for f in files:
            f.close()
    return {"decode_s": decode_s, "chunks": n_chunks,
            "metas": [d.meta for d in demux],
            "records": [d.replica_rows for d in demux]}


def sharded_file_catchup(sks, paths, group: int, serve_eng,
                         serve_store: KeySpace) -> dict:
    """A sharded catch-up from R snapshot files into a serving store, the
    shape of a replica link's sharded snapshot apply: one SectionDemux
    (raw_batches=True) per file, their raw sections interleaved chunk by
    chunk as in file_catchup, each handed undecoded to `sks.submit_raw`
    (`sks` a ShardedKeySpace with `group` chunks a job), then
    `sks.flush()`; then each shard's export (`export_shard_batch(s,
    free=True)`) merges into `serve_store` through `serve_eng`, which is
    flushed at the end.  -> {"demux_s": seconds inside the demuxes'
    next() (read and inflate; the workers decode), "merge_s": wall from
    the first section to the end of the flush, "consolidate_s": the
    exports and their merge, "chunks": sections submitted, "shard_secs":
    sks.host_secs_per_shard() after the flush (the exports free the
    shards' engines), "metas", "records": as file_catchup}."""
    if sks.group != group:
        raise ValueError(f"the sharded store ships {sks.group}-chunk jobs, "
                         f"the catch-up asks for {group}")
    files = [open(p, "rb") for p in paths]
    try:
        t0 = time.perf_counter()
        demux = [SectionDemux(f, raw_batches=True) for f in files]
        live = [d.batches() for d in demux]
        demux_s = 0.0
        n_chunks = 0
        while live:
            still = []
            for g in live:
                t1 = time.perf_counter()
                c = next(g, None)
                demux_s += time.perf_counter() - t1
                if c is None:
                    continue
                still.append(g)
                sks.submit_raw(c)
                n_chunks += 1
            live = still
        sks.flush()
        merge_s = time.perf_counter() - t0
    finally:
        for f in files:
            f.close()
    # before the exports free the shards' engines
    shard_secs = sks.host_secs_per_shard()
    t0 = time.perf_counter()
    for s in range(sks.n_shards):
        b = sks.export_shard_batch(s, free=True)
        if b.n_rows or b.del_keys:
            serve_eng.merge_many(serve_store, [b])
    if getattr(serve_eng, "needs_flush", False):
        serve_eng.flush(serve_store)
    return {"demux_s": demux_s, "merge_s": merge_s,
            "consolidate_s": time.perf_counter() - t0, "chunks": n_chunks,
            "shard_secs": shard_secs,
            "metas": [d.meta for d in demux],
            "records": [d.replica_rows for d in demux]}


def subsample_keys(keys, n_keys: int, target: int = 100_000) -> list:
    """Key bytes of the verification subsample: every `step`-th key."""
    step = max(1, n_keys // target)
    return [keys[i] for i in range(0, n_keys, step)]


def subsample_workload(batches, n_keys: int, target: int = 100_000):
    """Deterministic per-key filter of a workload: every `step`-th key,
    with counter/element rows remapped.  Per-key merges are independent,
    so a CPU replay of the filtered batches is an exact oracle for those
    keys in the full merged store."""
    step = max(1, n_keys // target)
    keep = np.arange(0, n_keys, step)
    sub_keys = subsample_keys(batches[0].keys, n_keys, target)
    out = []
    for b in batches:
        fb = ColumnarBatch()
        fb.rows_unique_per_slot = b.rows_unique_per_slot
        fb.keys = sub_keys
        fb.key_enc = b.key_enc[keep]
        fb.key_ct = b.key_ct[keep]
        fb.key_mt = b.key_mt[keep]
        fb.key_dt = b.key_dt[keep]
        fb.key_expire = b.key_expire[keep]
        fb.reg_val = [b.reg_val[i] for i in keep.tolist()]
        fb.reg_t = b.reg_t[keep]
        fb.reg_node = b.reg_node[keep]
        cm = (b.cnt_ki % step) == 0
        fb.cnt_ki = b.cnt_ki[cm] // step
        for col in ("cnt_node", "cnt_val", "cnt_uuid", "cnt_base",
                    "cnt_base_t"):
            setattr(fb, col, getattr(b, col)[cm])
        em = (b.el_ki % step) == 0
        rows = np.nonzero(em)[0].tolist()
        fb.el_ki = b.el_ki[em] // step
        fb.el_member = [b.el_member[i] for i in rows]
        fb.el_val = [b.el_val[i] for i in rows]
        for col in ("el_add_t", "el_add_node", "el_del_t"):
            setattr(fb, col, getattr(b, col)[em])
        out.append(fb)
    return out, sub_keys


def oracle_canonical(batches, n_keys: int, target: int = 100_000) -> dict:
    """CPU-replay a deterministic ~`target`-key subsample of the workload
    through the port's CpuMergeEngine and return its canonical state."""
    sub, _sub_keys = subsample_workload(batches, n_keys, target)
    oracle = KeySpace()
    cpu = CpuMergeEngine()
    for b in sub:
        cpu.merge(oracle, b)
    return oracle.canonical()


def compare_canonical(got: dict, want: dict) -> int:
    """Mismatch count between two canonical states (the first few are
    printed to stderr)."""
    if got == want:
        return 0
    diff = [k for k in want if got.get(k) != want[k]]
    diff += [k for k in got if k not in want]
    for k in diff[:5]:
        print(f"VERIFY MISMATCH {k!r}:\n  got={got.get(k)!r}"
              f"\n  oracle={want.get(k)!r}", file=sys.stderr)
    return len(diff)


def compare_counter_sums(got: KeySpace, want: KeySpace, keys) -> int:
    """Counter keys among `keys` whose per-key sum differs (canonical()
    holds the slots, not the sums the flush maintains)."""
    bad = 0
    for k in keys:
        kid_w = want.lookup(k)
        if kid_w >= 0 and want.enc_of(kid_w) == S.ENC_COUNTER:
            kid_g = got.lookup(k)
            if kid_g < 0 or got.counter_sum(kid_g) != \
                    want.counter_sum(kid_w):
                bad += 1
    return bad


def verify_store(store: KeySpace, batches, n_keys: int,
                 target: int = 100_000) -> tuple[int, int]:
    """Oracle check of a merged store on the subsample.
    -> (keys checked, mismatches)."""
    sub_keys = subsample_keys(batches[0].keys, n_keys, target)
    want = oracle_canonical(batches, n_keys, target)
    return len(sub_keys), compare_canonical(store.canonical(keys=sub_keys),
                                            want)


# ------------------------------------------------------------ steady state

APPLY_BATCH = 512            # CONSTDB_APPLY_BATCH: frames per coalescer flush
STREAM_ORIGIN = 99           # the peer node id of the replicated stream


def _frame_bodies(n_frames: int, n_keys: int, seed: int):
    """The replicate-frame mix of bench.py make_frame_log, draw for draw
    (Python's `random` with the same seed): yields (uuid, (cmd, key,
    args...)), collection deletes (`delset`) included."""
    import random
    rng = random.Random(seed)
    for i in range(1, n_frames + 1):
        uuid = (MS0 + i) << SEQ_BITS
        k = b"%06d" % rng.randrange(n_keys)
        r = rng.random()
        if r < 0.30:
            yield uuid, (b"set", b"r" + k, b"v%08d" % i)
        elif r < 0.52:
            yield uuid, (b"cntset", b"c" + k,
                         rng.randrange(-10_000, 10_000))
        elif r < 0.72:
            yield uuid, (b"sadd", b"s" + k,
                         *(b"m%03d" % rng.randrange(64) for _ in range(4)))
        elif r < 0.80:
            yield uuid, (b"srem", b"s" + k, b"m%03d" % rng.randrange(64))
        elif r < 0.90:
            fv = []
            for f in range(5):
                fv += [b"f%02d" % rng.randrange(16), b"v%07d%d" % (i, f)]
            yield uuid, (b"hset", b"h" + k, *fv)
        elif r < 0.995:
            yield uuid, (b"hdel", b"h" + k, b"f%02d" % rng.randrange(16))
        elif r < 0.998:
            yield uuid, (b"delbytes", b"r" + k)
        else:
            yield uuid, (b"delset", b"s" + k)


def _stream_frames(n_frames: int, n_keys: int, seed: int):
    """`_frame_bodies` as [(cmd, key, args, uuid)], the collection deletes
    (`delset`) dropped: they are coalescer barriers that apply through the
    node's per-key op path, which `make_stream_workload` bypasses."""
    return [(body[0], body[1], body[2:], uuid)
            for uuid, body in _frame_bodies(n_frames, n_keys, seed)
            if body[0] != b"delset"]


_ELEM_ENC = {b"sadd": S.ENC_SET, b"srem": S.ENC_SET, b"hset": S.ENC_DICT,
             b"hdel": S.ENC_DICT}


def _stream_batch(frames) -> ColumnarBatch:
    """One coalescer flush as replica/coalesce.py BatchBuilder.finalize
    lays it out: the frames grouped by command in order of first
    appearance, each group through its COLUMNAR_ENCODERS encoder
    (server/commands.py) — one key row per frame, one counter row per
    cntset, one element row per member or field.  The flush-time
    key-delete rule (coalesce.apply_key_delete_rule) is not applied: it
    tombstones element adds older than their key's delete time, and no
    key of this stream has one (collection deletes are dropped; delbytes
    touches registers only)."""
    groups: dict = {}
    for f in frames:
        groups.setdefault(f[0], []).append(f)
    keys, enc, ct, mt, dt = [], [], [], [], []
    reg = []       # (ki, uuid, value)
    cnt = []       # (ki, node, total, uuid, base, base_t)
    el = []        # (ki, members, values or None, add_t, add_node, del_t)
    dels: dict = {}
    has_vals = False
    for cmd, recs in groups.items():
        for _c, key, args, uuid in recs:
            ki = len(keys)
            keys.append(key)
            if cmd == b"delbytes":
                enc.append(S.ENC_BYTES)
                ct.append(0)
                mt.append(uuid)
                dt.append(uuid)
                if dels.get(key, -1) < uuid:
                    dels[key] = uuid
                continue
            enc.append(S.ENC_BYTES if cmd == b"set" else
                       S.ENC_COUNTER if cmd == b"cntset" else _ELEM_ENC[cmd])
            ct.append(uuid)
            mt.append(uuid)
            dt.append(0)
            if cmd == b"set":
                reg.append((ki, uuid, args[0]))
            elif cmd == b"cntset":
                cnt.append((ki, STREAM_ORIGIN, args[0], uuid, 0,
                            S.NEUTRAL_T))
            elif cmd == b"sadd":
                el.append((ki, list(args), None, uuid, STREAM_ORIGIN, 0))
            elif cmd == b"hset":
                el.append((ki, list(args[0::2]), list(args[1::2]), uuid,
                           STREAM_ORIGIN, 0))
                has_vals = True
            else:  # srem / hdel: a del-side max on a (0, 0) add side
                el.append((ki, list(args), None, 0, 0, uuid))
    n = len(keys)
    b = ColumnarBatch()
    b.keys = keys
    b.key_enc = np.array(enc, dtype=np.int8)
    b.key_ct = np.array(ct, dtype=_I64)
    b.key_mt = np.array(mt, dtype=_I64)
    b.key_dt = np.array(dt, dtype=_I64)
    b.key_expire = np.zeros(n, dtype=_I64)
    b.reg_val = [None] * n
    b.reg_t = np.zeros(n, dtype=_I64)
    b.reg_node = np.zeros(n, dtype=_I64)
    for ki, uuid, v in reg:
        b.reg_val[ki] = v
        b.reg_t[ki] = uuid
        b.reg_node[ki] = STREAM_ORIGIN
    if cnt:
        (b.cnt_ki, b.cnt_node, b.cnt_val, b.cnt_uuid, b.cnt_base,
         b.cnt_base_t) = (np.array(c, dtype=_I64) for c in zip(*cnt))
    if el:
        counts = np.array([len(e[1]) for e in el], dtype=_I64)
        rep = lambda j: np.repeat(  # noqa: E731
            np.array([e[j] for e in el], dtype=_I64), counts)
        b.el_ki = rep(0)
        b.el_member = [m for e in el for m in e[1]]
        if has_vals:
            b.el_val = [v for e in el
                        for v in (e[2] if e[2] is not None
                                  else [None] * len(e[1]))]
        else:
            b.el_val = [None] * len(b.el_member)
            b.el_has_vals = False
        b.el_add_t = rep(3)
        b.el_add_node = rep(4)
        b.el_del_t = rep(5)
    if dels:
        b.del_keys = list(dels)
        b.del_t = np.array(list(dels.values()), dtype=_I64)
    b.rows_unique_per_slot = False
    return b


def make_stream_workload(n_frames: int = 200_000, n_keys: int = 20_000,
                         seed: int = 11,
                         batch_frames: int = APPLY_BATCH
                         ) -> list[ColumnarBatch]:
    """A peer's steady-state replication stream as the coalescer lands
    it: the frame mix of `bench.py --mode stream` (bench.py
    make_frame_log: 30% set, 22% cntset, 20% 4-member sadd, 8% srem, 10%
    5-field hset, 9.5% hdel, 0.3% delbytes over `n_keys` keys per type
    prefix, monotone HLC uuids from one origin) in flushes of
    `batch_frames` frames, each a micro ColumnarBatch with
    rows_unique_per_slot=False (see _stream_batch).  The collection
    deletes (0.2% of the frames) are left out."""
    frames = _stream_frames(n_frames, n_keys, seed)
    return [_stream_batch(frames[i:i + batch_frames])
            for i in range(0, len(frames), batch_frames)]


def make_tensor_workload(n_rounds: int, batch_rows: int, n_keys: int,
                         n_nodes: int, elems: int, strat: str,
                         seed: int = 17) -> list[ColumnarBatch]:
    """Per-round micro batches of tensor contributions, a copy of
    bench.py make_tensor_workload: round 0 seeds every (key, node) slot
    so reads always see `n_nodes` contributors (the model-merge shape),
    later rounds write `batch_rows` random slots."""
    rng = np.random.default_rng(seed)
    cfg = T.pack_config(T.TensorMeta(T.STRATEGY_IDS[strat], 0, (elems,)))
    u = 1
    out = []
    for r in range(n_rounds):
        if r == 0:
            pairs = [(k, nd) for k in range(n_keys)
                     for nd in range(1, n_nodes + 1)]
        else:
            pairs = [(int(rng.integers(n_keys)),
                      int(rng.integers(1, n_nodes + 1)))
                     for _ in range(batch_rows)]
        n = len(pairs)
        b = ColumnarBatch()
        b.keys = [b"t%06d" % k for k, _ in pairs]
        uuids = np.empty(n, dtype=_I64)
        for i in range(n):
            u += 1
            uuids[i] = (MS0 + u) << SEQ_BITS
        b.key_enc = np.full(n, S.ENC_TENSOR, np.int8)
        b.key_ct = uuids.copy()
        b.key_mt = uuids.copy()
        b.key_dt = np.zeros(n, dtype=_I64)
        b.key_expire = np.zeros(n, dtype=_I64)
        b.reg_val = [None] * n
        b.reg_t = np.zeros(n, dtype=_I64)
        b.reg_node = np.zeros(n, dtype=_I64)
        b.tns_ki = np.arange(n, dtype=_I64)
        b.tns_node = np.fromiter((nd for _, nd in pairs), dtype=_I64,
                                 count=n)
        b.tns_uuid = uuids
        b.tns_cnt = rng.integers(1, 8, size=n).astype(_I64)
        b.tns_cfg = [cfg] * n
        payloads = (rng.standard_normal((n, elems)) * 4).astype(np.float32)
        b.tns_payload = [payloads[i].tobytes() for i in range(n)]
        b.rows_unique_per_slot = False
        out.append(b)
    return out


def replay_oracle(batches) -> KeySpace:
    """The CPU oracle of a micro-batch workload: every batch replayed in
    order through the port's CpuMergeEngine into a fresh store (tensor
    reads then come from KeySpace.tensor_read)."""
    store = KeySpace()
    cpu = CpuMergeEngine()
    for b in batches:
        cpu.merge_many(store, [b])
    return store


def batch_keys(batches) -> list:
    """Distinct key bytes of a workload, in first-appearance order."""
    return list(dict.fromkeys(k for b in batches for k in b.keys))


# ------------------------------------------- replication through the node

REPLAY_CHUNK = 1 << 20       # bytes fed to the parser at a time
WIRE_RUN = 512               # frames of one drained push run (APPLY_BATCH)
WIRE_RUN_BYTES = 1 << 18     # the push loop's byte cap on a drained run
MIN_WIRE_RUN = 2             # shorter encodable runs ship per frame


def make_frame_log(n_frames: int, n_keys: int, seed: int = 11) -> list:
    """A peer's steady-state stream as REPLICATE frames (the item lists of
    `*[replicate, origin, prev_uuid, uuid, cmd, args...]`), bench.py
    make_frame_log draw for draw: the mix of `make_stream_workload` with
    the collection deletes (`delset`, 0.2%) kept, so they reach the
    coalescer as barriers."""
    from .resp.message import Bulk, Int
    frames = []
    prev = 0
    for uuid, body in _frame_bodies(n_frames, n_keys, seed):
        frames.append([Bulk(b"replicate"), Int(STREAM_ORIGIN), Int(prev),
                       Int(uuid), Bulk(body[0]),
                       *[Int(a) if isinstance(a, int) else Bulk(a)
                         for a in body[1:]]])
        prev = uuid
    return frames


def frame_log_bytes(frames) -> bytes:
    """The frames' RESP encoding, as the pull loop reads them off the
    socket (bench.py save_frame_log)."""
    from .resp.codec import encode_into
    from .resp.message import Arr
    out = bytearray()
    for items in frames:
        encode_into(out, Arr(items))
    return bytes(out)


def replay_stream(data: bytes, node, apply_batch: int, latency_s: float,
                  now=time.perf_counter, sync=None) -> tuple:
    """A peer's RESP stream through the node as the pull loop drives it
    (bench.py replay_stream): `make_parser()` fed REPLAY_CHUNK bytes at a
    time, every frame into `CoalescingApplier.apply`, then the final
    `flush()`, `node.ensure_flushed()` and `sync()` (the card's
    synchronize).  `now` is the applier's clock and the latencies'.
    Visibility latency, intake -> landed, is sampled every 64th frame
    (0.0 for a frame that landed at intake).
    -> (applier, wall seconds, latencies)."""
    from .replica.coalesce import CoalescingApplier
    from .replica.manager import ReplicaMeta
    from .resp.codec import make_parser

    applier = CoalescingApplier(node, ReplicaMeta("bench-peer:0"),
                                max_frames=apply_batch,
                                max_latency=latency_s, now=now)
    parser = make_parser()
    lat: list = []
    pending_ts: list = []
    real_land = node.merge_stream_batch

    def landing(bb, n):
        real_land(bb, n)
        t = now()
        lat.extend(t - x for x in pending_ts)
        pending_ts.clear()

    node.merge_stream_batch = landing
    try:
        i = 0
        t0 = now()
        for off in range(0, len(data), REPLAY_CHUNK):
            parser.feed(data[off:off + REPLAY_CHUNK])
            while (msg := parser.next_msg()) is not None:
                applier.apply(msg.items)
                if not i & 63:
                    if not applier.pending:
                        lat.append(0.0)
                    else:
                        pending_ts.append(now())
                i += 1
        applier.flush()
        node.ensure_flushed()
        if sync is not None:
            sync()
        end = now()
    finally:
        del node.merge_stream_batch
    lat.extend(end - t for t in pending_ts)
    return applier, end - t0, lat


def push_log(node, frames) -> None:
    """Append the frames' ops to `node`'s repl_log, as the pusher's own
    writes put them there (their uuids, names and arguments)."""
    from .resp.message import as_bytes, as_int
    for items in frames:
        node.repl_log.push(as_int(items[3]), as_bytes(items[4]),
                           list(items[5:]))


def wire_frames(pusher, run_frames: int = WIRE_RUN) -> tuple:
    """The pusher's repl_log as its push loop ships it to a batching
    peer (the split of replica/link.py `_encode_wire_run`): runs drained
    `run_frames` entries (at most WIRE_RUN_BYTES) at a time; in each,
    maximal sub-runs of at least MIN_WIRE_RUN encodable ops become
    REPLBATCH frames (`build_wire_batch`), every other op a REPLICATE
    frame.  -> (frames, stats: payload bytes, batches, frames sent in
    batches and singly)."""
    from .replica import wire
    from .resp.message import Bulk, Int
    from .server.commands import COLUMNAR_ENCODERS

    nid = pusher.node_id
    enc_has = COLUMNAR_ENCODERS.__contains__
    out = []
    st = {"payload_bytes": 0, "batches": 0, "batch_frames": 0,
          "single_frames": 0}
    cursor = 0
    while True:
        run = pusher.repl_log.run_after(cursor, run_frames, WIRE_RUN_BYTES)
        if not run:
            break
        i, n = 0, len(run)
        while i < n:
            j = i
            while j < n and enc_has(run[j].name):
                j += 1
            if j - i >= MIN_WIRE_RUN:
                sub = run[i:j]
                payload = wire.build_wire_batch(sub, nid)
                if payload is None:
                    raise RuntimeError(f"the wire codec declined a run of "
                                       f"{len(sub)} encodable ops")
                out.append([Bulk(b"replbatch"), Int(nid),
                            Int(sub[0].prev_uuid), Int(sub[-1].uuid),
                            Int(len(sub)), Bulk(payload)])
                st["payload_bytes"] += len(payload)
                st["batches"] += 1
                st["batch_frames"] += len(sub)
                i = j
                continue
            stop = j if j > i else i + 1
            for e in run[i:stop]:
                out.append([Bulk(b"replicate"), Int(nid), Int(e.prev_uuid),
                            Int(e.uuid), Bulk(e.name), *e.args])
            st["single_frames"] += stop - i
            i = stop
        cursor = run[-1].uuid
    return out, st


def wire_replay(frames, node, sync=None) -> tuple:
    """`wire_frames`' output into `node` through one CoalescingApplier
    (APPLY_BATCH frames):
    REPLBATCH frames through `apply_wire_batch`, REPLICATE frames through
    `apply`, then `flush()`, `ensure_flushed()` and `sync()`.  The
    payloads' decode (`wire.decode_wire_batch`) is timed apart.
    -> (applier, wall seconds, decode seconds)."""
    from .replica import wire
    from .replica.coalesce import CoalescingApplier
    from .replica.manager import ReplicaMeta

    applier = CoalescingApplier(node, ReplicaMeta("wire-peer:0"),
                                max_frames=APPLY_BATCH, max_latency=1e9)
    decode = wire.decode_wire_batch
    spent = [0.0]

    def timed_decode(*a, **kw):
        t = time.perf_counter()
        try:
            return decode(*a, **kw)
        finally:
            spent[0] += time.perf_counter() - t

    wire.decode_wire_batch = timed_decode
    try:
        t0 = time.perf_counter()
        for items in frames:
            if items[0].val == b"replbatch":
                applier.apply_wire_batch(items)
            else:
                applier.apply(items)
        applier.flush()
        node.ensure_flushed()
        if sync is not None:
            sync()
        wall = time.perf_counter() - t0
    finally:
        wire.decode_wire_batch = decode
    return applier, wall, spent[0]


def tensor_peer_frames(n_peers: int, n_rounds: int, n_keys: int,
                       elems: int, seed: int = 17) -> list:
    """Tensor contributions from `n_peers` peers as each one's REPLICATE
    stream of `tset` frames (origin = peer id 1..n_peers): every round
    each peer writes every key once, `elems` f32 from a seeded normal
    draw, a count in [1, 8).  Key k's strategy is the k-th of
    sum, maxmag, trimmed-mean, avg and lww, in turn.
    -> [per peer: [per round: [frame items]]]."""
    from .resp.message import Bulk, Int
    rng = np.random.default_rng(seed)
    strats = ("sum", "maxmag", "trimmed-mean", "avg", "lww")
    cfgs = [T.pack_config(T.TensorMeta(T.STRATEGY_IDS[strats[k % 5]], 0,
                                       (elems,)))
            for k in range(n_keys)]
    out = [[] for _ in range(n_peers)]
    prev = [0] * n_peers
    u = 0
    for _r in range(n_rounds):
        for p in range(n_peers):
            pay = (rng.standard_normal((n_keys, elems)) * 4).astype(
                np.float32)
            cnt = rng.integers(1, 8, size=n_keys)
            rnd = []
            for k in range(n_keys):
                u += 1
                uuid = (MS0 + u) << SEQ_BITS
                rnd.append([Bulk(b"replicate"), Int(p + 1), Int(prev[p]),
                            Int(uuid), Bulk(b"tset"), Bulk(b"t%06d" % k),
                            Bulk(cfgs[k]), Int(int(cnt[k])),
                            Bulk(pay[k].tobytes())])
                prev[p] = uuid
            out[p].append(rnd)
    return out
