"""The port's hash-sharded catch-up against the reference's.

The same seeded chunk stream (bench.make_workload / chunk_batches for the
reference, the port's copy of them for the port, with key-level delete
tombstones on the first chunk) goes through the reference package's
store/sharded_keyspace.py and the port's: equal shard ids, equal
extracted sub-batches, and canonical() equal to the reference's
ShardedKeySpace and to a plain port engine in every mode (one shard,
"local" with 4 shards, "process" with 2 workers) and engine spec ("cpu",
and "cuda" on device="cpu" with dense_fold "auto" and "cuda"), with
every shard's state byte-equal to the same engine over the same split.
Then load_snapshot into a sharded store, consolidate_into, the streamed
export_shard_batch(free=True), worker errors reaching the parent, and
no shared-memory segment left behind.  The leak checks count only the
segment names the pool itself created or was handed (`shm_names`), never
all of /dev/shm, where other test processes' pools come and go.
"""

import os
import signal

import numpy as np
import pytest

import bench
from constdb_tpu.engine.cpu import CpuMergeEngine as RefCpuEngine
from constdb_tpu.persist.snapshot import NodeMeta, dump_keyspace
from constdb_tpu.store import sharded_keyspace as RSK
from constdb_tpu.store.keyspace import KeySpace as RefKeySpace
from constdb_tpu_torch import workload
from constdb_tpu_torch.engine.cpu import CpuMergeEngine
from constdb_tpu_torch.engine.cuda import TorchMergeEngine
from constdb_tpu_torch.parallel.host_pool import HostShardPool
from constdb_tpu_torch.persist.snapshot import _encode_batch, load_snapshot
from constdb_tpu_torch.store import sharded_keyspace as PSK
from constdb_tpu_torch.store.keyspace import KeySpace

from test_merge_properties import gen_store

_I64 = np.int64
N_KEYS, N_REP, CHUNK, GROUP = 420, 3, 120, 4


def _with_dels(chunks, n_keys):
    dels = [b"k%010d" % i for i in range(0, n_keys, 37)]
    chunks[0].del_keys = dels
    chunks[0].del_t = np.arange(1, len(dels) + 1, dtype=_I64) + (1 << 30)
    return chunks


def _ref_chunks(n_keys=N_KEYS, n_rep=N_REP, chunk=CHUNK):
    return _with_dels(bench.chunk_batches(
        bench.make_workload(n_keys, n_rep, seed=13), chunk), n_keys)


def _port_chunks(n_keys=N_KEYS, n_rep=N_REP, chunk=CHUNK):
    return _with_dels(workload.chunk_batches(
        workload.make_workload(n_keys, n_rep, seed=13), chunk), n_keys)


def _split(chunks, n_shards):
    out = [[] for _ in range(n_shards)]
    for c in chunks:
        sids = PSK.shard_ids(c.keys, n_shards)
        dsids = PSK.shard_ids(c.del_keys, n_shards) if c.del_keys else None
        for s in range(n_shards):
            sub = PSK.extract_shard(c, sids, dsids, s)
            if sub.n_rows or sub.del_keys:
                out[s].append(sub)
    return out


def _leaked(names) -> set:
    return {n for n in names if os.path.exists(f"/dev/shm/{n}")}


def _fresh(spec, fold):
    if spec == "cpu":
        return CpuMergeEngine()
    return TorchMergeEngine(resident=True, dense_fold=fold, device="cpu")


# ------------------------------------------------------------------ split


def test_shard_ids_equal_reference():
    keys = [b"k%06d" % i for i in range(500)] + [b"", b"\xff" * 40] + \
        [bytes(np.random.default_rng(3).integers(0, 256, 17, np.uint8))]
    for n in (1, 2, 5, 64):
        got = PSK.shard_ids(keys, n)
        assert got.dtype == np.uint8
        assert np.array_equal(got, RSK.shard_ids(keys, n))
        assert [PSK.shard_of(k, n) for k in keys] == got.tolist()


def test_extract_shard_equals_reference():
    rc, pc = _ref_chunks(300, 2, 300), _port_chunks(300, 2, 300)
    for r, p in zip(rc, pc):
        for n in (2, 3):
            sids = PSK.shard_ids(p.keys, n)
            dsids = PSK.shard_ids(p.del_keys, n) if p.del_keys else None
            for s in range(n):
                want = RSK.extract_shard(r, sids, dsids, s)
                got = PSK.extract_shard(p, sids, dsids, s)
                assert got.keys == want.keys
                assert got.del_keys == want.del_keys
                for f in ("key_enc", "key_ct", "key_mt", "key_dt",
                          "key_expire", "reg_t", "reg_node", "cnt_ki",
                          "cnt_node", "cnt_val", "cnt_uuid", "cnt_base",
                          "cnt_base_t", "el_ki", "el_add_t", "el_add_node",
                          "el_del_t", "del_t"):
                    assert np.array_equal(np.asarray(getattr(got, f)),
                                          np.asarray(getattr(want, f))), f
                for f in ("reg_val", "el_member", "el_val"):
                    assert list(getattr(got, f)) == \
                        list(getattr(want, f)), f
                assert all(PSK.shard_of(k, n) == s for k in got.keys)
    with pytest.raises(ValueError, match="del_keys"):
        PSK.extract_shard(pc[0], PSK.shard_ids(pc[0].keys, 2), None, 0)


def test_default_shards(monkeypatch):
    monkeypatch.setenv("CONSTDB_TORCH_SHARDS", "3")
    assert PSK.default_shards() == 3
    monkeypatch.setenv("CONSTDB_TORCH_SHARDS", "9999")
    assert PSK.default_shards() == PSK.MAX_SHARDS
    monkeypatch.delenv("CONSTDB_TORCH_SHARDS")
    monkeypatch.setattr("os.cpu_count", lambda: 2)
    assert PSK.default_shards() == 1
    monkeypatch.setattr("os.cpu_count", lambda: 8)
    assert PSK.default_shards() == 8


# ------------------------------------------- canonical in every mode, spec

# (n_shards, mode, engine spec, dense_fold)
CASES = [(n, mode, spec, fold)
         for n, mode in ((1, "local"), (4, "local"), (2, "process"))
         for spec, fold in (("cpu", "auto"), ("cuda", "auto"),
                            ("cuda", "cuda"))]


@pytest.mark.parametrize("n,mode,spec,fold", CASES,
                         ids=[f"{m}{n}-{s}-{f}" for n, m, s, f in CASES])
def test_sharded_canonical_equals_reference(n, mode, spec, fold):
    """In-process shards also hold their resident engines to the hooks:
    needs_flush until flush(), and a freed shard's engine forgets its
    mirrors without a flush."""
    chunks = _port_chunks()
    sks = PSK.ShardedKeySpace(n_shards=n, mode=mode, engine_spec=spec,
                              group=GROUP, dense_fold=fold, device="cpu")
    resident = mode == "local" and spec == "cuda"
    try:
        for c in chunks:
            sks.submit(c)
        sks.barrier()
        if resident:
            assert len(sks.engines) == n
            assert all(e.needs_flush for e in sks.engines)
        sks.flush()
        assert not any(getattr(e, "needs_flush", False)
                       for e in sks.engines)
        got = sks.canonical()
        states = sks.state_bytes_per_shard()
        secs = sks.host_secs_per_shard()
        some = [b"k%010d" % i for i in range(0, N_KEYS, 11)]
        routed = sks.canonical(keys=some)
        if resident:
            sks.submit(chunks[0])
            sks.barrier()
            s0 = PSK.shard_of(chunks[0].keys[0], n)
            assert sks.engines[s0].needs_flush
            sks.export_shard_batch(s0, free=True)
            assert not sks.engines[s0].needs_flush
            assert sks.engines[s0]._res == {}
            assert sks.stores[s0].canonical() == {}
    finally:
        sks.close()
    assert len(states) == len(secs) == n

    ref = RSK.ShardedKeySpace(n_shards=n, mode=mode, engine_spec="cpu",
                              engine_factory=RefCpuEngine, group=GROUP)
    try:
        for c in _ref_chunks():
            ref.submit(c)
        assert got == ref.canonical()
    finally:
        ref.close()

    plain = KeySpace()
    eng = _fresh(spec, fold)
    for i in range(0, len(chunks), GROUP):
        eng.merge_many(plain, chunks[i:i + GROUP])
    if eng.needs_flush:
        eng.flush(plain)
    assert got == plain.canonical()
    assert routed == {k: v for k, v in got.items() if k in set(some)}

    # every shard byte-equal to the same engine over the same split, in
    # the same group cadence
    if n == 1:
        assert states[0] == PSK.keyspace_state_bytes(plain)
        return
    split = [[] for _ in range(n)]
    for i in range(0, len(chunks), GROUP):
        for s, subs in enumerate(_split(chunks[i:i + GROUP], n)):
            if subs:
                split[s].append(subs)
    for s in range(n):
        ks, eng = KeySpace(), _fresh(spec, fold)
        for subs in split[s]:
            eng.merge_many(ks, subs)
        if eng.needs_flush:
            eng.flush(ks)
        assert states[s] == PSK.keyspace_state_bytes(ks), f"shard {s}"


# ------------------------------------------------ snapshot, consolidation


@pytest.mark.parametrize("spec", ["cpu", "cuda"])
def test_load_snapshot_into_sharded_store(spec, tmp_path):
    """load_snapshot fans the raw sections of a reference-written file
    out to the workers, which decode and hash them."""
    src = gen_store(seed=31, node=5)
    path = str(tmp_path / "src.snapshot")
    dump_keyspace(path, src, NodeMeta(node_id=5), chunk_keys=64)
    sks = PSK.ShardedKeySpace(n_shards=2, mode="process", engine_spec=spec,
                              group=3, device="cpu")
    try:
        meta, _records = load_snapshot(path, sks)
        assert meta.node_id == 5
        assert sks.canonical() == src.canonical()
    finally:
        sks.close()
    assert not _leaked(sks.pool.shm_names)


def _ref_state(chunks):
    ks = RefKeySpace()
    eng = RefCpuEngine()
    for c in chunks:
        eng.merge(ks, c)
    return ks


@pytest.mark.parametrize("n,mode", [(1, "local"), (2, "local"),
                                    (2, "process")])
def test_consolidate_into_serving_store(n, mode):
    """Shard exports merge back into one serving keyspace through a
    resident engine, tombstones included: whole (consolidate_into) and
    streamed shard by shard with free=True, which empties each shard."""
    chunks = _port_chunks()
    ref = _ref_state(_ref_chunks())
    empty = PSK.keyspace_state_bytes(KeySpace())
    sks = PSK.ShardedKeySpace(n_shards=n, mode=mode, engine_spec="cuda",
                              group=GROUP, device="cpu")
    try:
        for c in chunks:
            sks.submit(c)
        sks.flush()
        whole = KeySpace()
        eng = TorchMergeEngine(resident=True, device="cpu")
        sks.consolidate_into(whole, eng)
        eng.flush(whole)
        eng.close()
        assert whole.canonical() == ref.canonical()
        assert whole.key_deletes == ref.key_deletes

        # a resident engine serves one store: a fresh one for the next
        streamed = KeySpace()
        eng = TorchMergeEngine(resident=True, device="cpu")
        for s in range(sks.n_shards):
            b = sks.export_shard_batch(s, free=True)
            eng.merge_many(streamed, [b])
            assert sks.state_bytes_per_shard()[s] == empty
        eng.flush(streamed)
        eng.close()
        assert streamed.canonical() == ref.canonical()
        assert streamed.key_deletes == ref.key_deletes
        assert sks.canonical() == {}
    finally:
        sks.close()


def test_sharded_file_catchup(tmp_path):
    """workload.sharded_file_catchup: R replica files, raw sections to
    the workers, then consolidation into a serving store, equal to the
    plain file catch-up."""
    batches = workload.make_workload(600, 3, seed=5, aligned_counters=True)
    paths = workload.write_replica_files(batches, str(tmp_path), 200)
    sks = PSK.ShardedKeySpace(n_shards=2, mode="process", engine_spec="cuda",
                              group=3, dense_fold="cuda", device="cpu")
    serve, eng = KeySpace(), TorchMergeEngine(resident=True, device="cpu")
    try:
        out = workload.sharded_file_catchup(sks, paths, 3, eng, serve)
    finally:
        sks.close()
    assert out["chunks"] == 9
    assert out["metas"] == [workload.replica_meta(r) for r in range(3)]
    assert 0 <= out["demux_s"] <= out["merge_s"]
    # R-aligned inside each shard: every worker folded
    assert all(s["folds"] for s in out["shard_secs"])
    plain, eng2 = KeySpace(), TorchMergeEngine(resident=True, device="cpu")
    workload.file_catchup(eng2, plain, paths, 3)
    assert serve.canonical() == plain.canonical()
    assert workload.verify_store(serve, batches, 600)[1] == 0
    with pytest.raises(ValueError, match="chunk jobs"):
        workload.sharded_file_catchup(sks, paths, 4, eng, serve)


# ---------------------------------------------------------------- errors


def test_pool_worker_error_propagates():
    pool = HostShardPool(1, engine_spec="cpu")
    try:
        with pytest.raises(RuntimeError, match="shard worker 0"):
            pool.submit_group([], [(b"garbage-not-a-batch",
                                    None, None, None, -1, -1)])
            pool.barrier()
    finally:
        pool.close()
    assert not _leaked(pool.shm_names)


def test_cuda_spec_without_a_card_raises(monkeypatch):
    """A CUDA spec on no card raises before any worker starts; unknown
    specs raise too."""
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for mode, n in (("process", 2), ("local", 2), ("local", 1)):
        with pytest.raises(RuntimeError, match="CUDA"):
            PSK.ShardedKeySpace(n_shards=n, mode=mode, engine_spec="cuda")
    with pytest.raises(ValueError, match="spec"):
        HostShardPool(1, engine_spec="tpu")


# ------------------------------------------------------- shared memory


def _raw_entries(chunks):
    return [(bytes(_encode_batch(c)), None, None, None, -1, -1)
            for c in chunks]


def _leak_chunks():
    return workload.chunk_batches(workload.make_workload(240, 2, seed=7), 80)


def test_no_leak_after_normal_completion():
    sks = PSK.ShardedKeySpace(n_shards=2, mode="process", engine_spec="cpu",
                              group=3)
    try:
        for c in _leak_chunks():
            sks.submit(c)
        sks.flush()
        assert sks.canonical()  # the merge actually happened
        sks.export_batches()
    finally:
        sks.close()
    names = sks.pool.shm_names
    assert len(names) >= 2 + 2   # the jobs' segments and two exports
    assert not _leaked(names), "leaked /dev/shm segments"


def test_no_leak_after_worker_crash_mid_job():
    """SIGKILL a worker while groups are in flight: the parent's reap
    surfaces the dead pipe as an error and close() still unlinks every
    job segment."""
    pool = HostShardPool(2, engine_spec="cpu")
    try:
        entries = _raw_entries(_leak_chunks())
        pool.submit_group([], entries[:2])
        os.kill(pool._procs[1].pid, signal.SIGKILL)
        with pytest.raises((EOFError, OSError, RuntimeError)):
            for _ in range(20):
                pool.submit_group([], entries[2:4])
                pool.barrier()
    finally:
        pool.close()
    assert pool.shm_names
    assert not _leaked(pool.shm_names), "leaked /dev/shm segments"


def test_no_leak_on_shutdown_with_jobs_in_flight():
    sks = PSK.ShardedKeySpace(n_shards=2, mode="process", engine_spec="cpu",
                              group=1)   # every submit ships a segment
    for c in _leak_chunks():
        sks.submit(c)
    sks.close()   # no barrier, no flush: jobs still in flight
    assert len(sks.pool.shm_names) == len(_leak_chunks())
    assert not _leaked(sks.pool.shm_names), "leaked /dev/shm segments"


def test_submit_group_guard_frees_segment_on_failure():
    """A failure while populating a segment (a str has a len() but is
    not a buffer) closes and unlinks it."""
    pool = HostShardPool(1, engine_spec="cpu")
    try:
        with pytest.raises(TypeError):
            pool.submit_group([], [("x" * 64, None, None, None, -1, -1)])
    finally:
        pool.close()
    assert len(pool.shm_names) == 1
    assert not _leaked(pool.shm_names), "leaked /dev/shm segments"
