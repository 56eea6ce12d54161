"""The port's multi-device merge on the CPU, against the reference's.

* The rep x kv step (constdb_tpu_torch/parallel/sharded.py) over a gloo
  world of 8 ranks, at rep 1, 2, 4 and 8, is bit-equal to the
  reference's sharded_merge_step on its 8-device virtual CPU mesh
  (tests/conftest.py) and to the reference's dense ops, WIN and the
  touched count included; every rep runs in ONE spawned world.
* TorchMergeEngine(devices=...), the kv range-partitioned engine, is
  canonical()- and sum-equal to the reference's mesh engine and to the
  CPU engine: twins of the reference's mesh tests, plus a counter key
  whose slots straddle a partition boundary and a growth that moves the
  boundaries.
* entry() and dryrun_multichip() on the CPU.
"""

import jax
import numpy as np
import pytest

import bench
from constdb_tpu.crdt import ENC_COUNTER
from constdb_tpu.engine import CpuMergeEngine, batch_from_keyspace
from constdb_tpu.engine.tpu import TpuMergeEngine
from constdb_tpu.ops import dense as RD
from constdb_tpu.ops.segment import NEUTRAL_T
from constdb_tpu.parallel import engine_mesh as ref_engine_mesh
from constdb_tpu.parallel import make_mesh as ref_make_mesh
from constdb_tpu.parallel import shard_batch_arrays as ref_shard
from constdb_tpu.parallel import sharded_merge_step as ref_step
from constdb_tpu.persist.snapshot import batch_chunks
from constdb_tpu.store import KeySpace
from constdb_tpu_torch import convert
from constdb_tpu_torch import workload as W
from constdb_tpu_torch.engine.cpu import CpuMergeEngine as PortCpuEngine
from constdb_tpu_torch.engine.cuda import TorchMergeEngine
from constdb_tpu_torch.entry import (_example_arrays, dryrun_multichip,
                                     entry, gather_step)
from constdb_tpu_torch.parallel import engine_mesh
from constdb_tpu_torch.parallel.sharded import run_world
from constdb_tpu_torch.store.keyspace import KeySpace as PortKeySpace

import torch_mesh_rank as MR
from test_merge_properties import gen_store

NAMES = ("V", "T", "AT", "AN", "DT", "WIN", "ENV")


def _need_ref_mesh():
    if len(jax.devices()) < 8:
        pytest.fail("the reference's 8-device virtual CPU mesh is missing "
                    "(tests/conftest.py sets it up)")


@pytest.fixture(scope="module")
def port_world():
    """Every case's gathered result from one 8-rank gloo world."""
    ranks = run_world(8, MR.mesh_cases, (), device="cpu", timeout=300)
    cases = {}
    for key in ranks[0]:
        per_rank = [r[key] for r in ranks]
        cases[key] = (gather_step(per_rank), per_rank)
    return cases


def _ref_step(rep, arrays):
    _need_ref_mesh()
    mesh = ref_make_mesh(8, rep=rep)
    out = jax.device_get(ref_step(mesh)(*ref_shard(mesh, *arrays)))
    return [np.asarray(x) for x in out[:7]] + [int(out[7])]


def _same(got, want, label):
    assert got.dtype == want.dtype and got.shape == want.shape, label
    np.testing.assert_array_equal(got, want, err_msg=label)


@pytest.mark.parametrize("rep,seed", MR.REP_SEEDS)
def test_step_matches_reference_step(port_world, rep, seed):
    """Bit-equal to the reference's shard_map step at the same rep."""
    got = port_world[("rep", rep)][0]
    want = _ref_step(rep, MR.case_arrays(seed))
    for name, g, w in zip(NAMES, got, want):
        _same(g, w.astype(np.int64), f"rep={rep} {name}")
    assert got[7] == want[7]


@pytest.mark.parametrize("rep,seed", MR.REP_SEEDS)
def test_step_matches_single_device_dense_ops(port_world, rep, seed):
    """Bit-equal to the reference's single-device dense ops (the twin of
    test_matches_single_device), WIN and touched included."""
    vals, ts, at, an, dt, env = MR.case_arrays(seed)
    V, T, AT, AN, DT, WIN, ENV, touched = port_world[("rep", rep)][0]
    v1, t1 = jax.device_get(RD.dense_merge_counters(vals, ts))
    a1, n1, d1, w1 = jax.device_get(RD.dense_merge_elems(at, an, dt))
    e1 = jax.device_get(RD.dense_max(env))
    for name, g, w in zip(NAMES, (V, T, AT, AN, DT, WIN, ENV),
                          (v1, t1, a1, n1, d1, w1, e1)):
        _same(g, np.asarray(w).astype(np.int64), f"rep={rep} {name}")
    assert touched == int(np.sum(t1 > NEUTRAL_T))


def test_row0_wins_ties_across_rep_shards(port_world):
    """The local row (global row 0) wins exact (t, node) ties even when
    the tying replica row lives on another rep shard."""
    got = port_world[("tie", 4)][0]
    assert (got[5] == 0).all()
    want = _ref_step(4, MR.tie_arrays())
    for name, g, w in zip(NAMES, got, want):
        _same(g, w.astype(np.int64), f"tie {name}")


def test_ranks_of_a_column_agree_and_collectives_count(port_world):
    """gather_step checked that every rank of a mesh column holds the
    same slice; each rank issues nine all-reduces per step (T, V, AT, AN,
    DT, WIN, ENV, and the touched count's max and sum)."""
    for key, (_, per_rank) in port_world.items():
        assert len(per_rank) == 8
        assert all(r["all_reduces"] == 9 for r in per_rank), key
        kv = 8 // key[1]
        assert sorted((r["rep_idx"], r["kv_idx"]) for r in per_rank) == \
            [(i, j) for i in range(key[1]) for j in range(kv)]


def test_example_arrays_match_reference():
    from __graft_entry__ import _example_arrays as ref_arrays
    for R, S, seed in ((8, 1024, 0), (4, 64, 1), (8, 256, 7)):
        for a, b in zip(_example_arrays(R, S, seed), ref_arrays(R, S, seed)):
            _same(a, b, f"{R}x{S}")


# ------------------------------------------- the kv range-partitioned engine

def both_sums(ks):
    return {k: ks.counter_sum(kid) for kid, k in enumerate(ks.key_bytes)
            if ks.enc_of(kid) == ENC_COUNTER}


def port_batch(b):
    return convert.batch_from_dict(
        {f: getattr(b, f) for f in convert.BATCH_FIELDS})


@pytest.mark.parametrize("resident", [False, True])
@pytest.mark.parametrize("seed", range(4))
def test_partitioned_engine_matches_mesh_engine_and_cpu(resident, seed):
    """Twin of test_mesh_engine_matches_cpu: streamed chunked catch-up of
    three writers into the engine over 8 partitions equals the
    reference's engine on engine_mesh(8) and the CPU engine."""
    _need_ref_mesh()
    srcs = [gen_store(seed * 10 + i, node=i + 1) for i in range(3)]
    chunks = [c for src in srcs
              for c in batch_chunks(batch_from_keyspace(src), 37)]
    a = KeySpace()
    cpu = CpuMergeEngine()
    for c in chunks:
        cpu.merge(a, c)
    m = KeySpace()
    ref = TpuMergeEngine(resident=resident, mesh=ref_engine_mesh(8))
    for c in chunks:
        ref.merge(m, c)
    if ref.needs_flush:
        ref.flush(m)
    b = PortKeySpace()
    eng = TorchMergeEngine(resident=resident,
                           devices=engine_mesh(8, device="cpu"))
    for c in chunks:
        eng.merge(b, port_batch(c))
    if eng.needs_flush:
        eng.flush(b)
    eng.close()
    assert a.canonical() == m.canonical() == b.canonical()
    assert both_sums(a) == both_sums(m) == both_sums(b)


def test_partitioned_engine_state_is_partitioned():
    """Twin of test_mesh_engine_state_is_sharded: every resident column
    is 8 tensors, partition k holding its own contiguous range of the
    padded plane on its device, and the host holds what the card does."""
    src = gen_store(2, node=1, n_ops=400)
    b = PortKeySpace()
    devs = engine_mesh(8, device="cpu")
    eng = TorchMergeEngine(resident=True, devices=devs)
    eng.merge(b, port_batch(batch_from_keyspace(src)))
    assert eng._res, "resident state missing"
    for fam, res in eng._res.items():
        cap = res["cap"]
        assert cap % 8 == 0 and cap >= res["n"]
        for name, parts in res["cols"].items():
            assert isinstance(parts, list) and len(parts) == 8, \
                f"{fam}.{name} not partitioned"
            assert [p.shape[0] for p in parts] == [cap // 8] * 8
            assert all(p.device == d for p, d in zip(parts, devs))
    eng.flush(b)
    cpu_store = PortKeySpace()
    PortCpuEngine().merge(cpu_store, port_batch(batch_from_keyspace(src)))
    assert b.canonical() == cpu_store.canonical()


def test_non_pow2_partitions():
    """Twin of test_non_pow2_mesh_engine: 6 partitions pad the planes to
    a multiple of 6, not just a power of two."""
    src = gen_store(5, node=1)
    st = PortKeySpace()
    eng = TorchMergeEngine(resident=True, devices=engine_mesh(6, "cpu"))
    eng.merge(st, port_batch(batch_from_keyspace(src)))
    for res in eng._res.values():
        assert res["cap"] % 6 == 0
    eng.flush(st)
    cpu_store = KeySpace()
    CpuMergeEngine().merge(cpu_store, batch_from_keyspace(src))
    assert st.canonical() == cpu_store.canonical()
    assert both_sums(st) == both_sums(cpu_store)


def test_partitioned_engine_device_iota_idx():
    """Twin of test_kv_sharded_engine_device_iota_idx: the idx derived on
    the device (IDX_IOTA_MIN = 1) per partition, from partition-local
    rows, canonical()-equal to the CPU engine."""
    batches = bench.make_workload(3000, 4, seed=41)
    eng = TorchMergeEngine(resident=True, devices=engine_mesh(8, "cpu"))
    eng.IDX_IOTA_MIN = 1
    st = PortKeySpace()
    eng.merge_many(st, [port_batch(b) for b in batches])
    eng.flush(st)
    oracle = KeySpace()
    cpu = CpuMergeEngine()
    for b in batches:
        cpu.merge(oracle, b)
    assert st.canonical() == oracle.canonical()
    assert both_sums(st) == both_sums(oracle)


@pytest.mark.parametrize("fold", ["cuda", "eager", "auto"])
def test_counter_key_straddling_a_partition_boundary(fold):
    """Three writers' aligned counter slots (R = 3 rows a key) over two
    partitions: the cnt plane's boundary (a power of two) cuts a key's
    rows, the per-partition K4 sums add up across it, and every family
    still equals the CPU oracle.  "cuda" runs the kernel wrappers (their
    plain versions on CPU tensors): K1, K2 and K4 are called for both
    partitions."""
    batches = W.make_workload(200, 3, seed=3, aligned_counters=True)
    chunks = W.chunk_batches(batches, 64)
    eng = TorchMergeEngine(resident=True, dense_fold=fold,
                           devices=engine_mesh(2, "cpu"))
    st = PortKeySpace()
    for i in range(0, len(chunks), 3):
        eng.merge_many(st, chunks[i:i + 3])
    eng.flush(st)
    cap = eng._res["cnt"]["cap"]
    p = cap // 2
    kid = st.cnt.kid[:st.cnt.n]
    straddle = set(kid[:p].tolist()) & set(kid[p:].tolist())
    assert straddle, "no counter key straddles the boundary"
    oracle = PortKeySpace()
    cpu = PortCpuEngine()
    for b in batches:
        cpu.merge(oracle, b)
    assert st.canonical() == oracle.canonical()
    for k in straddle:
        assert st.counter_sum(k) == oracle.counter_sum(k)
    assert both_sums(st) == both_sums(oracle)
    if fold == "cuda":
        for calls in eng.partition_launches:
            assert calls["segment_sum"] >= 1
            assert calls["merge_counters"] >= 2
            assert calls["merge_elems"] >= 1


@pytest.mark.parametrize("resident", [True, False])
def test_growth_moves_the_boundaries(resident):
    """A catch-up that grows every plane several times over 4 partitions:
    each growth re-splits the columns (the boundaries move with data on
    both sides), a flush in the middle lands, and the end state equals
    the CPU oracle."""
    batches = W.make_workload(3000, 2, seed=5)
    chunks = W.chunk_batches(batches, 256)
    eng = TorchMergeEngine(resident=resident, dense_fold="cuda",
                           devices=engine_mesh(4, "cpu"))
    st = PortKeySpace()
    caps: dict = {}
    for i in range(0, len(chunks), 2):
        eng.merge_many(st, chunks[i:i + 2])
        if resident:
            for fam, res in eng._res.items():
                caps.setdefault(fam, set()).add(res["cap"])
            for res in eng._res.values():
                for parts in res["cols"].values():
                    assert [x.shape[0] for x in parts] == \
                        [res["cap"] // 4] * 4
        if i == len(chunks) // 2 and eng.needs_flush:
            eng.flush(st)
    if eng.needs_flush:
        eng.flush(st)
    if resident:
        assert max(len(c) for c in caps.values()) >= 3
        assert eng.resplits >= 3
    oracle = PortKeySpace()
    cpu = PortCpuEngine()
    for b in batches:
        cpu.merge(oracle, b)
    assert st.canonical() == oracle.canonical()
    assert both_sums(st) == both_sums(oracle)


def test_single_partition_launches_like_one_device(monkeypatch):
    """devices=[one] calls the kernel wrappers exactly as devices=None
    does (same wrappers, same shapes) and lands the same state."""
    from constdb_tpu_torch.ops import kernels as KN
    batches = W.make_workload(2000, 3, seed=9, aligned_counters=True)
    chunks = W.chunk_batches(batches, 512)
    calls = {}
    for label, kw in (("one", {"device": "cpu"}),
                      ("part", {"devices": ["cpu"]})):
        log = []
        for name in ("fold_apply", "merge_counters", "segment_sum"):
            real = getattr(KN, name)

            def wrap(*a, _real=real, _name=name, **k):
                log.append((_name, tuple(a[0].shape), tuple(a[1].shape)))
                return _real(*a, **k)
            monkeypatch.setattr(KN, name, wrap)
        eng = TorchMergeEngine(resident=True, dense_fold="cuda", **kw)
        st = PortKeySpace()
        for i in range(0, len(chunks), 3):
            eng.merge_many(st, chunks[i:i + 3])
        eng.flush(st)
        monkeypatch.undo()
        calls[label] = (log, st.canonical(), both_sums(st))
    assert calls["one"][0] and calls["one"] == calls["part"]


# ------------------------------------------------------------ entry twins

def test_entry_matches_reference_entry():
    """entry(device="cpu"): the port's dense step on the reference
    entry()'s example arrays gives the reference entry's outputs."""
    import __graft_entry__ as G
    ref_fn, ref_args = G.entry()
    want = [np.asarray(x) for x in jax.jit(ref_fn)(*ref_args)]
    fn, args = entry(device="cpu")
    for a, b in zip(args, ref_args):
        _same(a.numpy(), np.asarray(b), "example args")
    got = [t.numpy() for t in fn(*args)]
    for name, g, w in zip(("v", "t", "a", "n", "d", "win", "e"), got, want):
        _same(g, w.astype(np.int64), name)


def test_dryrun_multichip_on_cpu():
    out = dryrun_multichip(8, device="cpu")
    assert out["n"] == 8 and out["rep"] == 2 and out["kv"] == 4
    assert out["all_reduces"] == 8 * 9
    assert out["engine_keys"] > 0
