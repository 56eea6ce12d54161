"""The port's tensor registers on the steady path (resident payload pools,
device reads through K5's plain version) against the JAX engine and the
CPU engines.

The reference side is TpuMergeEngine(resident=True, steady=True,
warmup=0, dense_fold="xla"); the port side is TorchMergeEngine(
resident=True, steady=True, warmup=0, device="cpu").  Reads compare as
bytes (bit-identical floats: the canonical-order law of crdt/tensor.py)
after every round, and the canonical state after the flush.  The claims
are those of tests/test_tensor_family.py, ported.
"""

import numpy as np
import pytest

from constdb_tpu.crdt import tensor as JT
from constdb_tpu.engine.cpu import CpuMergeEngine as JaxCpuEngine
from constdb_tpu.engine.tpu import TpuMergeEngine
from constdb_tpu.store.keyspace import KeySpace as JaxKeySpace
from constdb_tpu_torch import convert, workload as W
from constdb_tpu_torch.crdt import tensor as T
from constdb_tpu_torch.engine.cpu import CpuMergeEngine
from constdb_tpu_torch.engine.cuda import TorchMergeEngine
from constdb_tpu_torch.ops import kernels as KN
from constdb_tpu_torch.store.keyspace import KeySpace

from test_tensor_family import gen_rows, make_batch, payload

STRATS = sorted(T.STRATEGY_IDS)


def port_batch(b):
    return convert.batch_from_dict(
        {f: getattr(b, f) for f in convert.BATCH_FIELDS})


def port_engine(**kw):
    return TorchMergeEngine(resident=True, steady=True, warmup=0,
                            device="cpu", **kw)


def same_reads(got: dict, want) -> None:
    for kid, arr in got.items():
        w = want(kid)
        if w is None:
            assert arr is None, kid
        else:
            assert np.asarray(arr).tobytes() == w.tobytes(), kid


@pytest.mark.parametrize("dtype", [0, 1])
@pytest.mark.parametrize("strat", STRATS)
def test_resident_micro_differential(strat, dtype):
    """Resident micro merges and device reads vs the JAX engine's and the
    CPU reference's: canonical state and per-round reads bit-identical,
    with the steady path engaged."""
    rng = np.random.default_rng(11 + dtype)
    elems = 96
    np_dt = np.float64 if dtype else np.float32
    cfg = JT.pack_config(JT.TensorMeta(JT.STRATEGY_IDS[strat], dtype,
                                       (elems,)))
    ref, jax_ks, dev = JaxKeySpace(), JaxKeySpace(), KeySpace()
    cpu = JaxCpuEngine()
    jeng = TpuMergeEngine(resident=True, steady=True, warmup=0,
                          dense_fold="xla")
    eng = port_engine()
    u = 1
    for _ in range(6):
        rows, u = gen_rows(rng, 40, 10, 4, elems, u)
        rows = [(k, nd, uu, c, payload(rng, elems, np_dt).tobytes())
                for k, nd, uu, c, _p in rows]
        cpu.merge_many(ref, [make_batch(rows, cfg, elems)])
        jeng.merge_many(jax_ks, [make_batch(rows, cfg, elems)])
        eng.merge_many(dev, [port_batch(make_batch(rows, cfg, elems))])
        got = eng.tensor_read_many(dev, range(dev.keys.n))
        jgot = jeng.tensor_read_many(jax_ks, range(jax_ks.keys.n))
        same_reads(got, ref.tensor_read)
        same_reads(got, lambda kid: None if jgot[kid] is None
                   else np.asarray(jgot[kid]))
    assert eng.tns_dev_rows > 0 and eng.tns_host_rows == 0
    assert eng.dev_rounds_resident > 0
    assert eng.host_stale(("tns",))
    eng.flush(dev)
    jeng.flush(jax_ks)
    assert not eng.host_stale(("tns",))
    assert 0 < eng.flush_rows_downloaded
    assert dev.canonical() == ref.canonical() == jax_ks.canonical()
    # post-flush host reads equal the device reads that preceded them
    same_reads(got, dev.tensor_read)
    eng.close()
    jeng.close()


def test_resident_steady_off_routes_host():
    """steady=False: tensor rows take the host strategy, no pools, same
    results."""
    rng = np.random.default_rng(13)
    cfg = JT.pack_config(JT.TensorMeta(JT.STRAT_SUM, 0, (32,)))
    rows, _ = gen_rows(rng, 64, 6, 3, 32)
    ref = JaxKeySpace()
    JaxCpuEngine().merge_many(ref, [make_batch(rows, cfg, 32)])
    dev = KeySpace()
    eng = TorchMergeEngine(resident=True, steady=False, device="cpu")
    eng.merge_many(dev, [port_batch(make_batch(rows, cfg, 32))])
    eng.flush(dev)
    assert eng.tns_dev_rows == 0 and eng.tns_host_rows == len(rows)
    assert not eng._tns_pools
    assert dev.canonical() == ref.canonical()
    got = eng.tensor_read_many(dev, range(dev.keys.n))
    same_reads(got, ref.tensor_read)
    eng.close()


def test_pool_cap_flush_and_op_write_invalidation():
    """The CONSTDB_TORCH_TENSOR_POOL_MB cap flushes and drops the pools
    mid-stream, and an op-path tensor write (fam_ver bump) drops clean
    pools; both keep the results identical to the reference."""
    rng = np.random.default_rng(23)
    elems = 64
    cfg = JT.pack_config(JT.TensorMeta(JT.STRAT_MAXMAG, 0, (elems,)))
    ref = JaxKeySpace()
    cpu = JaxCpuEngine()
    dev = KeySpace()
    eng = port_engine()
    eng.tns_pool_cap = 1 << 14  # trip the cap every couple of rounds
    epochs = []
    u = 1
    for r in range(6):
        rows, u = gen_rows(rng, 32, 6, 3, elems, u)
        cpu.merge_many(ref, [make_batch(rows, cfg, elems)])
        eng.merge_many(dev, [port_batch(make_batch(rows, cfg, elems))])
        epochs.append(eng._tns_epoch)
        if r == 3:
            # op-path write between rounds: flush-before-touch, then the
            # version bump must drop the (clean) pools
            eng.flush(dev)
            u += 1
            op_pay = payload(rng, elems)
            for ks in (dev, ref):
                kid = ks.tensor_get_or_create(b"t0002", cfg, u << 22)
                ks.tensor_slot_set(kid, 9, u << 22, 1, op_pay)
            dev.touch("tns")
        got = eng.tensor_read_many(dev, range(dev.keys.n))
        same_reads(got, ref.tensor_read)
    assert epochs[-1] > epochs[0]
    eng.flush(dev)
    assert dev.canonical() == ref.canonical()
    eng.close()


def test_config_mismatch_bad_payload_and_count_skip_rows():
    """Config-mismatched, wrong-size and count-0 rows drop with a log on
    both engines (snapshot-merge semantics), never poisoning the batch."""
    elems = 16
    good = JT.pack_config(JT.TensorMeta(JT.STRAT_SUM, 0, (elems,)))
    other = JT.pack_config(JT.TensorMeta(JT.STRAT_AVG, 0, (elems,)))
    rng = np.random.default_rng(7)
    rows = [(0, 1, 10 << 22, 1, payload(rng, elems).tobytes()),
            (0, 2, 11 << 22, 1, payload(rng, elems).tobytes()),
            (1, 1, 12 << 22, 1, payload(rng, elems).tobytes()),
            (2, 1, 13 << 22, 0, payload(rng, elems).tobytes())]
    stores = []
    for make in (CpuMergeEngine, port_engine):
        b = make_batch(rows, good, elems)
        b.tns_cfg = [good, other, good, good]      # row 1: config mismatch
        b.tns_payload[2] = b.tns_payload[2][:-4]   # row 2: short payload
        b.tns_cnt = np.array([1, 1, 1, 0], np.int64)  # row 3: count 0
        ks = KeySpace()
        eng = make()
        eng.merge_many(ks, [port_batch(b)])
        eng.flush(ks)
        assert ks.tns_merges_by_strat.get("sum", 0) == 1
        assert ks.tns_meta.get(ks.lookup(b"t0002")) is None
        stores.append(ks)
    assert stores[0].canonical() == stores[1].canonical()


def test_tensor_workload_reads_match_host_leg():
    """chip_smoke's phase 7 at a small size: make_tensor_workload (a copy
    of bench.py make_tensor_workload) per strategy, reads every round,
    device leg against the host leg."""
    import bench
    for strat in ("avg", "maxmag", "trimmed-mean", "sum", "lww"):
        batches = W.make_tensor_workload(4, 16, 8, 4, 64, strat)
        ref = bench.make_tensor_workload(4, 16, 8, 4, 64, strat)
        for m, r in zip(batches, ref):
            for f in convert.BATCH_FIELDS:
                a, b = getattr(m, f), getattr(r, f)
                if isinstance(b, np.ndarray):
                    assert np.array_equal(a, b), f
                else:
                    assert a == b, f
        eng = port_engine()
        dev, host = KeySpace(), KeySpace()
        cpu = CpuMergeEngine()
        for b in batches:
            eng.merge_many(dev, [b])
            cpu.merge_many(host, [b])
            same_reads(eng.tensor_read_many(dev, range(8)), host.tensor_read)
        eng.flush(dev)
        assert dev.canonical() == host.canonical()
        assert dev.canonical() == W.replay_oracle(batches).canonical()
        eng.close()


def test_read_cache_keeps_one_entry_per_key_set():
    rng = np.random.default_rng(71)
    cfg = JT.pack_config(JT.TensorMeta(JT.STRAT_AVG, 0, (32,)))
    rows, _ = gen_rows(rng, 24, 4, 3, 32)
    eng = port_engine()
    ks = KeySpace()
    eng.merge_many(ks, [port_batch(make_batch(rows, cfg, 32))])
    a, b = ks.lookup(b"t0001"), ks.lookup(b"t0002")
    eng.tensor_read_many(ks, [a])
    eng.tensor_read_many(ks, [b])
    got = eng.tensor_read_many(ks, [a])
    assert len(eng._tns_read_cache["by_kids"]) == 2
    assert eng.needs_flush and eng.flush_rows_downloaded == 0
    ref = KeySpace()
    CpuMergeEngine().merge_many(ref, [port_batch(make_batch(rows, cfg,
                                                            32))])
    assert got[a].tobytes() == ref.tensor_read(ref.lookup(b"t0001")).tobytes()
    eng.close()


@pytest.mark.parametrize("dtype", [0, 1])
def test_avg_reads_one_fused_reduce_per_group(monkeypatch, dtype):
    """avg reads make ONE K5 call per group of every read, with the count
    weights and totals (no separate scale and divide), and stay
    bit-identical to the host reference."""
    calls = []
    orig = KN.tensor_take_reduce

    def spy(*a, **kw):
        calls.append(kw)
        return orig(*a, **kw)

    monkeypatch.setattr(KN, "tensor_take_reduce", spy)
    rng = np.random.default_rng(41 + dtype)
    elems = 37  # an odd width
    np_dt = np.float64 if dtype else np.float32
    cfg = JT.pack_config(JT.TensorMeta(JT.STRAT_AVG, dtype, (elems,)))
    ref, dev = KeySpace(), KeySpace()
    cpu = CpuMergeEngine()
    eng = port_engine()
    u = 1
    group_reads = 0
    for _ in range(4):
        rows, u = gen_rows(rng, 30, 6, 4, elems, u)
        rows = [(k, nd, uu, c, payload(rng, elems, np_dt).tobytes())
                for k, nd, uu, c, _p in rows]
        cpu.merge_many(ref, [port_batch(make_batch(rows, cfg, elems))])
        eng.merge_many(dev, [port_batch(make_batch(rows, cfg, elems))])
        kids = range(dev.keys.n)
        same_reads(eng.tensor_read_many(dev, kids), ref.tensor_read)
        # the groups this read reduced, from the engine's read cache
        group_reads += len(
            eng._tns_read_cache["by_kids"][tuple(kids)]["groups"])
    assert calls and len(calls) == group_reads
    assert all(kw["strat"] == T.STRAT_AVG and kw["w"] is not None and
               kw["tot"] is not None for kw in calls)
    eng.flush(dev)
    assert dev.canonical() == ref.canonical()
    eng.close()
