"""The port's steady state (engine/cuda.py micro path) against the JAX
engine and the CPU engines.

The reference side is TpuMergeEngine(resident=True, steady=True,
warmup=0, dense_fold="xla"); the port side is TorchMergeEngine(
resident=True, steady=True, warmup=0, device="cpu"), whose K3 wrapper
takes its plain version (ops/bulk.py bulk_lww_src) on CPU tensors.  Both
run the same make_stream_workload batches (made from a seed, carried
across as numpy arrays and lists), and every comparison is exact:
canonical() equal, counter sums equal.  These are the claims of
tests/test_resident_steady.py, ported:
  * stream differential, with in-place rounds and partial flushes;
  * snapshot ingest, then the stream, on one engine;
  * the warm-up gate, host_stale, a micro delete that survives a
    forced-fold bulk round, and the MergeStats transfer deltas;
  * one fused K3 call and one host-to-device copy per device round;
and the slice as a whole, small: catch-up, stream, tensor rounds.
"""

import numpy as np
import pytest

from constdb_tpu.crdt import semantics as JS
from constdb_tpu.engine import CpuMergeEngine as JaxCpuEngine
from constdb_tpu.engine.base import ColumnarBatch as JaxBatch
from constdb_tpu.engine.tpu import TpuMergeEngine
from constdb_tpu.store import KeySpace as JaxKeySpace
from constdb_tpu_torch import convert, workload as W
from constdb_tpu_torch.engine.cpu import CpuMergeEngine
from constdb_tpu_torch.engine.cuda import TorchMergeEngine
from constdb_tpu_torch.ops import kernels as KN
from constdb_tpu_torch.store.keyspace import KeySpace

NT = JS.NEUTRAL_T


def jax_batch(b):
    out = JaxBatch()
    for f in convert.BATCH_FIELDS:
        setattr(out, f, convert._copy(getattr(b, f)))
    return out


def port_batch(b):
    return convert.batch_from_dict(
        {f: getattr(b, f) for f in convert.BATCH_FIELDS})


def jax_engine(**kw):
    kw.setdefault("warmup", 0)
    return TpuMergeEngine(resident=True, steady=True, dense_fold="xla", **kw)


def port_engine(**kw):
    kw.setdefault("warmup", 0)
    return TorchMergeEngine(resident=True, steady=True, device="cpu", **kw)


def sums(ks):
    return {k: ks.counter_sum(kid) for kid, k in enumerate(ks.key_bytes)
            if int(ks.keys.enc[kid]) == JS.ENC_COUNTER}


def with_counter_deletes(batches, seed):
    """Add delcnt-shaped rows to some batches (the coalescer's counter
    delete: a key tombstone plus a slot row with base @ delete-uuid and a
    neutral total pair), so the rare base pair takes its path."""
    rng = np.random.default_rng(seed)
    for b in batches[1::3]:
        cnt_kis = np.unique(b.cnt_ki)
        if not len(cnt_kis):
            continue
        pick = rng.choice(cnt_kis, min(3, len(cnt_kis)), replace=False)
        m = len(pick)
        t = int(b.key_mt.max()) + 1
        b.cnt_ki = np.concatenate([b.cnt_ki, pick])
        b.cnt_node = np.concatenate([b.cnt_node, np.full(m, W.STREAM_ORIGIN)])
        b.cnt_val = np.concatenate([b.cnt_val, np.zeros(m, np.int64)])
        b.cnt_uuid = np.concatenate([b.cnt_uuid, np.full(m, NT)])
        b.cnt_base = np.concatenate([b.cnt_base,
                                     rng.integers(-99, 99, m)])
        b.cnt_base_t = np.concatenate([b.cnt_base_t,
                                       t + np.arange(m, dtype=np.int64)])
    return batches


def drive(engine, store, batches, flush_every=None):
    for i, b in enumerate(batches):
        engine.merge_many(store, [b])
        if flush_every and i % flush_every == flush_every - 1:
            engine.flush(store)
    engine.flush(store)


# ---------------------------------------------------------- differentials


@pytest.mark.parametrize("frames,keys,batch,flush_every",
                         [(1500, 40, 64, None), (2500, 80, 48, 5),
                          (1200, 15, 128, 2)])
def test_stream_differential(frames, keys, batch, flush_every):
    """The coalesced stream on the steady path equals the JAX engine's
    steady path and the CPU engine byte for byte, including tombstones,
    counter deletes and the GC queue's effect, with in-place rounds and
    partial downloads."""
    batches = with_counter_deletes(
        W.make_stream_workload(frames, keys, seed=frames, batch_frames=batch),
        seed=keys)
    ref = JaxKeySpace()
    jeng = jax_engine()
    drive(jeng, ref, [jax_batch(b) for b in batches], flush_every)
    cpu = JaxKeySpace()
    drive(JaxCpuEngine(), cpu, [jax_batch(b) for b in batches])
    ks = KeySpace()
    eng = port_engine()
    drive(eng, ks, [port_batch(b) for b in batches], flush_every)
    eng.close()
    jeng.close()
    assert ks.canonical() == ref.canonical() == cpu.canonical()
    assert sums(ks) == sums(ref) == sums(cpu)
    assert eng.dev_rounds_resident == jeng.dev_rounds_resident > 0
    assert eng.host_micro_rounds == 0
    assert 0 < eng.flush_rows_downloaded < eng.flush_rows_full_equiv
    horizon = max(int(b.key_mt.max()) for b in batches) + (1 << 22)
    assert ks.gc(horizon) == ref.gc(horizon)
    assert ks.canonical() == ref.canonical()


@pytest.mark.parametrize("fold", ["auto", "cuda"])
def test_snapshot_ingest_then_stream(fold):
    """A bulk catch-up (unique batches, whole-plane flush with the sums
    re-derived) followed by steady micro rounds on the same engine
    (dirty-row flushes with incremental sums) equals the references."""
    n_keys = 400
    b = JaxBatch()
    b.keys = [b"c%05d" % i for i in range(n_keys)]
    b.key_enc = np.full(n_keys, JS.ENC_COUNTER, dtype=np.int8)
    b.key_ct = np.full(n_keys, W.MS0 << 22, dtype=np.int64)
    b.key_mt = b.key_ct.copy()
    b.key_dt = np.zeros(n_keys, dtype=np.int64)
    b.key_expire = np.zeros(n_keys, dtype=np.int64)
    b.reg_val = [None] * n_keys
    b.reg_t = np.zeros(n_keys, dtype=np.int64)
    b.reg_node = np.zeros(n_keys, dtype=np.int64)
    b.cnt_ki = np.arange(n_keys, dtype=np.int64)
    b.cnt_node = np.full(n_keys, 9, dtype=np.int64)
    b.cnt_val = np.arange(n_keys, dtype=np.int64) - 50
    b.cnt_uuid = b.key_ct.copy()
    b.cnt_base = np.zeros(n_keys, dtype=np.int64)
    b.cnt_base_t = np.full(n_keys, NT, dtype=np.int64)
    b.rows_unique_per_slot = True
    stream = W.make_stream_workload(600, 30, seed=8, batch_frames=48)
    ref = JaxKeySpace()
    jeng = jax_engine()
    jeng.merge_many(ref, [b])
    drive(jeng, ref, [jax_batch(x) for x in stream])
    ks = KeySpace()
    eng = port_engine(dense_fold=fold)
    eng.merge_many(ks, [port_batch(b)])
    drive(eng, ks, [port_batch(x) for x in stream])
    eng.close()
    jeng.close()
    assert ks.canonical() == ref.canonical()
    assert sums(ks) == sums(ref)
    assert eng.dev_rounds_resident > 0


def test_snapshot_of_the_stream_then_the_stream():
    """The catch-up snapshot holds the very keys the stream goes on
    writing (a replica that joins mid-stream): the whole-plane catch-up
    flush, then dirty-row flushes over the same rows."""
    stream = W.make_stream_workload(1600, 25, seed=4, batch_frames=64)
    head = W.replay_oracle(stream[:10])
    from constdb_tpu_torch.engine.base import batch_from_keyspace
    snap = batch_from_keyspace(head)
    snap.rows_unique_per_slot = True
    want = W.replay_oracle([snap] + stream[6:])
    for fold in ("auto", "eager"):
        ks = KeySpace()
        eng = port_engine(dense_fold=fold)
        eng.merge_many(ks, [port_batch(snap)])
        drive(eng, ks, [port_batch(x) for x in stream[6:]], flush_every=4)
        eng.close()
        assert ks.canonical() == want.canonical(), fold
        assert sums(ks) == sums(want), fold
        assert eng.dev_rounds_resident > 0


def test_stream_workload_matches_coalescer():
    """make_stream_workload lays each flush out exactly as the JAX
    package's coalescer does: the same frames (bench.py make_frame_log,
    collection deletes left out) through replica/coalesce.py BatchBuilder
    and server/commands.py COLUMNAR_ENCODERS give field-equal batches."""
    import bench
    from constdb_tpu.replica.coalesce import BatchBuilder
    from constdb_tpu.resp.message import as_bytes, as_int
    from constdb_tpu.server.commands import COLUMNAR_ENCODERS
    frames = [f for f in bench.make_frame_log(3000, 200)
              if as_bytes(f[4]) != b"delset"]
    mine = W.make_stream_workload(3000, 200, batch_frames=512)
    assert len(mine) == -(-len(frames) // 512)
    ks = JaxKeySpace()
    for m, lo in zip(mine, range(0, len(frames), 512)):
        buf: dict = {}
        for it in frames[lo:lo + 512]:
            buf.setdefault(as_bytes(it[4]), []).append(
                (as_bytes(it[5]), as_int(it[1]), as_int(it[3]), it))
        bb = BatchBuilder(ks)
        for name, recs in buf.items():
            COLUMNAR_ENCODERS[name](bb, recs)
        ref = bb.finalize()
        for f in convert.BATCH_FIELDS:
            a, r = getattr(m, f), getattr(ref, f)
            if isinstance(r, np.ndarray):
                assert a.dtype == r.dtype and np.array_equal(a, r), f
            else:
                assert a == r, f


# ------------------------------------------------------- routing behavior


def test_warmup_gate_engages_after_stable_rounds():
    stream = W.make_stream_workload(800, 40, seed=21, batch_frames=32)
    eng = port_engine(warmup=2)
    jeng = jax_engine(warmup=2)
    ks, ref = KeySpace(), JaxKeySpace()
    drive(eng, ks, [port_batch(b) for b in stream])
    drive(jeng, ref, [jax_batch(b) for b in stream])
    # the first `warmup` rounds route to the host twins, the rest ride
    assert eng.host_micro_rounds == jeng.host_micro_rounds == 2
    assert eng.dev_rounds_resident == jeng.dev_rounds_resident > 0
    assert ks.canonical() == ref.canonical()
    eng.close()
    jeng.close()


def test_host_stale_reports_touched_families():
    """host_stale narrows exactly to families with unflushed device
    state; env stays host-authoritative, so dt reads never flush."""
    stream = W.make_stream_workload(200, 40, seed=21, batch_frames=64)
    eng = port_engine()
    ks = KeySpace()
    for b in stream:
        eng.merge_many(ks, [port_batch(b)])
    assert eng.needs_flush
    assert not eng.host_stale(("env",))
    for fam in ("reg", "cnt", "el"):
        assert eng.host_stale((fam,))
    assert not eng.host_stale(("tns",))
    eng.flush(ks)
    assert not eng.host_stale(("reg", "cnt", "el", "tns"))
    eng.close()


def test_steady_off_takes_the_whole_round_host_path():
    stream = W.make_stream_workload(600, 30, seed=3, batch_frames=64)
    eng = TorchMergeEngine(resident=True, steady=False, device="cpu")
    ks = KeySpace()
    drive(eng, ks, [port_batch(b) for b in stream])
    assert eng.dev_rounds_resident == 0
    assert eng.host_micro_rounds == len(stream)
    assert not eng.needs_flush
    assert ks.canonical() == W.replay_oracle(stream).canonical()
    eng.close()


def _el_batch(member_ts, del_ts, unique):
    from constdb_tpu_torch.engine.base import ColumnarBatch
    u = lambda i: (W.MS0 + i) << 22  # noqa: E731
    b = ColumnarBatch()
    b.keys = [b"s1"]
    b.key_enc = np.full(1, JS.ENC_SET, dtype=np.int8)
    b.key_ct = np.array([u(1)], dtype=np.int64)
    b.key_mt = np.array([u(1)], dtype=np.int64)
    b.key_dt = np.zeros(1, dtype=np.int64)
    b.key_expire = np.zeros(1, dtype=np.int64)
    b.reg_val = [None]
    b.reg_t = np.zeros(1, dtype=np.int64)
    b.reg_node = np.zeros(1, dtype=np.int64)
    n = len(member_ts)
    b.el_ki = np.zeros(n, dtype=np.int64)
    b.el_member = [m for m, _ in member_ts]
    b.el_val = [None] * n
    b.el_add_t = np.array([u(t) if t else 0 for _, t in member_ts],
                          np.int64)
    b.el_add_node = np.full(n, 3, dtype=np.int64)
    b.el_del_t = np.array([u(t) if t else 0 for t in del_ts], np.int64)
    b.rows_unique_per_slot = unique
    return b


@pytest.mark.parametrize("fold", ["eager", "cuda"])
def test_micro_delete_survives_forced_fold_bulk_round(fold):
    """A micro-round element DELETE advances the host del_t; the device
    mirror's del_t must advance in lockstep, or a later forced-fold bulk
    round (whose passes read and download del_t) merges against the stale
    plane and resurrects the deleted member at flush."""
    steps = [_el_batch([(b"m1", 2), (b"m2", 2)], [0, 0], False),
             _el_batch([(b"m1", 0)], [5], False),
             _el_batch([(b"m1", 3), (b"m2", 3)], [0, 0], True)]
    got = KeySpace()
    eng = port_engine(dense_fold=fold)
    for b in steps:
        eng.merge_many(got, [port_batch(b)])
    eng.flush(got)
    eng.close()
    ref = JaxKeySpace()
    jeng = TpuMergeEngine(resident=True, steady=True, warmup=0,
                          dense_fold="xla")
    for b in steps:
        jeng.merge_many(ref, [jax_batch(b)])
    jeng.flush(ref)
    jeng.close()
    want = KeySpace()
    cpu = CpuMergeEngine()
    for b in steps:
        cpu.merge_many(want, [port_batch(b)])
    assert got.canonical() == want.canonical() == ref.canonical()
    # m1 stays dead: del u(5) > add u(3)
    kid = got.lookup(b"s1")
    assert [m for m, *_ in got.elem_live(kid)] == [b"m2"]


def _record_rounds(monkeypatch):
    """Spy on the K3 wrapper the engine calls: -> the list of each call's
    [(segment kind, rows)]."""
    calls = []
    orig = KN.scatter_round

    def spy(segs):
        calls.append([(g.kind, int(g.idx.shape[0])) for g in segs])
        return orig(segs)

    monkeypatch.setattr(KN, "scatter_round", spy)
    return calls


@pytest.mark.parametrize("deletes", [False, True])
def test_each_device_round_is_one_fused_scatter_and_one_copy(monkeypatch,
                                                             deletes):
    """Every steady device round issues ONE scatter_round call carrying
    all its scatters (the LWW pairs, the counter base pair when counter
    deletes arrive, the element del_t max), uploaded in ONE host-to-device
    copy once the family mirrors exist; the result equals the replay
    oracle."""
    batches = W.make_stream_workload(1500, 40, seed=31, batch_frames=64)
    if deletes:
        batches = with_counter_deletes(batches, seed=5)
    calls = _record_rounds(monkeypatch)
    eng = port_engine()
    ks = KeySpace()
    copies = []
    for b in batches:
        c0, fams = eng.h2d_copies, set(eng._res)
        eng.merge_many(ks, [port_batch(b)])
        if fams == set(eng._res):  # no mirror built this round
            copies.append(eng.h2d_copies - c0)
    eng.flush(ks)
    eng.close()
    assert len(calls) == eng.dev_rounds_resident == len(batches)
    assert all(len(c) <= KN.MAX_SEGMENTS for c in calls)
    kinds = {k for c in calls for k, _ in c}
    assert KN.PAIR_SRC in kinds and KN.MAX1 in kinds
    assert (KN.PAIR in kinds) == deletes
    assert len(copies) >= len(batches) - 3 and set(copies) == {1}
    assert ks.canonical() == W.replay_oracle(batches).canonical()
    assert sums(ks) == sums(W.replay_oracle(batches))


@pytest.mark.parametrize("fold", ["eager", "cuda"])
def test_micro_delete_rides_the_fused_round(monkeypatch, fold):
    """The micro delete of test_micro_delete_survives_forced_fold_bulk_round
    advances the device del_t as a MAX1 segment of the same launch as the
    round's add pair, and the member stays dead through the forced-fold
    bulk round."""
    calls = _record_rounds(monkeypatch)
    steps = [_el_batch([(b"m1", 2), (b"m2", 2)], [0, 0], False),
             _el_batch([(b"m1", 0)], [5], False),
             _el_batch([(b"m1", 3), (b"m2", 3)], [0, 0], True)]
    got = KeySpace()
    eng = port_engine(dense_fold=fold)
    for b in steps:
        eng.merge_many(got, [port_batch(b)])
    eng.flush(got)
    eng.close()
    assert [sorted({k for k, _ in c}) for c in calls] == \
        [[KN.PAIR_SRC], [KN.PAIR_SRC, KN.MAX1]]
    kid = got.lookup(b"s1")
    assert [m for m, *_ in got.elem_live(kid)] == [b"m2"]


def test_merge_stats_carry_transfer_deltas():
    stream = W.make_stream_workload(64, 20, seed=5, batch_frames=64)
    eng = port_engine()
    ks = KeySpace()
    st = eng.merge_many(ks, [port_batch(stream[0])])
    assert st.dev_rounds_resident == 1
    assert st.dev_upload_bytes > 0
    assert st.flush_rows_downloaded == 0
    eng.flush(ks)
    assert eng.flush_rows_downloaded > 0
    st2 = eng.merge_many(ks, [port_batch(stream[0])])
    assert st2.dev_rounds_resident == 1
    eng.close()


def test_steady_resolves_from_the_device_and_the_environment(monkeypatch):
    """CONSTDB_TORCH_RESIDENT: auto (the default) is off for the CPU
    device (on for CUDA, which the chip run covers), 1 forces it on, 0
    off; an explicit argument wins."""
    monkeypatch.delenv("CONSTDB_TORCH_RESIDENT", raising=False)
    assert TorchMergeEngine(resident=True, device="cpu").steady is False
    monkeypatch.setenv("CONSTDB_TORCH_RESIDENT", "1")
    assert TorchMergeEngine(resident=True, device="cpu").steady is True
    monkeypatch.setenv("CONSTDB_TORCH_RESIDENT", "0")
    assert TorchMergeEngine(resident=True, device="cpu",
                            steady=True).steady is True
    assert TorchMergeEngine(resident=True, device="cpu").steady is False
    monkeypatch.setenv("CONSTDB_TORCH_RESIDENT_WARMUP", "5")
    assert TorchMergeEngine(resident=True, device="cpu").warmup == 5


# ------------------------------------------------------------- the slice


def test_slice_end_to_end_small():
    """The slice on one engine: a 400-key catch-up, 600 stream frames in
    batches of 48, then tensor rounds with reads after each, against the
    JAX engine and the port's CPU engine."""
    catch = W.make_workload(400, 3, seed=12)
    stream = W.make_stream_workload(600, 40, seed=13, batch_frames=48)
    tensor = W.make_tensor_workload(4, 24, 8, 4, 64, "trimmed-mean")
    eng = port_engine()
    jeng = jax_engine()
    ks, ref, want = KeySpace(), JaxKeySpace(), KeySpace()
    cpu = CpuMergeEngine()
    eng.merge_many(ks, [port_batch(b) for b in catch])
    jeng.merge_many(ref, [jax_batch(b) for b in catch])
    cpu.merge_many(want, [port_batch(b) for b in catch])
    for b in stream:
        eng.merge_many(ks, [port_batch(b)])
        jeng.merge_many(ref, [jax_batch(b)])
        cpu.merge_many(want, [port_batch(b)])
    for b in tensor:
        eng.merge_many(ks, [port_batch(b)])
        jeng.merge_many(ref, [jax_batch(b)])
        cpu.merge_many(want, [port_batch(b)])
        kids = [ks.lookup(b"t%06d" % k) for k in range(8)]
        got = eng.tensor_read_many(ks, kids)
        jgot = jeng.tensor_read_many(ref, [ref.lookup(b"t%06d" % k)
                                           for k in range(8)])
        for k, kid in enumerate(kids):
            w = want.tensor_read(want.lookup(b"t%06d" % k))
            j = jgot[ref.lookup(b"t%06d" % k)]
            assert got[kid].tobytes() == w.tobytes() == \
                np.asarray(j).tobytes()
    eng.flush(ks)
    jeng.flush(ref)
    assert ks.canonical() == want.canonical() == ref.canonical()
    assert sums(ks) == sums(want) == sums(ref)
    assert eng.dev_rounds_resident > 0 and eng.tns_dev_rows > 0
    eng.close()
    jeng.close()
