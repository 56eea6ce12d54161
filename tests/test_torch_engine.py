"""Differential tests: the port's TorchMergeEngine (on the CPU) against the
reference engines.

Each workload (those of tests/test_engine_equivalence.py, plus a small
chunked catch-up in the plain and the aligned-counter shapes) runs through
the reference CpuMergeEngine and TpuMergeEngine(dense_fold="xla",
steady=False) on reference batches, and through the port engine on the
same bytes carried across with constdb_tpu_torch.convert.  canonical()
and the counter sums must be equal, exactly, for every port
configuration: resident in {False, True} x dense_fold in {auto, eager,
off} (plus the scatter chooser, the iota index path and the "cuda" mode,
whose kernel wrappers take their plain versions on CPU tensors).
"""

import numpy as np
import pytest
import torch

import bench
from constdb_tpu.crdt import ENC_COUNTER, ENC_DICT
from constdb_tpu.engine import CpuMergeEngine, batch_from_keyspace
from constdb_tpu.engine.tpu import TpuMergeEngine
from constdb_tpu.persist.snapshot import batch_chunks
from constdb_tpu.store import KeySpace
from constdb_tpu_torch import convert, workload
from constdb_tpu_torch.conf import build_engine
from constdb_tpu_torch.engine.cuda import TorchMergeEngine
from constdb_tpu_torch.store.keyspace import KeySpace as PortKeySpace

from test_merge_properties import gen_store

# (resident, dense_fold, chooser): chooser "scatter" forces the
# touched-slot scatter path, "iota" derives every contiguous idx on device
CONFIGS = [(False, "auto", "bulk"), (False, "eager", "bulk"),
           (False, "off", "bulk"), (False, "eager", "scatter"),
           (True, "auto", "bulk"), (True, "auto", "iota"),
           (True, "eager", "bulk"), (True, "off", "bulk"),
           (True, "cuda", "iota")]
CONFIG_IDS = [f"{'res' if r else 'nonres'}-{f}-{c}" for r, f, c in CONFIGS]


def port_batch(b):
    return convert.batch_from_dict(
        {f: getattr(b, f) for f in convert.BATCH_FIELDS})


def keyspace_dict(ks) -> dict:
    d = {g: {c: ks_cols.col(c).copy() for c in cols}
         for g, cols in convert.KEYSPACE_COLUMNS.items()
         for ks_cols in [getattr(ks, g)]}
    for name in convert.KEYSPACE_LISTS:
        d[name] = list(getattr(ks, name))
    from constdb_tpu.crdt import tensor as T
    d["tns_meta"] = {k: T.pack_config(m) for k, m in ks.tns_meta.items()}
    d["key_deletes"] = dict(ks.key_deletes)
    d["garbage"] = list(ks.garbage)
    return d


def sums(ks):
    return {k: ks.counter_sum(kid) for kid, k in enumerate(ks.key_bytes)
            if ks.enc_of(kid) == ENC_COUNTER}


# ---------------------------------------------------------------- workloads
# each -> (initial reference KeySpace or None, [merge_many groups], gc)

def wl_empty(seed):
    return None, [[batch_from_keyspace(gen_store(seed, node=1))]], None


def wl_overlap(seed):
    x = batch_from_keyspace(gen_store(seed, node=1))
    y = batch_from_keyspace(gen_store(seed + 1000, node=2))
    return None, [[x], [y]], None


def wl_three_way(seed):
    bs = [batch_from_keyspace(gen_store(seed + i * 77, node=i + 1))
          for i in range(3)]
    return None, [[b] for b in bs + [bs[0]]], None


def wl_gc(seed):
    x = batch_from_keyspace(gen_store(seed, node=1))
    y = batch_from_keyspace(gen_store(seed + 500, node=2))
    return None, [[x], [y]], 40 << 22


def wl_onto_state(seed):
    """Merge onto a store carried across from the reference."""
    return gen_store(seed, node=1), \
        [[batch_from_keyspace(gen_store(seed + 300, node=2))]], None


def _raw_batch(keys, cnt_ki, cnt_node, cnt_val, cnt_uuid):
    from constdb_tpu.engine.base import ColumnarBatch
    n = len(keys)
    b = ColumnarBatch()
    b.keys = keys
    b.key_enc = np.zeros(n, np.int8)
    b.key_ct = np.full(n, 1 << 22, np.int64)
    b.key_mt = np.zeros(n, np.int64)
    b.key_dt = np.zeros(n, np.int64)
    b.key_expire = np.zeros(n, np.int64)
    b.reg_val = [None] * n
    b.reg_t = np.zeros(n, np.int64)
    b.reg_node = np.zeros(n, np.int64)
    m = len(cnt_ki)
    b.cnt_ki = np.array(cnt_ki, np.int64)
    b.cnt_node = np.array(cnt_node, np.int64)
    b.cnt_val = np.array(cnt_val, np.int64)
    b.cnt_uuid = np.array(cnt_uuid, np.int64)
    b.cnt_base = np.zeros(m, np.int64)
    b.cnt_base_t = np.full(m, KeySpace.NEUTRAL_T, np.int64)
    return b


def wl_dup_slot_rows(_seed):
    return None, [[_raw_batch([b"k"], [0, 0], [7, 7], [50, 3],
                              [9 << 22, 2 << 22])]], None


def wl_dup_keys(_seed):
    return None, [[_raw_batch([b"k", b"k"], [0, 1], [1, 2], [5, 10],
                              [2 << 22, 3 << 22])]], None


def wl_type_conflict(_seed):
    from constdb_tpu.crdt import ENC_SET
    a = KeySpace()
    ka, _ = a.get_or_create(b"k", ENC_COUNTER, 5 << 22)
    a.counter_change(ka, 1, 1, 5 << 22)
    b = KeySpace()
    kb, _ = b.get_or_create(b"k", ENC_SET, 6 << 22)
    b.elem_add(kb, b"m", None, 6 << 22, 2)
    return a, [[batch_from_keyspace(b)]], None


def wl_empty_batch(_seed):
    return None, [[batch_from_keyspace(KeySpace())]], None


def wl_winning_none(_seed):
    def mk(add_t, val):
        b = batch_from_keyspace(KeySpace())
        b.rows_unique_per_slot = True
        b.keys = [b"d1"]
        b.key_enc = np.array([ENC_DICT], dtype=np.int8)
        b.key_ct = np.array([1 << 22], dtype=np.int64)
        b.key_mt = np.array([add_t], dtype=np.int64)
        b.key_dt = np.zeros(1, dtype=np.int64)
        b.key_expire = np.zeros(1, dtype=np.int64)
        b.reg_val = [None]
        b.reg_t = np.zeros(1, dtype=np.int64)
        b.reg_node = np.zeros(1, dtype=np.int64)
        b.el_ki = np.zeros(1, dtype=np.int64)
        b.el_member = [b"m"]
        b.el_val = [val]
        b.el_add_t = np.array([add_t], dtype=np.int64)
        b.el_add_node = np.array([1], dtype=np.int64)
        b.el_del_t = np.zeros(1, dtype=np.int64)
        return b
    # the lexicographic winner carries None and must CLEAR the value
    return None, [[mk(100 << 22, b"y"), mk(200 << 22, None)]], None


def wl_aligned(_seed):
    return None, [bench.make_workload(600, 4, seed=11)], None


def wl_aligned_onto_state(_seed):
    bs = bench.make_workload(600, 4, seed=11)
    return None, [bs[:1], bs[1:]], None


def wl_aligned_counters(_seed):
    batches = bench.make_workload(400, 1, seed=3)
    b2 = bench.make_workload(400, 1, seed=4)[0]
    b2.cnt_node = batches[0].cnt_node
    return None, [[batches[0], b2]], None


def _catchup(aligned):
    """~2000 keys x 3 replicas in 300-key chunks: groups of 3 (aligned),
    12 (host combine across ranges) and a trailing partial group."""
    bs = workload.make_workload(2000, 3, seed=5, aligned_counters=aligned)
    chunks = list(_interleave(bs, 300))
    return None, [chunks[0:3], chunks[3:15], chunks[15:18],
                  chunks[18:]], None


def _interleave(batches, chunk):
    """Reference chunks of port batches, replica chunks interleaved."""
    per = [list(batch_chunks(_to_ref(b), chunk)) for b in batches]
    for i in range(max(len(p) for p in per)):
        for p in per:
            if i < len(p):
                yield p[i]


def _to_ref(b):
    from constdb_tpu.engine.base import ColumnarBatch
    out = ColumnarBatch()
    for f in convert.BATCH_FIELDS:
        setattr(out, f, getattr(b, f))
    return out


def wl_catchup_plain(_seed):
    return _catchup(False)


def wl_catchup_aligned_counters(_seed):
    return _catchup(True)


WORKLOADS = {
    "empty-0": (wl_empty, 0), "empty-1": (wl_empty, 1),
    "empty-7": (wl_empty, 7),
    "overlap-0": (wl_overlap, 0), "overlap-4": (wl_overlap, 4),
    "three-way-3": (wl_three_way, 3), "gc-2": (wl_gc, 2),
    "gc-5": (wl_gc, 5), "onto-state-6": (wl_onto_state, 6),
    "dup-slot-rows": (wl_dup_slot_rows, 0), "dup-keys": (wl_dup_keys, 0),
    "type-conflict": (wl_type_conflict, 0),
    "empty-batch": (wl_empty_batch, 0),
    "winning-none": (wl_winning_none, 0), "aligned": (wl_aligned, 0),
    "aligned-onto-state": (wl_aligned_onto_state, 0),
    "aligned-counters": (wl_aligned_counters, 0),
    "catchup-plain": (wl_catchup_plain, 0),
    "catchup-aligned-counters": (wl_catchup_aligned_counters, 0),
}

_REF: dict = {}


def _run_ref(name):
    """Reference results, cached per workload: (cpu canonical, cpu sums,
    jax canonical, jax sums)."""
    if name not in _REF:
        fn, seed = WORKLOADS[name]
        out = []
        for eng in (CpuMergeEngine(),
                    TpuMergeEngine(dense_fold="xla", steady=False)):
            init, steps, gc = fn(seed)
            ks = init if init is not None else KeySpace()
            for group in steps:
                eng.merge_many(ks, group)
            if eng.needs_flush:
                eng.flush(ks)
            if gc is not None:
                ks.gc(gc)
            out += [ks.canonical(), sums(ks)]
        _REF[name] = tuple(out)
    return _REF[name]


@pytest.mark.parametrize("cfg", CONFIGS, ids=CONFIG_IDS)
@pytest.mark.parametrize("name", list(WORKLOADS))
def test_port_engine_matches_reference(name, cfg):
    resident, fold, chooser = cfg
    cpu_can, cpu_sums, jax_can, jax_sums = _run_ref(name)
    assert cpu_can == jax_can and cpu_sums == jax_sums

    fn, seed = WORKLOADS[name]
    init, steps, gc = fn(seed)
    eng = TorchMergeEngine(resident=resident, dense_fold=fold,
                           device="cpu", pipeline=resident)
    if chooser == "scatter":
        eng.BULK_FRACTION = 0
    elif chooser == "iota":
        eng.IDX_IOTA_MIN = 1
    ks = PortKeySpace() if init is None else \
        convert.keyspace_from_dict(keyspace_dict(init))
    for group in steps:
        eng.merge_many(ks, [port_batch(b) for b in group])
    eng.flush(ks)
    if gc is not None:
        ks.gc(gc)
    eng.close()
    assert ks.canonical() == cpu_can
    assert sums(ks) == cpu_sums


def test_fold_counts_follow_mode():
    """The aligned fold runs on device under eager/cuda, on host under
    auto, never under off."""
    _, steps, _ = wl_aligned(0)
    folds = {}
    for fold in ("off", "eager", "cuda", "auto"):
        eng = TorchMergeEngine(dense_fold=fold, device="cpu")
        eng.merge_many(PortKeySpace(), [port_batch(b) for b in steps[0]])
        folds[fold] = eng.folds
    ref = TpuMergeEngine(dense_fold="xla", steady=False)
    ref.merge_many(KeySpace(), steps[0])
    assert folds["off"] == 0
    assert folds["eager"] == folds["cuda"] == ref.folds > 0
    assert folds["auto"] > 0


def test_convert_carries_keyspace_state():
    for seed in (1, 8):
        ref = gen_store(seed, node=3)
        port = convert.keyspace_from_dict(keyspace_dict(ref))
        assert port.canonical() == ref.canonical()
        assert sums(port) == sums(ref)
        pb = batch_from_keyspace(ref)
        from constdb_tpu_torch.engine.base import batch_from_keyspace as pbk
        got = pbk(port)
        for f in convert.BATCH_FIELDS:
            a, b = getattr(got, f), getattr(pb, f)
            if isinstance(b, np.ndarray):
                np.testing.assert_array_equal(a, b)
            elif f == "tns_payload":
                assert [x.tobytes() for x in a] == [x.tobytes() for x in b]
            else:
                assert a == b, f


def test_workload_matches_bench():
    """The port's workload generator draws the reference bench's bytes."""
    mine = workload.make_workload(500, 2, seed=9)
    ref = bench.make_workload(500, 2, seed=9)
    for m, r in zip(mine, ref):
        for f in convert.BATCH_FIELDS:
            a, b = getattr(m, f), getattr(r, f)
            if isinstance(b, np.ndarray):
                np.testing.assert_array_equal(a, b)
            else:
                assert a == b, f
    sub, keys = workload.subsample_workload(mine, 500, target=50)
    rsub, rkeys = bench.subsample_workload(ref, 500, target=50)
    assert keys == rkeys and len(sub) == len(rsub)


def test_port_catchup_verifies_against_oracle():
    """The chip_smoke catch-up shape at a small size: groups of 4R under
    auto, groups of R in the aligned-counter shape under the cuda mode."""
    for aligned, fold, group in ((False, "auto", 12), (True, "cuda", 3)):
        bs = workload.make_workload(3000, 3, seed=2, aligned_counters=aligned)
        chunks = workload.chunk_batches(bs, 512)
        eng = TorchMergeEngine(resident=True, dense_fold=fold, device="cpu")
        ks = PortKeySpace()
        for i in range(0, len(chunks), group):
            eng.merge_many(ks, chunks[i:i + group])
        eng.flush(ks)
        eng.close()
        checked, bad = workload.verify_store(ks, bs, 3000, target=600)
        assert checked == 600 and bad == 0
        assert eng.folds > 0


def test_unported_options_raise(monkeypatch):
    """The Pallas fold modes are not ported and raise.  The steady path
    is: steady=None resolves on for a CUDA device and off for the CPU,
    and steady=True constructs on the CPU."""
    with pytest.raises(ValueError):
        TorchMergeEngine(dense_fold="pallas", device="cpu")
    monkeypatch.delenv("CONSTDB_TORCH_RESIDENT", raising=False)
    assert TorchMergeEngine(resident=True, device="cpu").steady is False
    assert TorchMergeEngine(steady=True, device="cpu").steady is True
    import torch
    from constdb_tpu_torch.engine import cuda as cuda_engine
    monkeypatch.setattr(cuda_engine, "resolve_device",
                        lambda _dev: torch.device("cuda", 0))
    assert TorchMergeEngine(resident=True).steady is True
    monkeypatch.undo()
    assert build_engine("cpu").name == "cpu"
    assert build_engine("cuda", device="cpu").resident


def test_pool_bounds_flush_between_rounds():
    """The int32 win-pool ceiling pre-flushes before a round that could
    cross it, a zero pinned-bytes bound flushes after every round, and a
    single round past the ceiling raises before any pool state changes;
    the merged state stays exact throughout."""
    _, steps, _ = wl_catchup_plain(0)
    want = _run_ref("catchup-plain")
    for ceiling, flush_bytes in ((3000, 1 << 30), (1 << 31, 0)):
        eng = TorchMergeEngine(resident=True, device="cpu")
        eng.POOL_ID_CEILING = ceiling
        eng.pool_flush_bytes = flush_bytes
        ks = PortKeySpace()
        for group in steps:
            eng.merge_many(ks, [port_batch(b) for b in group])
            assert eng._pool_size < ceiling
        eng.flush(ks)
        eng.close()
        assert ks.canonical() == want[0]
        assert sums(ks) == want[1]
    eng = TorchMergeEngine(resident=True, device="cpu")
    eng.POOL_ID_CEILING = 100
    with pytest.raises(RuntimeError, match="int32"):
        eng.merge_many(PortKeySpace(), [port_batch(b) for b in steps[0]])
    assert eng._pool_size == 0
    eng.close()


@pytest.mark.parametrize("name", ["catchup-plain", "catchup-aligned-counters",
                                  "overlap-0"])
def test_recompute_sums_passes_base_to_k4(name, monkeypatch):
    """With the cuda fold backend on the CPU device (K4's wrapper takes
    its plain branch), the whole-plane counter flush hands the resident
    val and base columns to one segment_sum call, with no precomputed
    contribution, and the sums equal the reference CpuMergeEngine's."""
    import torch

    from constdb_tpu_torch.ops import kernels as KN
    cpu_can, cpu_sums, _, _ = _run_ref(name)
    calls = []
    real = KN.segment_sum

    def spy(ids, vals, n_seg, base=None):
        calls.append((ids, vals, n_seg, base))
        return real(ids, vals, n_seg, base=base)

    monkeypatch.setattr(KN, "segment_sum", spy)
    fn, seed = WORKLOADS[name]
    init, steps, gc = fn(seed)
    eng = TorchMergeEngine(resident=True, dense_fold="cuda", device="cpu")
    ks = PortKeySpace() if init is None else \
        convert.keyspace_from_dict(keyspace_dict(init))
    for group in steps:
        eng.merge_many(ks, [port_batch(b) for b in group])
    cols = eng._res["cnt"]["cols"]
    eng.flush(ks)
    if gc is not None:
        ks.gc(gc)
    eng.close()
    assert len(calls) == 1
    ids, vals, n_seg, base = calls[0]
    n = ks.cnt.n
    assert ids.dtype == torch.int32 and n_seg == ks.keys.n
    assert base is not None
    assert vals.data_ptr() == cols["val"].data_ptr()
    assert base.data_ptr() == cols["base"].data_ptr()
    assert vals.shape == base.shape == (n,)
    assert eng.family_secs["sums"] > 0
    assert ks.canonical() == cpu_can
    assert sums(ks) == cpu_sums


def wl_fold_onto_state(seed):
    """R = 3 aligned replica snapshots of 37 registers and 53 dict fields
    (a fold's real width, not a power of two), merged onto a store that
    already holds newer stamps for some of them.  Stamps come from small
    ranges, so replicas tie on t (node decides) and the batch ties or
    loses to the state in some columns; some fields carry None values,
    and a value depends only on its (t, node), as one write's would."""
    from constdb_tpu.crdt import ENC_BYTES
    rng = np.random.default_rng(seed)
    n_reg, n_dict, fields = 37, 11, [b"f%d" % i for i in range(6)]
    rows = [(d, f) for d in range(n_dict) for f in fields
            if rng.random() < 0.8][:53]
    assert len(rows) == 53

    def stamp():
        return int(rng.integers(1, 6)) << 22, int(rng.integers(1, 4))

    def val(t, node):
        return None if (t >> 22) % 3 == 0 else b"v%d.%d" % (t >> 22, node)

    def store(p_keep):
        ks = KeySpace()
        for i in range(n_reg):
            t, node = stamp()
            kid, _ = ks.get_or_create(b"r%03d" % i, ENC_BYTES, 1 << 22)
            if rng.random() < p_keep:
                ks.register_set(kid, b"v%d.%d" % (t >> 22, node), t, node)
        for d, f in rows:
            t, node = stamp()
            kid, _ = ks.get_or_create(b"d%03d" % d, ENC_DICT, 1 << 22)
            if rng.random() < p_keep:
                ks.elem_add(kid, f, val(t, node), t, node)
        return ks

    replicas = [batch_from_keyspace(store(1.0)) for _ in range(3)]
    for b in replicas:
        b.rows_unique_per_slot = True
    return store(0.6), [replicas], None


def test_device_fold_onto_state_matches_reference(monkeypatch):
    """The device fold (dense_fold="cuda" on the CPU device: K1's wrapper
    takes its plain branch) of registers and elements whose real width
    is not a power of two, onto existing state that wins some columns,
    values and None values included: one fold_apply call per family,
    stacks of exactly the fold's width, and canonical() byte-equal to
    the reference TpuMergeEngine(dense_fold="xla") and CpuMergeEngine."""
    from constdb_tpu_torch.ops import kernels as KN
    name = "fold-onto-state"
    WORKLOADS.setdefault(name, (wl_fold_onto_state, 3))
    cpu_can, cpu_sums, jax_can, jax_sums = _run_ref(name)
    assert cpu_can == jax_can and cpu_sums == jax_sums
    calls = []
    real = KN.fold_apply

    def spy(at, an, idx, st_at, st_an, dt=None, st_dt=None):
        calls.append((tuple(at.shape), dt is not None, idx.dtype))
        return real(at, an, idx, st_at, st_an, dt=dt, st_dt=st_dt)

    monkeypatch.setattr(KN, "fold_apply", spy)
    for resident in (False, True):
        calls.clear()
        init, steps, _ = wl_fold_onto_state(3)
        eng = TorchMergeEngine(resident=resident, dense_fold="cuda",
                               device="cpu")
        ks = convert.keyspace_from_dict(keyspace_dict(init))
        for group in steps:
            eng.merge_many(ks, [port_batch(b) for b in group])
        eng.flush(ks)
        eng.close()
        assert sorted(calls) == [((3, 37), False, torch.int32),
                                 ((3, 53), True, torch.int32)]
        assert ks.canonical() == cpu_can


def test_h2d_packed_stack_rows():
    """_h2d_packed on the CPU device: _Stack rows (int32 and int64) pack
    back to back into one [R, n] int64 view, plain columns (2-D,
    read-only, a list) keep their shapes, and int32 columns follow;
    every view equals its host data, in one copy."""
    from constdb_tpu_torch.engine import cuda as EC
    eng = TorchMergeEngine(resident=True, device="cpu")
    rng = np.random.default_rng(3)
    n = 100_003
    rows32 = [rng.integers(-9, 9, n).astype(np.int32) for _ in range(3)]
    rows64 = [rng.integers(-(1 << 62), 1 << 62, n) for _ in range(2)]
    mat = rng.integers(0, 1 << 40, (n // 100, 100))
    ro = rng.integers(0, 5, n)
    ro.flags.writeable = False
    ids = rng.integers(0, 100, 2 * n)
    d64, d32 = eng._h2d_packed(
        [EC._Stack(rows32), EC._Stack(rows64), mat, ro, [1, 2, 3]],
        [ids, np.arange(5)])
    assert eng.h2d_copies == 1
    want64 = [np.stack(rows32), np.stack(rows64), mat, ro,
              np.array([1, 2, 3])]
    for got, want in zip(d64, want64):
        assert got.dtype == torch.int64 and tuple(got.shape) == want.shape
        assert np.array_equal(got.numpy(), want)
    for got, want in zip(d32, (ids, np.arange(5))):
        assert got.dtype == torch.int32
        assert np.array_equal(got.numpy(), want)


# ------------------------------------------------------------ release hooks


def _hook_steps():
    """The aligned-counter catch-up's four merge groups (reference
    chunks)."""
    return _catchup(True)[1]


@pytest.mark.parametrize("fold", ["auto", "cuda"])
def test_release_device_pools_between_merges(fold):
    """merge -> release_device_pools -> merge gives the canonical() and
    sums of the same merges with no release, and of the reference engine
    with its own release at the same point."""
    steps = _hook_steps()
    out = []
    for release in (False, True):
        eng = TorchMergeEngine(resident=True, dense_fold=fold, device="cpu")
        ks = PortKeySpace()
        for i, group in enumerate(steps):
            if release and i == 2:
                epoch = eng._tns_epoch
                eng.release_device_pools(ks)
                assert not eng.needs_flush and eng._res == {}
                assert eng._val_pool == [] and eng._tns_epoch == epoch + 1
            eng.merge_many(ks, [port_batch(b) for b in group])
        eng.flush(ks)
        eng.close()
        out.append((ks.canonical(), sums(ks)))
    assert out[0] == out[1]
    ref = TpuMergeEngine(resident=True, dense_fold="xla", steady=False)
    ks = KeySpace()
    for i, group in enumerate(steps):
        if i == 2:
            ref.release_device_pools(ks)
        ref.merge_many(ks, group)
    ref.flush(ks)
    assert out[1] == (ks.canonical(), sums(ks))


def test_discard_resident_leaves_no_stale_mirror():
    """After discard_resident, a fresh store merges exactly as it would
    through a fresh engine: no mirror of the discarded store survives
    (its recorded plane versions would match the fresh store's)."""
    steps = [[port_batch(b) for b in g] for g in _hook_steps()]
    eng = TorchMergeEngine(resident=True, device="cpu")
    eng.merge_many(PortKeySpace(), steps[0] + steps[1])
    assert eng.needs_flush and eng._res
    eng.discard_resident()
    assert not eng.needs_flush and eng._res == {} and eng._val_pool == []
    got = PortKeySpace()
    for group in steps[2:]:
        eng.merge_many(got, group)
    eng.flush(got)
    want = PortKeySpace()
    fresh = TorchMergeEngine(resident=True, device="cpu")
    for group in steps[2:]:
        fresh.merge_many(want, group)
    fresh.flush(want)
    assert got.canonical() == want.canonical() and sums(got) == sums(want)


def test_release_and_close_drop_pinned_buffers():
    """release_device_pools and close() leave no staging-ring slot and
    no fold slot held (on the CPU device the slots are filled by hand:
    only CUDA uploads pin)."""
    def fill(eng):
        for slot in (*eng._ring, eng._fold_slot):
            slot["buf"] = torch.empty(1 << 16, dtype=torch.uint8)

    def held(eng):
        return [s for s in (*eng._ring, eng._fold_slot)
                if s["buf"] is not None or s["ev"] is not None]

    eng = TorchMergeEngine(resident=True, device="cpu")
    ks = PortKeySpace()
    eng.merge_many(ks, [port_batch(b) for b in _hook_steps()[0]])
    fill(eng)
    eng.release_device_pools(ks)
    assert held(eng) == []
    fill(eng)
    eng.discard_resident()
    assert held(eng) == []
    fill(eng)
    eng.close()
    assert held(eng) == []
    eng.close()   # idempotent
