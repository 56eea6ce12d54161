"""Differential tests: the PyTorch port's ops against the JAX reference.

Every port function runs on the CPU here, on the same numpy inputs as its
JAX counterpart, and must agree EXACTLY (all results are int64 words or
flags).  The plain versions of the CUDA kernels (K1 merge_elems, K2
merge_counters, K4 segment_sum) are held against the reference's Pallas
kernels in interpret mode and its XLA twins; K1 fused with its apply
(fold_apply) against the reference's two steps, the fold then
bulk_elems / bulk_lww; K4 (with and without its
fused base subtraction) against the XLA twin of `segment_sum(ids, val -
base)` and numpy.add.at (the reference's Pallas segment_sum does not
trace on this JAX).  The kernels themselves are held against these plain versions on
the card by chip_smoke.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from constdb_tpu.ops import bulk as JB
from constdb_tpu.ops import dense as JD
from constdb_tpu.ops import pallas_dense as PD
from constdb_tpu.ops import segment as JS
from constdb_tpu_torch.crdt import semantics as S
from constdb_tpu_torch.ops import bulk as TB
from constdb_tpu_torch.ops import dense as TD
from constdb_tpu_torch.ops import kernels as KN
from constdb_tpu_torch.ops import segment as TS

NT = S.NEUTRAL_T
I64_MIN, I64_MAX = -(1 << 63), (1 << 63) - 1


def _t(x):
    return torch.from_numpy(np.array(x, copy=True))


def _same(port_out, ref_out):
    port = port_out if isinstance(port_out, tuple) else (port_out,)
    ref = ref_out if isinstance(ref_out, tuple) else (ref_out,)
    assert len(port) == len(ref)
    for p, r in zip(port, ref):
        p = p.numpy() if isinstance(p, torch.Tensor) else np.asarray(p)
        r = np.asarray(r)
        assert p.shape == r.shape
        np.testing.assert_array_equal(p.astype(r.dtype), r)


def _stamps(rng, n, lo=0, hi=6):
    """Small stamp ranges force equal-stamp ties; ~1/6 neutral."""
    x = rng.integers(lo, hi, n).astype(np.int64) << 22
    x[rng.random(n) < 1 / 6] = NT
    return x


def _batch(rng, size, n_real, np_):
    """Unique slot ids of n_real rows padded to np_ with distinct
    out-of-range ids (the protocol of the reference's ops/bulk.py)."""
    idx = np.empty(np_, dtype=np.int32)
    idx[:n_real] = rng.permutation(size)[:n_real]
    idx[n_real:] = size + np.arange(np_ - n_real)
    return idx


# ---------------------------------------------------------------- bulk ops

BULK_CASES = ["bulk_max", "bulk_max1", "bulk_lww", "bulk_counters_vu",
              "bulk_counters", "bulk_lww_src", "bulk_lww_src_iota",
              "bulk_counters_vu_src", "bulk_counters_vu_src_iota",
              "bulk_counters_src", "bulk_elems"]


def _bulk_args(name, rng, i32_vals):
    size, n_real, np_ = 64, 21, 32
    idx = _batch(rng, size, n_real, np_)

    def state(neutral=True):
        return _stamps(rng, size) if neutral else \
            rng.integers(-50, 50, size).astype(np.int64)

    def col(neutral=True, small=False):
        if not neutral:
            v = rng.integers(-5, 5, np_).astype(np.int64)
            v[:2] = (I64_MIN, I64_MAX)
            return v.astype(np.int32) if small else v
        return _stamps(rng, np_)

    node = lambda: (rng.integers(0, 3, np_).astype(  # noqa: E731
        np.int32 if i32_vals else np.int64))
    src = lambda: np.full(size, -1, np.int32)  # noqa: E731
    base = np.int32(rng.integers(0, 1000))
    if name == "bulk_max":
        st = rng.integers(0, 9, (size, 4)).astype(np.int64)
        return (st, idx, rng.integers(0, 9, (np_, 4)).astype(np.int64)), {}
    if name == "bulk_max1":
        return (state(), idx, col()), {}
    if name in ("bulk_lww", "bulk_elems"):
        extra = ((state(False),) if name == "bulk_elems" else ())
        args = (state(), state(False)) + extra + (idx, col(), node())
        if name == "bulk_elems":
            args += (col(),)
        return args, {}
    if name == "bulk_counters_vu":
        return (state(False), state(), idx, col(False, i32_vals), col()), {}
    if name == "bulk_counters":
        return (state(False), state(), state(False), state(), idx,
                col(False), col(), col(False), col()), {}
    if name == "bulk_lww_src":
        return (state(), state(False), src(), idx, col(), node(), base), {}
    if name == "bulk_counters_vu_src":
        return (state(False), state(), src(), idx, col(False, i32_vals),
                col(), base), {}
    if name == "bulk_counters_src":
        return (state(False), state(), state(False), state(), src(), idx,
                col(False), col(), col(False), col(), base), {}
    r0, nrows = np.int32(7), np.int32(n_real)
    if name == "bulk_lww_src_iota":
        return (state(), state(False), src(), r0, nrows, col(), node(),
                base), {"np_": np_}
    if name == "bulk_counters_vu_src_iota":
        return (state(False), state(), src(), r0, nrows,
                col(False, i32_vals), col(), base), {"np_": np_}
    raise AssertionError(name)


@pytest.mark.parametrize("i32_vals", [False, True])
@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("name", BULK_CASES)
def test_bulk_ops_match_jax(name, seed, i32_vals):
    args, kw = _bulk_args(name, np.random.default_rng(seed), i32_vals)
    ref = getattr(JB, name)(*(jnp.asarray(a) if isinstance(a, np.ndarray)
                              else a for a in args), **kw)
    port = getattr(TB, name)(*(_t(a) if isinstance(a, np.ndarray) and
                               a.ndim else a for a in args), **kw)
    _same(port, ref)


def test_gather_rows_and_device_full_match_jax():
    rng = np.random.default_rng(3)
    st = rng.integers(-9, 9, (32, 4)).astype(np.int64)
    idx = rng.integers(0, 32, 16).astype(np.int32)
    _same(TB.gather_rows(_t(st), _t(idx)), JB.gather_rows(st, idx))
    _same(TB.gather_rows(_t(st[:, 0]), _t(idx)), JB.gather_rows(st[:, 0], idx))
    _same(TB.device_full(16, NT), JB.device_full(16, NT))
    got = TB.device_full(16, -1, i32=True)
    assert got.dtype == torch.int32
    _same(got, JB.device_full(16, -1, i32=True))


def test_pad_rows_scatter_nowhere():
    """Pad ids at or above the state size must leave the state untouched,
    even when their values would win."""
    st = np.zeros(8, np.int64)
    idx = np.array([2, 8, 9, 10], np.int32)
    vals = np.array([5, 99, 99, 99], np.int64)
    out = TB.bulk_max1(_t(st), _t(idx), _t(vals)).numpy()
    np.testing.assert_array_equal(out, [0, 0, 5, 0, 0, 0, 0, 0])


# ------------------------------------------------------------- segment ops

def _seg_inputs(rng, n_real=40, n_slots_real=9):
    n_rows = 64
    n_slots = 16
    slot = np.full(n_rows, n_slots - 1, np.int64)
    slot[:n_real] = rng.integers(0, n_slots_real, n_real)
    a = np.full(n_rows, NT, np.int64)
    a[:n_real] = _stamps(rng, n_real)
    b = np.full(n_rows, NT, np.int64)
    b[:n_real] = rng.integers(0, 3, n_real)
    return slot, a, b, n_slots


@pytest.mark.parametrize("seed", range(3))
def test_segment_ops_match_jax(seed):
    rng = np.random.default_rng(seed)
    slot, a, b, ns = _seg_inputs(rng)
    cur_t = _stamps(rng, ns)
    cur_v = rng.integers(-9, 9, ns).astype(np.int64)
    _same(TS.merge_counters(*map(_t, (slot, b, a, cur_v, cur_t)), ns),
          JS.merge_counters(slot, b, a, cur_v, cur_t, ns))
    d = rng.integers(0, 4, len(a)).astype(np.int64) << 22
    cur_at, cur_an = _stamps(rng, ns), rng.integers(0, 3, ns).astype(np.int64)
    cur_dt = rng.integers(0, 4, ns).astype(np.int64) << 22
    _same(TS.merge_elems(*map(_t, (slot, a, b, d, cur_at, cur_an, cur_dt)),
                         ns),
          JS.merge_elems(slot, a, b, d, cur_at, cur_an, cur_dt, ns))
    cols = [rng.integers(0, 9, len(a)).astype(np.int64) for _ in range(4)]
    curs = [rng.integers(0, 9, ns).astype(np.int64) for _ in range(4)]
    _same(TS.scatter_max4(_t(slot), *map(_t, cols), *map(_t, curs), ns),
          JS.scatter_max4(slot, *cols, *curs, ns))
    assert TS.next_pow2(33) == JS.next_pow2(33) == 64


# ----------------------------------------------- K1 / K2 plain vs reference

def _stack(rng, R, S_, lo, hi, neutral=True):
    x = rng.integers(lo, hi, (R, S_)).astype(np.int64)
    if neutral:
        x[rng.random((R, S_)) < 0.15] = NT
        x[:, :3] = NT  # columns no replica holds
    return x


@pytest.mark.parametrize("R,S_", [(1, 17), (3, 300), (8, 129)])
def test_k1_merge_elems_plain_matches_pallas_and_xla(R, S_):
    rng = np.random.default_rng(R * 1000 + S_)
    at = _stack(rng, R, S_, 0, 5) << 22
    at[at < 0] = NT
    an = _stack(rng, R, S_, 0, 3, neutral=False)
    dt = _stack(rng, R, S_, 0, 5, neutral=False) << 22
    port = TD.dense_merge_elems(_t(at), _t(an), _t(dt))
    _same(port, PD.merge_elems(jnp.asarray(at), jnp.asarray(an),
                               jnp.asarray(dt), interpret=True))
    _same(port, JD.dense_merge_elems(jnp.asarray(at), jnp.asarray(an),
                                     jnp.asarray(dt)))
    # the wrapper takes the plain version for CPU tensors, uncounted
    before = dict(KN.LAUNCHES)
    _same(KN.merge_elems(_t(at), _t(an), _t(dt)), port)
    lww = KN.merge_lww(_t(at), _t(an))
    _same(lww, JD.dense_merge_lww(jnp.asarray(at), jnp.asarray(an)))
    assert KN.LAUNCHES == before


def _k1_apply_inputs(rng, R, S_, has_del):
    """[R, S_] stacks, a state of S_ + 6 rows that beats or ties the batch
    in some columns, and idx: S_ - 5 unique state rows, then 5 pad rows
    beyond the state (the ops/bulk.py protocol)."""
    at = _stack(rng, R, S_, 0, 5) << 22
    at[at < 0] = NT
    an = _stack(rng, R, S_, 0, 3, neutral=False)
    dt = _stack(rng, R, S_, 0, 5, neutral=False) << 22 if has_del else None
    size = S_ + 6
    idx = _batch(rng, size, S_ - 5, S_)
    st = [rng.integers(0, 5, size).astype(np.int64) << 22,
          rng.integers(0, 3, size).astype(np.int64),
          rng.integers(0, 5, size).astype(np.int64) << 22][:3 if has_del
                                                           else 2]
    st[0][rng.random(size) < 0.5] = 0   # fresh rows: the batch wins
    return at, an, dt, idx, st


@pytest.mark.parametrize("has_del", [True, False],
                         ids=["elements", "registers"])
@pytest.mark.parametrize("R,S_", [(1, 17), (3, 301), (8, 129), (9, 7)])
def test_k1_fold_apply_plain_matches_reference_composition(R, S_, has_del):
    """K1 with its apply (plain version, and the wrapper on CPU tensors)
    against the reference's two steps on the same inputs: the Pallas
    merge_elems (interpret mode) or the XLA dense fold, then bulk_elems
    (elements) or dense_merge_lww then bulk_lww (registers).  The state
    planes and the winner (the winning batch row where the batch beat
    the state, else -1) are bit-equal; pad ids write nothing."""
    rng = np.random.default_rng(R * 100 + S_ + has_del)
    at, an, dt, idx, st = _k1_apply_inputs(rng, R, S_, has_del)
    j = jnp.asarray
    refs = []
    if has_del:
        for fold in (PD.merge_elems(j(at), j(an), j(dt), interpret=True),
                     JD.dense_merge_elems(j(at), j(an), j(dt))):
            fa, fx, fd, wb = fold
            *planes, win = JB.bulk_elems(*(j(x) for x in st), j(idx),
                                         fa, fx, fd)
            refs.append((np.where(np.asarray(win), np.asarray(wb), -1),
                         *planes))
    else:
        ft, fn, wb = JD.dense_merge_lww(j(at), j(an))
        *planes, win = JB.bulk_lww(*(j(x) for x in st), j(idx), ft, fn)
        refs.append((np.where(np.asarray(win), np.asarray(wb), -1),
                     *planes))
    before = dict(KN.LAUNCHES)
    for fn_ in (TB.fold_apply, KN.fold_apply):
        planes = [_t(x) for x in st]
        win = fn_(_t(at), _t(an), _t(idx), planes[0], planes[1],
                  dt=None if dt is None else _t(dt),
                  st_dt=planes[2] if has_del else None)
        assert win.dtype == torch.int32
        for ref in refs:
            _same((win, *planes), tuple(ref))
        # pad ids wrote nothing; rows outside idx kept their state
        untouched = np.setdiff1d(np.arange(len(st[0])), idx)
        for p_, x in zip(planes, st):
            np.testing.assert_array_equal(p_.numpy()[untouched],
                                          x[untouched])
    assert KN.LAUNCHES == before


def test_k1_fold_apply_wrapper_contract():
    """dt and st_dt go together; the register variant allocates no del
    plane and the fold-only register wrapper needs none."""
    rng = np.random.default_rng(5)
    at, an, dt, idx, st = _k1_apply_inputs(rng, 3, 40, True)
    planes = [_t(x) for x in st]
    with pytest.raises(ValueError):
        KN.fold_apply(_t(at), _t(an), _t(idx), planes[0], planes[1],
                      dt=_t(dt))
    with pytest.raises(ValueError):
        KN.fold_apply(_t(at), _t(an), _t(idx), *planes[:2],
                      st_dt=planes[2])
    _same(KN.merge_lww(_t(at), _t(an)),
          JD.dense_merge_lww(jnp.asarray(at), jnp.asarray(an)))


@pytest.mark.parametrize("R,S_", [(1, 17), (3, 300), (8, 129), (9, 7),
                                  (32, 64)])
def test_k2_merge_counters_plain_matches_pallas_and_xla(R, S_):
    rng = np.random.default_rng(R * 77 + S_)
    ts = _stack(rng, R, S_, 0, 4)
    vals = _stack(rng, R, S_, -3, 3, neutral=False)
    vals[0, :4] = (I64_MIN, I64_MAX, NT, NT + 1)
    port = TD.dense_merge_counters(_t(vals), _t(ts))
    _same(port, PD.merge_counters(jnp.asarray(vals), jnp.asarray(ts),
                                  interpret=True))
    _same(port, JD.dense_merge_counters(jnp.asarray(vals), jnp.asarray(ts)))
    _same(KN.merge_counters(_t(vals), _t(ts)), port)


def test_k2_values_below_neutral_follow_pallas_and_semantics():
    """Every value tied on the max stamp below NEUTRAL_T, beside a row of
    an older stamp: the reference's XLA twin fills that non-max row with
    NEUTRAL_T, which then beats the tied values, while its Pallas
    kernel and crdt/semantics.merge_counter_slot take the true max.  The
    port follows the Pallas kernel (recorded in ROADMAP.md, queue 3)."""
    vals = np.array([[NT - 9], [NT - 3], [0]], np.int64)
    ts = np.array([[5], [5], [4]], np.int64)
    port = TD.dense_merge_counters(_t(vals), _t(ts))
    pallas = PD.merge_counters(jnp.asarray(vals), jnp.asarray(ts),
                               interpret=True)
    _same(port, pallas)
    v, t = int(vals[0, 0]), int(ts[0, 0])
    for r in range(1, 3):
        v, t = S.merge_counter_slot(v, t, int(vals[r, 0]), int(ts[r, 0]))
    assert (int(port[0][0]), int(port[1][0])) == (v, t) == (NT - 3, 5)
    xla = JD.dense_merge_counters(jnp.asarray(vals), jnp.asarray(ts))
    assert int(np.asarray(xla[0])[0]) == NT  # the reference disagreement


# ------------------------------------------------------------ K4 plain

# (n, n_seg, layout, with_base): the first four cases keep their ids.
# "sweep" is the engine's layout (R ascending sweeps over the counter
# keys, the first of n_seg keys), "grouped" sorted ids with runs of equal
# ids, "oob" ids outside [0, n_seg) mixed in (skipped), "view" inputs
# that start one element into their storage
K4_CASES = [(1, 1, "random", False), (33, 7, "random", False),
            (1000, 100, "random", False), (4096, 3000, "random", False),
            (1, 1, "random", True), (33, 7, "random", True),
            (4096, 3000, "random", True), (4096, 3000, "sweep", False),
            (8 * 400, 1000, "sweep", True), (4097, 300, "grouped", True),
            (1000, 100, "oob", True), (31, 9, "view", True)]
K4_IDS = [f"{n}-{k}" if (lay, b) == ("random", False) else
          f"{lay}-{'base' if b else 'nobase'}-{n}-{k}"
          for n, k, lay, b in K4_CASES]


def _k4_inputs(n, n_seg, layout, with_base):
    rng = np.random.default_rng(n + n_seg)
    if layout == "sweep":
        keys = n_seg * 2 // 5
        ids = np.tile(np.arange(keys), -(-n // keys))[:n].astype(np.int32)
    elif layout == "grouped":
        ids = np.sort(rng.integers(0, n_seg, n)).astype(np.int32)
    else:
        ids = rng.integers(0, n_seg, n).astype(np.int32)
    if layout == "oob":
        ids[::7] = -1 - np.arange(len(ids[::7]))
        ids[3::7] = n_seg + np.arange(len(ids[3::7]))
    vals = rng.integers(-(1 << 40), 1 << 40, n).astype(np.int64)
    base = rng.integers(-(1 << 40), 1 << 40, n).astype(np.int64) \
        if with_base else None
    if n >= 4:
        # extremes in one segment: the exact sum wraps mod 2^64, and so
        # does val - base
        ids[:4] = 0
        vals[:4] = (I64_MAX, I64_MAX, I64_MIN, 7)
        if with_base:
            base[:4] = (I64_MIN, -1, 1, I64_MAX)
    return ids, vals, base


def _offset(x):
    """A copy of x that starts one element into its storage."""
    t = torch.empty(len(x) + 1, dtype=torch.from_numpy(x).dtype)
    t[1:] = torch.from_numpy(x)
    return t[1:]


@pytest.mark.parametrize("n,n_seg,layout,with_base", K4_CASES, ids=K4_IDS)
def test_k4_segment_sum_plain_matches_xla_and_numpy(n, n_seg, layout,
                                                    with_base):
    """K4's plain version, with and without the fused base subtraction,
    against the reference's XLA segment_sum of vals - base and
    numpy.add.at.  Ids outside [0, n_seg) are skipped; the reference
    only ever sees in-range ids (it would wrap a negative one)."""
    ids, vals, base = _k4_inputs(n, n_seg, layout, with_base)
    with np.errstate(over="ignore"):
        contrib = vals - base if with_base else vals
    keep = (ids >= 0) & (ids < n_seg)
    want = np.zeros(n_seg, np.int64)
    with np.errstate(over="ignore"):
        np.add.at(want, ids[keep], contrib[keep])
    mk = _offset if layout == "view" else _t
    t_ids, t_vals = mk(ids), mk(vals)
    t_base = None if base is None else mk(base)
    if layout == "view":
        assert t_vals.storage_offset() == 1 and t_vals.is_contiguous()
    port = TD.segment_sum(t_ids, t_vals, n_seg, base=t_base)
    _same(port, want)
    _same(port, JD.segment_sum(jnp.asarray(ids[keep]),
                               jnp.asarray(contrib[keep]), n_seg=n_seg))
    # the wrapper takes the plain version for CPU tensors, uncounted
    before = dict(KN.LAUNCHES)
    _same(KN.segment_sum(t_ids, t_vals, n_seg, base=t_base), want)
    assert KN.LAUNCHES == before


@pytest.mark.parametrize("offs,n,head", [
    ((0, 0, 0), 8, 0), ((1, 1, 1), 8, 3), ((2, 0, 0), 8, 2),
    ((1, 0, 0), 8, -1), ((0, 1, 0), 8, -1), ((0, 0, 1), 8, -1),
    ((3, 1, 1), 8, 1), ((1, 1, 1), 6, -1), ((0, 0, 0), 3, -1)])
def test_k4_width_follows_alignment(offs, n, head):
    """K4's vector body starts at the first row where the ids (4 bytes)
    and both int64 planes are 16-byte aligned; without one (or with too
    few rows for a vector) the scalar variant runs."""
    full = [torch.zeros(n + 8, dtype=dt)
            for dt in (torch.int32, torch.int64, torch.int64)]
    assert all(t.data_ptr() % 16 == 0 for t in full)
    ids, vals, base = (t[o:o + n] for t, o in zip(full, offs))
    assert KN._sum_head(n, ids, vals, base) == head
    if offs[2] == 0:
        assert KN._sum_head(n, ids, vals) == KN._sum_head(n, ids, vals, base)


@pytest.mark.parametrize("bad", ["short_base", "int32_base", "int64_ids",
                                 "short_vals", "2d"])
def test_k4_wrapper_contract(bad):
    """The wrapper checks dtypes and equal lengths on every device."""
    ids = torch.zeros(8, dtype=torch.int32)
    vals = torch.ones(8, dtype=torch.int64)
    base = torch.ones(8, dtype=torch.int64)
    err = ValueError
    if bad == "short_base":
        base = base[:7]
    elif bad == "int32_base":
        base, err = base.to(torch.int32), TypeError
    elif bad == "int64_ids":
        ids, err = ids.to(torch.int64), TypeError
    elif bad == "short_vals":
        vals = vals[:5]
    else:
        ids, vals, base = (t.reshape(2, 4) for t in (ids, vals, base))
    with pytest.raises(err):
        KN.segment_sum(ids, vals, 4, base=base)


def test_dense_max_matches_xla():
    rng = np.random.default_rng(9)
    cols = rng.integers(-9, 9, (4, 16, 4)).astype(np.int64)
    _same(TD.dense_max(_t(cols)), JD.dense_max(jnp.asarray(cols)))


# ------------------------------------------------------------ K3 plain

def _pad1(a, n, fill):
    out = np.full(n, fill, dtype=a.dtype)
    out[: len(a)] = a
    return out


def _k3_reference(p, s, src, idx, bp, bs, base):
    """The reference's Pallas kernel (interpret mode; its pads target a
    free row with NEUTRAL values, the engine's protocol) and its XLA twin
    (pads out of range) -> two (p, s, src) results."""
    from constdb_tpu.engine.tpu import TpuMergeEngine
    sp, n = len(p), len(idx)
    np2 = PD._pow2(max(n, 1))
    pad_row = TpuMergeEngine._scatter_pad_row(idx.astype(np.int64), n, sp) \
        if np2 > n else 0
    pallas = PD.scatter_pair_src(
        jnp.array(p), jnp.array(s), jnp.array(src),
        jnp.array(_pad1(idx, np2, pad_row)), jnp.array(_pad1(bp, np2, NT)),
        jnp.array(_pad1(bs, np2, NT)), np.int32(base), interpret=True)
    idx_x = np.concatenate([idx, (sp + np.arange(np2 - n)).astype(np.int32)])
    xla = JB.bulk_lww_src(jnp.array(p), jnp.array(s), jnp.array(src),
                          jnp.array(idx_x), jnp.array(_pad1(bp, np2, NT)),
                          jnp.array(_pad1(bs, np2, NT)), base)
    return pallas, xla


def _k3_case(rng, sp, n, base):
    """Unique rows; ties on the primary and on the whole pair, NEUTRAL_T
    on both sides and int64 extremes."""
    idx = rng.choice(sp, n, replace=False).astype(np.int32)
    p = rng.integers(-4, 4, sp).astype(np.int64)
    s = rng.integers(-4, 4, sp).astype(np.int64)
    p[rng.random(sp) < 0.2] = NT
    src = np.where(rng.random(sp) < 0.5, -1,
                   rng.integers(0, 50, sp)).astype(np.int32)
    bp = rng.integers(-4, 4, n).astype(np.int64)
    bs = rng.integers(-4, 4, n).astype(np.int64)
    bp[rng.random(n) < 0.15] = NT
    tie = rng.random(n) < 0.3
    bp[tie] = p[idx[tie]]
    full = tie & (rng.random(n) < 0.5)
    bs[full] = s[idx[full]]
    if n >= 4:
        bp[:2] = (I64_MAX, I64_MIN)
        bs[:2] = (I64_MIN, I64_MAX)
        p[idx[2]], s[idx[2]] = I64_MAX, I64_MIN
        bp[2], bs[2] = I64_MAX, I64_MIN + 1
    return p, s, src, idx, bp, bs, base


@pytest.mark.parametrize("sp,n,base", [(8, 1, 0), (16, 5, 977),
                                       (64, 64, (1 << 31) - 64),
                                       (128, 37, (1 << 31) - 37)])
def test_k3_scatter_pair_plain_matches_pallas_and_xla(sp, n, base):
    """K3's plain version (the wrapper on CPU tensors, exactly n unpadded
    rows) against the reference's Pallas kernel in interpret mode, its
    XLA twin and the port's bulk_lww_src; `base` up to 2^31 - n."""
    p, s, src, idx, bp, bs, base = _k3_case(
        np.random.default_rng(sp * 7 + n), sp, n, base)
    pallas, xla = _k3_reference(p, s, src, idx, bp, bs, base)
    before = dict(KN.LAUNCHES)
    port = KN.scatter_pair_src(_t(p), _t(s), _t(src), _t(idx), _t(bp),
                               _t(bs), base)
    assert KN.LAUNCHES == before  # CPU tensors: the plain version
    _same(port, tuple(pallas))
    _same(port, tuple(xla))
    _same(port, TB.bulk_lww_src(_t(p), _t(s), _t(src), _t(idx), _t(bp),
                                _t(bs), base))


def test_k3_never_reverts_rows_outside_idx():
    """The counterpart of the reference's pad-collision case: with no pad
    rows at all, row 0 and every row outside idx stay bit-unchanged, and
    the one real row's merge stands."""
    sp = 8
    p = np.arange(sp, dtype=np.int64) * 3
    s = np.arange(sp, dtype=np.int64) - 4
    src = np.arange(sp, dtype=np.int32) + 100
    idx = np.array([5], dtype=np.int32)
    bp = np.array([99], dtype=np.int64)
    bs = np.array([1], dtype=np.int64)
    got = KN.scatter_pair_src(_t(p), _t(s), _t(src), _t(idx), _t(bp),
                              _t(bs), 7)
    want_p, want_s, want_src = p.copy(), s.copy(), src.copy()
    want_p[5], want_s[5], want_src[5] = 99, 1, 7
    _same(got, (want_p, want_s, want_src))
    pallas, xla = _k3_reference(p, s, src, idx, bp, bs, 7)
    _same(got, tuple(pallas))
    _same(got, tuple(xla))


def _round_segment(rng, kind, sp, n, n_oob):
    """One segment of a steady round: its own planes, n rows of which
    n_oob target ids past the plane (dropped); ties, NEUTRAL_T and int64
    extremes as in _k3_case."""
    p, s, src, idx, bp, bs, _ = _k3_case(rng, sp, n, 0)
    if n_oob:
        pos = rng.choice(n, n_oob, replace=False)
        idx[pos] = sp + np.arange(n_oob, dtype=np.int32)
    if kind == KN.PAIR_SRC:
        return (p, s, src), idx, (bp, bs)
    if kind == KN.PAIR:
        return (p, s), idx, (bp, bs)
    return (p,), idx, (bp,)


# (kind, plane rows, rows, out-of-range rows); the last PAIR_SRC of each
# round sits at the top of the int32 src range
K3_ROUNDS = [
    [(KN.PAIR_SRC, 64, 20, 0), (KN.PAIR, 32, 7, 2), (KN.MAX1, 48, 9, 1),
     (KN.PAIR_SRC, 128, 37, 3)],
    [(KN.PAIR_SRC, 16, 5, 0), (KN.PAIR_SRC, 40, 12, 0), (KN.PAIR, 8, 3, 0),
     (KN.PAIR_SRC, 64, 64, 0), (KN.MAX1, 64, 30, 4)],
    [(KN.MAX1, 16, 16, 0), (KN.PAIR_SRC, 8, 1, 0)],
]


@pytest.mark.parametrize("r", range(len(K3_ROUNDS)))
def test_k3_round_plain_matches_pallas_and_xla_per_segment(r):
    """The fused round's plain version (the wrapper on CPU tensors) equals
    the reference applied segment by segment in order: PAIR_SRC against
    the Pallas kernel in interpret mode (segments with every id in range)
    and the XLA bulk_lww_src, PAIR against bulk_lww, MAX1 against
    bulk_max1; exact int64, out-of-range ids dropped."""
    rng = np.random.default_rng(100 + r)
    base = 1 << 31
    segs, refs = [], []
    for kind, sp, n, n_oob in K3_ROUNDS[r]:
        planes, idx, cols = _round_segment(rng, kind, sp, n, n_oob)
        b = 0
        if kind == KN.PAIR_SRC:
            base -= n
            b = base
        j = [jnp.array(x) for x in (*planes, idx, *cols)]
        if kind == KN.PAIR_SRC:
            want = [tuple(JB.bulk_lww_src(*j, b))]
            if not n_oob:
                want.append(tuple(_k3_reference(*planes, idx, *cols, b)[0]))
        elif kind == KN.PAIR:
            want = [tuple(JB.bulk_lww(*j)[:2])]
        else:
            want = [(JB.bulk_max1(*j),)]
        refs.append(want)
        segs.append(KN.Segment(kind, tuple(_t(x) for x in planes), _t(idx),
                               tuple(_t(x) for x in cols), b))
    before = dict(KN.LAUNCHES)
    KN.scatter_round(segs)
    assert KN.LAUNCHES == before  # CPU tensors: the plain version
    for g, want in zip(segs, refs):
        for w in want:
            _same(tuple(g.planes), w)


def test_k3_round_rejects_shared_planes_and_too_many_segments():
    """The fused launch's contract holds on every device: at most eight
    segments, and no plane written by two segments of one round."""
    p = torch.zeros(8, dtype=torch.int64)
    q = torch.zeros(8, dtype=torch.int64)
    idx = torch.tensor([1], dtype=torch.int32)
    one = torch.ones(1, dtype=torch.int64)
    seg = lambda plane: KN.Segment(KN.MAX1, (plane,), idx, (one,))  # noqa
    with pytest.raises(ValueError, match="share a plane"):
        KN.scatter_round([seg(p), seg(p)])
    planes = [torch.zeros(8, dtype=torch.int64) for _ in range(9)]
    with pytest.raises(ValueError, match="at most 8"):
        KN.scatter_round([seg(x) for x in planes])
    KN.scatter_round([seg(p), seg(q)])
    assert int(p[1]) == int(q[1]) == 1


# ------------------------------------------------------------ K5 plain

def _tensor_mat(rng, g, n, k, dtype):
    """Payloads holding NaN, +-0, +-inf and subnormals among normals."""
    mat = (rng.standard_normal((g, n, k)) * 9).astype(dtype)
    tiny = np.finfo(dtype).tiny / 8
    special = np.array([np.nan, 0.0, -0.0, np.inf, -np.inf, tiny, -tiny],
                       dtype=dtype)
    pick = rng.random((g, n, k)) < 0.15
    mat[pick] = special[rng.integers(0, len(special), pick.sum())]
    # whole columns of signed zeros in both orders (the min/max tie rule)
    mat[:, :, 0] = 0.0
    mat[:, ::2, 1] = -0.0
    mat[:, 1::2, 1] = 0.0
    return mat


def _bits(a):
    a = np.ascontiguousarray(np.asarray(a))
    return a.view(np.int64 if a.dtype == np.float64 else np.int32)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("n", [1, 2, 3, 8])
@pytest.mark.parametrize("strat", ["sum", "avg", "maxmag", "trimmed-mean"])
def test_k5_tensor_reduce_plain_matches_reference(strat, n, dtype):
    """K5's plain version (and the avg composition around it) against
    crdt.tensor.reduce_rows, the reference's XLA twins and, for f32, its
    Pallas kernel in interpret mode: bit-identical, NaN included
    (compared as integers), for n in {1, 2, 3, 8} (n = 8 has the first
    non-pow2 trimmed divisor)."""
    from constdb_tpu.crdt import tensor as JT
    from constdb_tpu_torch.crdt import tensor as T
    sid = T.STRATEGY_IDS[strat]
    rng = np.random.default_rng(sid * 100 + n * 3 + (dtype == np.float64))
    g, k = 4, 96
    mat = _tensor_mat(rng, g, n, k, dtype)
    cnts = rng.integers(1, 9, size=(g, n)).astype(np.int64)
    order = np.arange(n)
    with np.errstate(all="ignore"):
        host = np.stack([JT.reduce_rows(sid, mat[j], cnts[j], order, order)
                         for j in range(g)])
    # the pool form: the [g * n] contributor rows scattered into a pool
    pool = np.zeros((g * n + 5, k), dtype)
    rows = rng.permutation(g * n + 5)[: g * n]
    pool[rows] = mat.reshape(g * n, k)
    idx = rows.astype(np.int32)
    cf = cnts.astype(dtype)
    div = dtype(n if n <= 2 else n - 2)
    jbuf, jidx, jc = jnp.asarray(pool), jnp.asarray(idx), jnp.asarray(cf)
    if sid == T.STRAT_AVG:
        tots = cf[:, 0].copy()
        for i in range(1, n):
            tots = tots + cf[:, i]
        tots = tots.reshape(g, 1)
        wm = TD.tensor_take_scale(_t(pool), _t(idx), _t(cf), n=n, g=g)
        port = TD.tensor_div(
            KN.tensor_take_reduce(wm.reshape(g * n, k),
                                  torch.arange(g * n, dtype=torch.int32),
                                  div, strat=T.STRAT_SUM, n=n, g=g),
            _t(tots))
        assert torch.equal(_bits_t(TD.tensor_scale(_t(mat), _t(cf))),
                           _bits_t(wm))
        jwm = JD.tensor_take_scale(jbuf, jidx, jc, n=n, g=g)
        refs = [JD.tensor_sum_div(jwm, jnp.asarray(tots), n=n)]
        if dtype == np.float32:
            refs.append(JD.tensor_div(
                PD.tensor_reduce(_pad_k(np.asarray(jwm)), jc, div,
                                 strat=T.STRAT_SUM, n=n,
                                 interpret=True)[:, :k],
                jnp.asarray(tots)))
        assert torch.equal(_bits_t(TD.tensor_sum_div(wm, _t(tots), n=n)),
                           _bits_t(port))
    else:
        port = KN.tensor_take_reduce(_t(pool), _t(idx), div, strat=sid,
                                     n=n, g=g)
        refs = [JD.tensor_take_reduce(jbuf, jidx, div, strat=sid, n=n, g=g),
                JD.tensor_reduce(jnp.asarray(mat), jc, div, strat=sid, n=n)]
        if dtype == np.float32:
            refs.append(PD.tensor_reduce(_pad_k(mat), jc, div, strat=sid,
                                         n=n, interpret=True)[:, :k])
        assert torch.equal(_bits_t(TD.tensor_reduce(_t(mat), _t(cf), div,
                                                    strat=sid, n=n)),
                           _bits_t(port))
    np.testing.assert_array_equal(_bits(port.numpy()), _bits(host))
    # the reference's device twins: XLA on the CPU flushes subnormals to
    # zero (numpy does not), so they are held only on columns free of
    # them, and its NaN results may carry another sign (IEEE leaves a
    # NaN's sign and payload open), so a NaN matches any NaN there
    # (ROADMAP.md, queue 3)
    sub = lambda a: (a != 0) & (np.abs(a) < np.finfo(dtype).tiny)  # noqa
    with np.errstate(invalid="ignore"):
        keep = ~(sub(mat).any(axis=1) | sub(host))
    assert keep.mean() > 0.5
    got = port.numpy()
    for r in refs:
        r = np.asarray(r)
        same = (_bits(got) == _bits(r)) | (np.isnan(got) & np.isnan(r))
        assert same[keep].all()


def _pad_k(mat):
    """The Pallas kernel's lane padding: K up to a multiple of 512."""
    g, n, k = mat.shape
    out = np.zeros((g, n, 512), mat.dtype)
    out[:, :, :k] = mat
    return jnp.asarray(out)


def _bits_t(t):
    return t.contiguous().view(torch.int64 if t.dtype == torch.float64
                               else torch.int32)


def test_k5_min_max_follow_numpy_not_torch():
    """Trimmed-mean's min and max are selects with numpy's rule
    (np.minimum / np.maximum: keep the running value when strictly
    smaller / larger or NaN, else take the new one), where torch.minimum
    and torch.maximum order signed zeros differently; a NaN anywhere in a
    column makes the result NaN."""
    from constdb_tpu_torch.crdt import tensor as T
    a = np.array([0.0, -0.0, 0.0, np.nan, 1.0], np.float32)
    b = np.array([-0.0, 0.0, 0.0, 1.0, np.nan], np.float32)
    sel_mn = torch.where((_t(a) < _t(b)) | torch.isnan(_t(a)), _t(a), _t(b))
    sel_mx = torch.where((_t(a) > _t(b)) | torch.isnan(_t(a)), _t(a), _t(b))
    np.testing.assert_array_equal(_bits(sel_mn.numpy()),
                                  _bits(np.minimum(a, b)))
    np.testing.assert_array_equal(_bits(sel_mx.numpy()),
                                  _bits(np.maximum(a, b)))
    assert not np.array_equal(
        _bits(torch.minimum(_t(a), _t(b)).numpy()), _bits(np.minimum(a, b)))
    mat = np.array([[[0.0, -0.0, np.nan, 1.0, 2.0],
                     [-0.0, 0.0, 2.0, np.nan, 5.0],
                     [0.0, -0.0, 3.0, 4.0, -1.0]]], dtype=np.float32)
    port = TD.tensor_reduce(_t(mat), None, np.float32(1),
                            strat=T.STRAT_TRIMMED, n=3)
    from constdb_tpu.crdt import tensor as JT
    want = JT.reduce_rows(JT.STRAT_TRIMMED, mat[0], np.ones(3),
                          np.arange(3), np.arange(3))
    np.testing.assert_array_equal(_bits(port.numpy()[0]), _bits(want))


def test_pool_scatter_updates_in_place():
    buf = torch.zeros((6, 3))
    vals = torch.arange(6, dtype=torch.float32).reshape(2, 3)
    out = TD.pool_scatter(buf, torch.tensor([4, 1], dtype=torch.int32), vals)
    assert out is buf
    assert torch.equal(buf[4], vals[0]) and torch.equal(buf[1], vals[1])
    assert not buf[[0, 2, 3, 5]].any()


@pytest.mark.parametrize("k", [96, 37])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("n", [1, 2, 3, 8])
def test_k5_avg_fused_plain_matches_jax_chain(n, dtype, k):
    """K5's avg (the wrapper with count weights and totals, on CPU
    tensors: its plain scale -> sum -> divide chain) against the JAX
    chain tensor_take_scale -> tensor_reduce(STRAT_SUM) -> tensor_div,
    the Pallas kernel in interpret mode for f32, and reduce_rows: bit for
    bit against reduce_rows, and against the JAX twins on subnormal-free
    columns with a NaN matching any NaN; an odd K included."""
    from constdb_tpu.crdt import tensor as JT
    from constdb_tpu_torch.crdt import tensor as T
    rng = np.random.default_rng(n * 10 + k + (dtype == np.float64))
    g = 5
    mat = _tensor_mat(rng, g, n, k, dtype)
    cnts = rng.integers(1, 9, size=(g, n)).astype(np.int64)
    order = np.arange(n)
    with np.errstate(all="ignore"):
        host = np.stack([JT.reduce_rows(JT.STRAT_AVG, mat[j], cnts[j], order,
                                        order) for j in range(g)])
    pool = np.zeros((g * n + 3, k), dtype)
    rows = rng.permutation(g * n + 3)[: g * n]
    pool[rows] = mat.reshape(g * n, k)
    idx = rows.astype(np.int32)
    cf = cnts.astype(dtype)
    tot = cf[:, 0].copy()
    for i in range(1, n):
        tot = tot + cf[:, i]
    before = dict(KN.LAUNCHES)
    port = KN.tensor_take_reduce(_t(pool), _t(idx), dtype(1),
                                 strat=T.STRAT_AVG, n=n, g=g,
                                 w=_t(cf.reshape(-1)), tot=_t(tot))
    assert KN.LAUNCHES == before
    got = port.numpy()
    np.testing.assert_array_equal(_bits(got), _bits(host))
    jwm = JD.tensor_take_scale(jnp.asarray(pool), jnp.asarray(idx),
                               jnp.asarray(cf), n=n, g=g)
    jtot = jnp.asarray(tot.reshape(g, 1))
    refs = [JD.tensor_div(JD.tensor_reduce(jwm, jnp.asarray(cf), dtype(1),
                                           strat=JT.STRAT_SUM, n=n), jtot)]
    if dtype == np.float32:
        refs.append(JD.tensor_div(
            PD.tensor_reduce(_pad_k(np.asarray(jwm)), jnp.asarray(cf),
                             dtype(1), strat=JT.STRAT_SUM, n=n,
                             interpret=True)[:, :k], jtot))
    sub = lambda a: (a != 0) & (np.abs(a) < np.finfo(dtype).tiny)  # noqa
    wm = mat * cf[:, :, None]
    with np.errstate(invalid="ignore"):
        keep = ~(sub(mat).any(axis=1) | sub(wm).any(axis=1) | sub(host))
    assert keep.mean() > 0.4
    for r in refs:
        r = np.asarray(r)
        same = (_bits(got) == _bits(r)) | (np.isnan(got) & np.isnan(r))
        assert same[keep].all()
