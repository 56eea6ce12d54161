"""Plain PyTorch versions of the fold, sum and tensor kernels.

These are the reference semantics of the hand-written CUDA kernels in
ops/kernels.py (K1 `merge_elems`, which ops/bulk.py `fold_apply`
composes with its apply, K2 `merge_counters`, K4 `segment_sum`, K5
`tensor_take_reduce`): the CPU path and the tests run them, and
chip_smoke.py holds each kernel against them on the card.  On
the card the main path calls only the avg stages and the pool scatter
below, which have no kernel of their own.

[R, S] stacks hold one row per replica batch; the fold reduces over R.
Absent slots carry NEUTRAL_T and lose every comparison.

The folds compute TRUE lexicographic maxima, as the reference package's
Pallas kernels do (ops/pallas_dense.py `_lex_mask`), and not the XLA
twins' NEUTRAL_T-filled candidate max: the two reference functions
disagree only when every tied secondary value is below NEUTRAL_T
(-2^62), and the port follows the Pallas kernel (see ROADMAP.md,
queue 3).
"""

from __future__ import annotations

import torch

_I64 = torch.int64
_MIN64 = -(1 << 63)


def _lex_first(p: torch.Tensor, s: torch.Tensor):
    """[R, S] (primary, secondary) stacks -> per-column lexicographic max
    (p[S], s[S]) and the FIRST row achieving it (win[S] int64)."""
    p_max = p.amax(dim=0)
    on_p = p == p_max
    s_max = torch.where(on_p, s, _MIN64).amax(dim=0)
    winner = on_p & (s == s_max)
    # argmax returns the first maximal index: the first winning row
    win = winner.to(torch.int32).argmax(dim=0).to(_I64)
    return p_max, s_max, win


def dense_merge_elems(at, an, dt):
    """[R, S] element merge: lexicographic (add_t, add_node) winner, the
    first row achieving it, and an independent max of del_t.
    -> (at[S], an[S], dt[S], win_batch[S] int64)."""
    at_max, an_max, win = _lex_first(at, an)
    return at_max, an_max, dt.amax(dim=0), win


def dense_merge_lww(t, n):
    """[R, S] plain LWW slots (registers): lexicographic (t, node) winner.
    -> (t[S], n[S], win_batch[S]) — K1's register variant."""
    return _lex_first(t, n)


def dense_merge_counters(vals, ts):
    """[R, S] per-slot (value @ uuid) LWW with max-value tie, i.e. the
    lexicographic (uuid, value) max.  -> (val[S], t[S])."""
    t_max, v_max, _ = _lex_first(ts, vals)
    return v_max, t_max


def dense_max(cols):
    """[R, S, C] pointwise max over R — envelopes."""
    return cols.amax(dim=0)


def segment_sum(ids, vals, n_seg: int, base=None):
    """Per-segment int64 sums of `vals - base` (`vals` alone when `base`
    is None) over unsorted segment ids, exact mod 2^64; ids outside
    [0, n_seg) are skipped (counter-sum re-derivation: ids = slot kid,
    vals = val, base = base)."""
    ids = ids.to(_I64)
    vals = vals.to(_I64)
    if base is not None:
        vals = vals - base.to(_I64)   # int64 wraps: two's complement
    keep = (ids >= 0) & (ids < n_seg)
    if not bool(keep.all()):
        ids, vals = ids[keep], vals[keep]
    out = torch.zeros(n_seg, dtype=_I64, device=vals.device)
    return out.index_add_(0, ids, vals)


# ----------------------------------------------------- tensor registers
# Plain versions for the tensor-register family (crdt/tensor.py).  The
# reductions unroll the canonical sequential operation chain of
# crdt.tensor.reduce_rows, the same IEEE operations in the same order,
# so host and device reads are bit-identical (the canonical-order law).
# `tensor_take_reduce` is the plain version of K5 (ops/kernels.py).


def pool_scatter(buf, idx, vals):
    """Resident payload pool update, IN PLACE: buf [C, Kp] <- vals [W, Kp]
    at unique rows idx [W] int32 (the reference donates its buffer)."""
    buf[idx.to(_I64)] = vals
    return buf


def _take(buf, idx, n: int, g: int):
    return buf.index_select(0, idx.to(_I64)).reshape(g, n, buf.shape[1])


def tensor_scale(mat, cnts):
    """avg stage 1: weight the [G, n, Kp] contributor slab by the [G, n]
    counts.  A separate operation on purpose: the products round here,
    as numpy's do, and can never contract with the sum into an FMA."""
    return mat * cnts[:, :, None]


def tensor_div(acc, tot):
    """avg stage 3: [G, Kp] / [G, 1] count totals (the totals accumulate
    on the host with the same sequential dtype chain)."""
    return acc / tot


def tensor_take_scale(buf, idx, cnts, *, n: int, g: int):
    """avg stage 1 with the pool gather: [G, n, Kp] rounded products."""
    return _take(buf, idx, n, g) * cnts[:, :, None]


def tensor_sum_div(wmat, tot, *, n: int):
    """avg stages 2 and 3: sequential sum of the rounded products, then
    the count-total divide."""
    acc = wmat[:, 0]
    for i in range(1, n):
        acc = acc + wmat[:, i]
    return acc / tot


def _div(acc, div):
    # divide by a tensor, never by a Python scalar: PyTorch's CUDA divide
    # turns a host-scalar divisor into a reciprocal multiply, which rounds
    # differently from the host's true division
    return acc / torch.full_like(acc, float(div))


def _reduce_chain(mat, strat: int, n: int, div):
    """The canonical sequential fold over a [G, n, Kp] stack, branch for
    branch crdt.tensor.reduce_rows.  `div` is the trimmed-mean divisor
    (n or n - 2).  Trimmed-mean's min and max are selects with numpy's
    rule (np.minimum / np.maximum): keep the running value when it is
    strictly smaller (larger) or NaN, else take the new one, so NaN
    propagates and a +0/-0 tie takes the newer operand, bit for bit
    (torch.minimum and torch.maximum order signed zeros differently)."""
    from ..crdt.tensor import STRAT_MAXMAG, STRAT_SUM, STRAT_TRIMMED
    if strat == STRAT_SUM or (strat == STRAT_TRIMMED and n <= 2):
        acc = mat[:, 0]
        for i in range(1, n):
            acc = acc + mat[:, i]
        return _div(acc, div) if strat == STRAT_TRIMMED else acc
    if strat == STRAT_MAXMAG:
        acc = mat[:, 0]
        for i in range(1, n):
            x = mat[:, i]
            acc = torch.where(x.abs() > acc.abs(), x, acc)
        return acc
    if strat == STRAT_TRIMMED:
        s = mn = mx = mat[:, 0]
        for i in range(1, n):
            x = mat[:, i]
            s = s + x
            mn = torch.where((mn < x) | torch.isnan(mn), mn, x)
            mx = torch.where((mx > x) | torch.isnan(mx), mx, x)
        return _div(s - mn - mx, div)
    raise ValueError(f"tensor_reduce: strategy {strat} reduces on host")


def tensor_take_reduce(buf, idx, div, *, strat: int, n: int, g: int,
                       w=None, tot=None):
    """Pool gather + strategy reduction -> [G, Kp]: `buf` [C, Kp] pool,
    `idx` [G * n] int32 pool rows (n contributors per group in canonical
    order).  avg takes the count weights `w` [G * n] and totals `tot`
    [G] (payload dtype) and stays the separate chain tensor_take_scale
    -> STRAT_SUM -> tensor_div, which K5 fuses; lww picks a row."""
    from ..crdt.tensor import STRAT_AVG, STRAT_SUM
    if strat == STRAT_AVG:
        wmat = tensor_take_scale(buf, idx, w.reshape(g, n), n=n, g=g)
        return tensor_div(_reduce_chain(wmat, STRAT_SUM, n, div),
                          tot.reshape(g, 1))
    return _reduce_chain(_take(buf, idx, n, g), strat, n, div)


def tensor_reduce(mat, cnts, div, *, strat: int, n: int):
    """[G, n, Kp] contributor stacks in canonical order -> [G, Kp]; the
    counts only weight avg, which composes outside."""
    del cnts
    return _reduce_chain(mat, strat, n, div)
