"""Plain PyTorch versions of the fold and sum kernels.

These are the reference semantics of the hand-written CUDA kernels in
ops/kernels.py (K1 `merge_elems`, K2 `merge_counters`, K4
`segment_sum`): the CPU path and the tests run them, and chip_smoke.py
holds each kernel against them on the card.  Nothing on the card's main
path calls them.

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
    -> (t[S], n[S], win_batch[S]) — K1 with an all-zero del side."""
    return _lex_first(t, n)


def dense_merge_counters(vals, ts):
    """[R, S] per-slot (value @ uuid) LWW with max-value tie, i.e. the
    lexicographic (uuid, value) max.  -> (val[S], t[S])."""
    t_max, v_max, _ = _lex_first(ts, vals)
    return v_max, t_max


def dense_max(cols):
    """[R, S, C] pointwise max over R — envelopes."""
    return cols.amax(dim=0)


def segment_sum(ids, vals, n_seg: int):
    """Per-segment int64 sums over unsorted segment ids, exact mod 2^64
    (counter-sum re-derivation: ids = slot kid, vals = val - base)."""
    out = torch.zeros(n_seg, dtype=_I64, device=vals.device)
    return out.index_add_(0, ids.to(_I64), vals.to(_I64))
