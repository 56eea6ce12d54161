"""Compact bulk-merge ops: per-batch gather -> merge -> scatter on device.

The torch twin of the reference package's ops/bulk.py, the
transfer-optimal path for bulk merges (snapshot ingest, replica
catch-up).  The host ships each batch as COMPACT rows (int32 slot ids
plus value columns) and folds batches into per-slot device state, one
call per batch.  Where JAX donates the state buffers, these functions
update the state tensors IN PLACE and return them, so the resident
planes never copy between calls.

Within one batch every slot appears at most once
(`ColumnarBatch.rows_unique_per_slot`), so the gather-compare-write
sequence below never sees two writers of one row; collisions exist only
ACROSS batches, which the call sequence serializes.

Padding protocol (kept from the reference): rows are padded to a
power-of-two count, and padded rows get slot id = state_size + offset
(distinct, out of range).  torch has no scatter `mode="drop"`, so every
function masks the pad rows out before it writes; gathers clamp, and win
flags are False on pad rows.  Batch value columns may arrive as int32
(the engine halves upload bytes where values fit); they are promoted to
int64 before any compare.

Semantics mirror crdt/semantics.py exactly:
  * LWW pair: (t, writer-node) lexicographic max — registers, element adds;
  * counter slot pair: (time, value) lexicographic max — max-value on ties;
  * plain max: envelopes ct/mt/dt/expire, element del_t.

The *_src variants track DEFERRED win resolution: the winning batch row's
host value-pool id (`base + i`, derived on device, never uploaded) lands
in a resident int32 `src` plane, which the engine downloads once at
flush to resolve win values and rebuild the winner-carried columns.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..crdt.semantics import NEUTRAL_T
from . import dense as D

__all__ = ["NEUTRAL_T", "device_full", "bulk_max", "bulk_max1", "bulk_lww",
           "bulk_counters", "bulk_counters_vu", "bulk_counters_vu_src",
           "bulk_counters_src", "bulk_elems",
           "bulk_lww_src", "bulk_elems_src_nodt",
           "bulk_lww_src_iota", "bulk_counters_vu_src_iota",
           "bulk_elems_src_nodt_iota", "fold_apply", "gather_rows",
           "idx_iota",
           "PAIR_SRC", "PAIR", "MAX1", "Segment", "scatter_round"]

_I64 = torch.int64
_I32 = torch.int32


def gather_rows(state: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Compact row gather ([D] or [D, C]); the resident plane stays put."""
    return state.index_select(0, idx.to(_I64))


def device_full(n: int, fill: int, i32: bool = False,
                device: torch.device = torch.device("cpu")) -> torch.Tensor:
    """Neutral state created ON device (no upload of fill values).  `i32`
    for the src plane — pool ids fit int32, halving its flush download."""
    return torch.full((n,), fill, dtype=_I32 if i32 else _I64, device=device)


class _Rows:
    """One batch's row addressing against a state of `size` rows: the
    clamped gather index, the in-range mask, and the in-range positions
    the writes go to (pad rows dropped)."""

    __slots__ = ("ic", "ok", "pos", "dst")

    def __init__(self, idx: torch.Tensor, size: int,
                 nrows: int | None = None) -> None:
        idx = idx.to(_I64)
        self.ic = idx.clamp(max=size - 1)
        if nrows is not None:
            # contiguous iota rows: the real rows are exactly the first
            # `nrows` positions (a host int — no device mask needed)
            self.ok = torch.arange(idx.shape[0], device=idx.device) < nrows
            self.pos = slice(0, nrows)
        else:
            self.ok = idx < size
            self.pos = self.ok
        self.dst = idx[self.pos]

    def put(self, state: torch.Tensor, new: torch.Tensor) -> None:
        state[self.dst] = new[self.pos]


def _pair_win(cv, ct, vi, ti, in_range):
    """Lexicographic (t, v) winner — shared by registers/elements/counters
    (the tie-rule core of crdt/semantics.py lww_wins/merge_counter_slot)."""
    return ((ti > ct) | ((ti == ct) & (vi > cv))) & in_range


def bulk_max(state, idx, cols):
    """state [Sp, C] <- elementwise max with one batch; idx [Np] int32,
    cols [Np, C].  Envelope merge (ct/mt/dt/expire are all max-merges)."""
    r = _Rows(idx, state.shape[0])
    r.put(state, torch.maximum(state[r.ic], cols.to(_I64)))
    return state


def bulk_max1(state, idx, vals):
    """One-column twin of bulk_max: state [Sp] <- per-slot max."""
    r = _Rows(idx, state.shape[0])
    r.put(state, torch.maximum(state[r.ic], vals.to(_I64)))
    return state


def _lww(t, n, r: _Rows, bt, bn):
    ct, cn = t[r.ic], n[r.ic]
    bt, bn = bt.to(_I64), bn.to(_I64)
    win = _pair_win(cn, ct, bn, bt, r.ok)
    r.put(t, torch.where(win, bt, ct))
    r.put(n, torch.where(win, bn, cn))
    return win


def bulk_lww(t, n, idx, bt, bn):
    """Plain LWW slots (registers): lexicographic (t, node) winner.
    -> (t [Sp], n [Sp], win [Np] bool) — win marks batch rows whose VALUE
    must replace the slot's value."""
    win = _lww(t, n, _Rows(idx, t.shape[0]), bt, bn)
    return t, n, win


def _counter_pair(val, uuid, r: _Rows, bv, bt):
    cv, ct = val[r.ic], uuid[r.ic]
    bv, bt = bv.to(_I64), bt.to(_I64)
    win = _pair_win(cv, ct, bv, bt, r.ok)
    r.put(val, torch.where(win, bv, cv))
    r.put(uuid, torch.where(win, bt, ct))
    return win


def bulk_counters_vu(val, uuid, idx, bv, bt):
    """Counter value pair only — batches with a neutral base plane (no
    counter deletes anywhere in the batch) skip the base columns."""
    _counter_pair(val, uuid, _Rows(idx, val.shape[0]), bv, bt)
    return val, uuid


def bulk_counters(val, uuid, base, base_t, idx, bv, bt, bb, bbt):
    """Counter slots: two independent (value @ time) pairs per slot, each
    LWW on time with max-value tie-break.  -> merged (val, uuid, base,
    base_t), all [Sp]."""
    r = _Rows(idx, val.shape[0])
    _counter_pair(val, uuid, r, bv, bt)
    _counter_pair(base, base_t, r, bb, bbt)
    return val, uuid, base, base_t


def _iota_src(base, np_: int, device) -> torch.Tensor:
    """Pool ids of one batch: consecutive from `base` (int32 on device)."""
    return int(base) + torch.arange(np_, dtype=_I32, device=device)


def _put_src(src, r: _Rows, win, base, np_: int):
    cs = src[r.ic]
    r.put(src, torch.where(win, _iota_src(base, np_, src.device), cs))


def idx_iota(r0, nrows, np_: int, size: int, device) -> torch.Tensor:
    """Contiguous batch idx derived on device: [r0, r0+nrows) then
    out-of-range pad slots — same protocol as the host-built vector."""
    i = torch.arange(np_, dtype=_I32, device=device)
    return torch.where(i < int(nrows), int(r0) + i, size + i)


def bulk_lww_src(t, n, src, idx, bt, bn, base):
    """bulk_lww with deferred win resolution: winners scatter
    `base + iota` into `src`."""
    r = _Rows(idx, t.shape[0])
    win = _lww(t, n, r, bt, bn)
    _put_src(src, r, win, base, idx.shape[0])
    return t, n, src


def bulk_lww_src_iota(t, n, src, r0, nrows, bt, bn, base, *, np_: int):
    """bulk_lww_src for CONTIGUOUS batch rows: the idx vector is derived on
    device from (r0, nrows) — no index upload."""
    idx = idx_iota(r0, nrows, np_, t.shape[0], t.device)
    r = _Rows(idx, t.shape[0], nrows=int(nrows))
    win = _lww(t, n, r, bt, bn)
    _put_src(src, r, win, base, np_)
    return t, n, src


def bulk_counters_vu_src(val, uuid, src, idx, bv, bt, base):
    """bulk_counters_vu with deferred win resolution: the merged val/uuid
    pair is RECONSTRUCTED at flush from the host pool via `src`."""
    r = _Rows(idx, val.shape[0])
    win = _counter_pair(val, uuid, r, bv, bt)
    _put_src(src, r, win, base, idx.shape[0])
    return val, uuid, src


def bulk_counters_vu_src_iota(val, uuid, src, r0, nrows, bv, bt, base, *,
                              np_: int):
    """bulk_counters_vu_src for CONTIGUOUS batch rows."""
    idx = idx_iota(r0, nrows, np_, val.shape[0], val.device)
    r = _Rows(idx, val.shape[0], nrows=int(nrows))
    win = _counter_pair(val, uuid, r, bv, bt)
    _put_src(src, r, win, base, np_)
    return val, uuid, src


def bulk_counters_src(val, uuid, base_c, base_t, src, idx, bv, bt, bb, bbt,
                      base):
    """bulk_counters with deferred win resolution on the val/uuid pair
    (the base pair keeps its own winner on device and downloads when
    written — counter deletes are rare)."""
    r = _Rows(idx, val.shape[0])
    win = _counter_pair(val, uuid, r, bv, bt)
    _put_src(src, r, win, base, idx.shape[0])
    _counter_pair(base_c, base_t, r, bb, bbt)
    return val, uuid, base_c, base_t, src


def bulk_elems(at, an, dt, idx, bat, ban, bdt):
    """Element slots (set members / dict fields): add side = lexicographic
    (add_t, add_node) LWW, del side = plain max.
    -> (at, an, dt [Sp], win [Np] bool) — win marks rows whose dict VALUE
    must replace the slot's value."""
    r = _Rows(idx, at.shape[0])
    win = _lww(at, an, r, bat, ban)
    r.put(dt, torch.maximum(dt[r.ic], bdt.to(_I64)))
    return at, an, dt, win


# An element add side without its del side IS the plain LWW pair.
bulk_elems_src_nodt = bulk_lww_src
bulk_elems_src_nodt_iota = bulk_lww_src_iota


def fold_apply(at, an, idx, st_at, st_an, dt=None, st_dt=None):
    """The plain version of K1 with its apply (ops/kernels.py
    fold_apply): the [R, S] aligned fold (dense_merge_elems, or
    dense_merge_lww when `dt` is None), then bulk_elems (bulk_lww) of its
    winners into the state planes, IN PLACE.  idx [S] int32 holds the
    state rows, or pad rows at or beyond the planes' size, which write
    nothing.  -> win [S] int32: the fold's winning batch row where the
    batch beat the state row, else -1."""
    if dt is None:
        ft, fn, winb = D.dense_merge_lww(at, an)
        _, _, win = bulk_lww(st_at, st_an, idx, ft, fn)
    else:
        ft, fn, fd, winb = D.dense_merge_elems(at, an, dt)
        win = bulk_elems(st_at, st_an, st_dt, idx, ft, fn, fd)[3]
    return torch.where(win, winb.to(_I32), -1)


# ------------------------------------------------------ steady scatter round
# One steady round's in-place scatters: the plain version of K3
# (ops/kernels.py scatter_round), which fuses them into one launch.
# Segment kinds:
PAIR_SRC = 0  # LWW pair with a win-source plane (bulk_lww_src)
PAIR = 1      # LWW pair without one: the counter base pair (bulk_lww)
MAX1 = 2      # plain max into one plane: the element del_t (bulk_max1)


class Segment(NamedTuple):
    """One scatter of a round.  `planes` = (p, s, src) for PAIR_SRC,
    (p, s) for PAIR, (p,) for MAX1, updated IN PLACE; `idx` [n] int32
    unique plane rows; `cols` = (bp, bs) for the pairs, (bp,) for MAX1,
    [n] int64; `base` the src id of row 0 (PAIR_SRC)."""
    kind: int
    planes: tuple
    idx: torch.Tensor
    cols: tuple
    base: int = 0


def scatter_round(segs) -> None:
    """Apply the segments in order, each with its plain bulk op.  Every
    segment of a round targets its own planes."""
    for g in segs:
        if g.kind == PAIR_SRC:
            bulk_lww_src(*g.planes, g.idx, *g.cols, g.base)
        elif g.kind == PAIR:
            bulk_lww(*g.planes, g.idx, *g.cols)
        elif g.kind == MAX1:
            bulk_max1(*g.planes, g.idx, *g.cols)
        else:
            raise ValueError(f"scatter_round: unknown segment kind {g.kind}")
