"""Batched CRDT merge reductions over touched slots (scatter path).

The torch twin of the reference package's ops/segment.py: the
non-resident fallback the engine takes for sparse merges and for batches
whose rows are NOT unique per slot.  Duplicate slot ids within one batch
are the normal case here, so every reduction is a scatter-max
(`scatter_reduce_(..., "amax")`), which folds collisions natively.

  * counter slots:  per-(key,node) LWW = segment-max on uuid, then a masked
                    segment-max on value for the uuid tie;
  * elements:       add side = lexicographic (time, node) segment-max in two
                    scatter passes + winning-row recovery; del side = plain
                    segment-max;
  * envelopes:      four aligned scatter-max reductions.

Rows are padded to power-of-two counts (the engine keeps the reference's
padding protocol): padded rows carry t = NEUTRAL_T and a dummy tail slot
id, so they lose every reduction and land in a slot that is sliced off.
All inputs are int64 tensors on one device; nothing here syncs the host.
"""

from __future__ import annotations

import torch

# loses to every real timestamp (real uuids are >= 0; element add_t >= 0);
# canonical definition lives in the crdt layer
from ..crdt.semantics import NEUTRAL_T


def next_pow2(n: int) -> int:
    p = 1
    while p < n:
        p <<= 1
    return p


def _smax(cur: torch.Tensor, slot_ids: torch.Tensor,
          vals: torch.Tensor) -> torch.Tensor:
    """cur (copied) <- per-slot max with the rows scattered at slot_ids."""
    return cur.clone().scatter_reduce_(0, slot_ids, vals, "amax")


def merge_counters(slot_ids, vals, ts, cur_val, cur_t, n_slots: int):
    """Merge incoming counter rows into per-slot current state.

    slot_ids/vals/ts: incoming rows (padded; padded rows have ts=NEUTRAL_T
    and slot_ids pointing at the dummy tail slot).
    cur_val/cur_t: (n_slots,) current state; new slots carry (0, NEUTRAL_T).
    -> (new_val, new_t) per slot.
    """
    del n_slots  # shape is carried by cur_*
    t_max = _smax(cur_t, slot_ids, ts)
    # value on the max-uuid write; max(value) breaks exact-uuid ties
    cand_cur = torch.where(cur_t == t_max, cur_val, NEUTRAL_T)
    row_cand = torch.where(ts == t_max[slot_ids], vals, NEUTRAL_T)
    new_val = cand_cur.scatter_reduce_(0, slot_ids, row_cand, "amax")
    return new_val, t_max


def merge_elems(slot_ids, add_t, add_node, del_t, cur_at, cur_an, cur_dt,
                n_slots: int):
    """Merge incoming element rows (set members / dict fields) into per-slot
    current state.

    -> (at, an, dt, win_row) per slot; win_row is the incoming row index
    whose value should be taken, or -1 when the current write survives.
    """
    n = slot_ids.shape[0]
    at_max = _smax(cur_at, slot_ids, add_t)
    # lexicographic tie-break on writer node
    cand_cur = torch.where(cur_at == at_max, cur_an, NEUTRAL_T)
    row_cand = torch.where(add_t == at_max[slot_ids], add_node, NEUTRAL_T)
    an_max = cand_cur.scatter_reduce_(0, slot_ids, row_cand, "amax")
    # recover the winning incoming row (unique: (t, node) identifies a write)
    rows = torch.arange(n, dtype=torch.int64, device=slot_ids.device)
    winner_rows = torch.where(
        (add_t == at_max[slot_ids]) & (add_node == an_max[slot_ids]), rows, -1)
    win_row = torch.full((n_slots,), -1, dtype=torch.int64,
                         device=slot_ids.device)
    win_row.scatter_reduce_(0, slot_ids, winner_rows, "amax")
    # the current write wins outright (or ties as the same write)
    cur_wins = (cur_at == at_max) & (cur_an == an_max)
    win_row = torch.where(cur_wins, -1, win_row)
    dt = _smax(cur_dt, slot_ids, del_t)
    return at_max, an_max, dt, win_row


def scatter_max4(slot_ids, a, b, c, d, cur_a, cur_b, cur_c, cur_d,
                 n_slots: int):
    """Four aligned scatter-max reductions (key envelope ct/mt/dt/expire)."""
    del n_slots
    return (_smax(cur_a, slot_ids, a), _smax(cur_b, slot_ids, b),
            _smax(cur_c, slot_ids, c), _smax(cur_d, slot_ids, d))
