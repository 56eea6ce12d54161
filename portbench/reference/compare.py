"""Mismatch counts between a keyspace read back and the reference's.

Keys are matched by their bytes, counter slots by (key, node) and element
rows by (key, member); every other column is compared exactly, except an
element row's delete time where the reference gives a range (replay.py).
A key, slot or row that one side has and the other lacks counts once.
"""

from __future__ import annotations

import numpy as np

I64 = np.int64
KEY_COLS = ("enc", "ct", "mt", "dt", "expire")
REG_COLS = ("reg_has", "reg_val", "reg_t", "reg_node")
CNT_COLS = ("c_val", "c_uuid", "c_base", "c_base_t")
EL_COLS = ("e_add_t", "e_add_node", "e_has", "e_val")
FAMILIES = ("keys", "envelopes", "registers", "counter_slots",
            "counter_sums", "elements")


def concat(a: dict, b: dict) -> dict:
    """Two reference states over disjoint keys as one."""
    out = {}
    nk = len(a["key"])
    for name in a:
        x, y = a[name], b[name]
        if name in ("c_key", "e_key"):
            y = y + nk
        if x.dtype.kind == "S" or y.dtype.kind == "S":
            w = max(x.dtype.itemsize, y.dtype.itemsize, 1)
            x, y = x.astype(f"S{w}"), y.astype(f"S{w}")
        out[name] = np.concatenate([x, y])
    for name in ("e_del_hi",):
        if name in b and name not in a:
            out[name] = np.concatenate([a["e_del_t"], b[name]])
    return out


def _match(got: np.ndarray, want: np.ndarray) -> tuple:
    """Positions of `got` items in `want` (both unique): -> (index into
    want for each got item or -1)."""
    order = np.argsort(want, kind="stable")
    pos = np.searchsorted(want[order], got)
    pos = np.minimum(pos, len(want) - 1) if len(want) else pos
    hit = (want[order][pos] == got) if len(want) else np.zeros(len(got), bool)
    return np.where(hit, order[pos] if len(want) else 0, -1)


def _ne(a, b) -> np.ndarray:
    return np.asarray(a != b)


def compare(got: dict, want: dict) -> dict:
    """-> {family: mismatches} over FAMILIES."""
    out = dict.fromkeys(FAMILIES, 0)
    g2w = _match(got["key"], want["key"])
    hit = g2w >= 0
    out["keys"] = int((~hit).sum()) + len(want["key"]) - int(hit.sum())
    gi, wi = np.nonzero(hit)[0], g2w[hit]
    for fam, cols in (("envelopes", KEY_COLS), ("registers", REG_COLS)):
        bad = np.zeros(len(gi), bool)
        for c in cols:
            bad |= _ne(got[c][gi], want[c][wi])
        out[fam] = int(bad.sum())
    out["counter_sums"] = int(_ne(got["cnt_sum"][gi], want["cnt_sum"][wi]).sum())

    # rows are keyed by the WANT key index, so both sides speak one index
    gkey = np.full(len(got["key"]), -1, I64)
    gkey[gi] = wi
    out["counter_slots"] = _rows(
        gkey[got["c_key"]], got["c_node"], got, want["c_key"],
        want["c_node"], want, CNT_COLS)
    members = np.unique(np.concatenate([want["e_member"], got["e_member"]]))
    out["elements"] = _rows(
        gkey[got["e_key"]], np.searchsorted(members, got["e_member"]), got,
        want["e_key"], np.searchsorted(members, want["e_member"]), want,
        EL_COLS, del_range=True)
    return out


def _rows(gk, gs, got, wk, ws, want, cols, del_range=False) -> int:
    """Rows matched on (key, sub-key); a got row of an unknown key (-1)
    never matches."""
    gcode = np.where(gk >= 0, (gk << 24) | gs, -1 - np.arange(len(gk)))
    wcode = (wk.astype(I64) << 24) | ws
    g2w = _match(gcode, wcode)
    hit = g2w >= 0
    bad = int((~hit).sum()) + len(wcode) - int(hit.sum())
    gi, wi = np.nonzero(hit)[0], g2w[hit]
    diff = np.zeros(len(gi), bool)
    for c in cols:
        diff |= _ne(got[c][gi], want[c][wi])
    if del_range:
        # the store's canonical form: a delete at or below the add is inert
        def inert0(t, add):
            return np.where(t > add, t, 0)
        add = want["e_add_t"][wi]
        dt = inert0(got["e_del_t"][gi], got["e_add_t"][gi])
        lo = inert0(want["e_del_t"][wi], add)
        hi = inert0(want.get("e_del_hi", want["e_del_t"])[wi], add)
        diff |= (dt < lo) | (dt > hi)
    return bad + int(diff.sum())
