"""Rank side of tests/test_torch_sharded_merge.py (no test_ prefix: a
helper, imported by the spawned ranks of one gloo world).  Imports torch,
numpy and the port only, so a rank never starts JAX."""

import numpy as np

from constdb_tpu_torch.entry import _example_arrays, _step_rank
from constdb_tpu_torch.ops.segment import NEUTRAL_T

R, S = 8, 256
# (rep, seed) of the reference's test_matches_single_device
REP_SEEDS = [(1, 0), (2, 1), (4, 2), (8, 3)]


def case_arrays(seed: int):
    """The reference test's inputs: _example_arrays at a seed drawn from
    default_rng(seed)."""
    rng = np.random.default_rng(seed)
    return _example_arrays(R, S, seed=int(rng.integers(0, 1 << 31)))


def tie_arrays():
    """The reference's row-0 tie case: the local row 0 and replica row 7
    (on another rep shard) write the same (t, node) to every slot."""
    r, s = 8, 128
    at = np.full((r, s), NEUTRAL_T, np.int64)
    an = np.zeros((r, s), np.int64)
    dt = np.zeros((r, s), np.int64)
    at[0], an[0] = 5 << 22, 3
    at[7], an[7] = 5 << 22, 3
    vals = np.zeros((r, s), np.int64)
    ts = np.full((r, s), NEUTRAL_T, np.int64)
    env = np.zeros((r, s, 4), np.int64)
    return vals, ts, at, an, dt, env


def mesh_cases(rank: int, world: int, device) -> dict:
    """Every case of the test module in one world: the step at each rep
    of REP_SEEDS, then the tie case at rep 4."""
    out = {}
    for rep, seed in REP_SEEDS:
        out[("rep", rep)] = _step_rank(rank, world, device, rep,
                                       case_arrays(seed))
    out[("tie", 4)] = _step_rank(rank, world, device, 4, tie_arrays())
    return out
