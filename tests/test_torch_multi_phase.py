"""chip_smoke.py's phase 16 (the multi-device merge) rehearsed on the CPU
at a small size: the port's lint in --baseline mode over the checkout,
the catch-up through the kv range-partitioned engine on 4 CPU partitions
(held to a one-device catch-up's digest and to the CPU oracle, every
partition's columns holding exactly its range), the rep x kv step over a
one-rank gloo world bit-equal to the plain dense ops, and
dryrun_multichip(1).  Off the card no kernel launches, so the
per-partition calls are the engine's own counts of its kernel wrapper
calls (their plain versions on CPU tensors)."""

import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402

# 31,000 keys x 2: 24,800 counter slots fill the last of the 4 partitions
# of their 32,768-row plane, as phase 5's 3.2M slots fill theirs of 2^22
KEYS, REP, SEED = 31_000, 2, 7


@pytest.fixture(scope="module")
def phase():
    from constdb_tpu_torch import workload as W
    from constdb_tpu_torch.engine.cuda import TorchMergeEngine
    from constdb_tpu_torch.store.keyspace import KeySpace

    mp = pytest.MonkeyPatch()
    mp.setattr(chip_smoke, "CHUNK_KEYS", 4096)
    mp.setattr(chip_smoke, "MULTI_S", 1 << 12)
    try:
        batches = W.make_workload(KEYS, REP, seed=SEED,
                                  aligned_counters=True)
        eng = TorchMergeEngine(resident=True, dense_fold="cuda",
                               device="cpu")
        store = KeySpace()
        chunks = W.chunk_batches(batches, chip_smoke.CHUNK_KEYS)
        for i in range(0, len(chunks), REP):
            eng.merge_many(store, chunks[i:i + REP])
        eng.flush(store)
        eng.close()
        digest = chip_smoke.full_state_digest(store)
        oracle = (W.subsample_keys(batches[0].keys, KEYS),
                  W.oracle_canonical(batches, KEYS))
        yield chip_smoke.multi_phase(torch.device("cpu"), KEYS, REP, SEED,
                                     oracle, digest, 1.0), digest
    finally:
        mp.undo()


def test_phase_16_passes_on_the_cpu(phase):
    res, digest = phase
    assert res["lint"]["findings"] == 0
    cu = res["catchup"]
    assert cu["digest"] == digest and cu["verified_keys"] > 0
    assert len(cu["per_partition"]) == chip_smoke.MULTI_PARTS
    for calls in cu["per_partition"]:
        assert min(calls.values()) >= 1
    assert cu["resplits"] >= 1
    for cap, n, rows in cu["partition_rows"].values():
        assert sum(rows) == n <= cap
    coll = res["collective"]
    assert coll["backend"] == "gloo" and coll["all_reduces"] == 18
    assert res["dryrun"]["n"] == 1


def test_phase_16_catches_a_partition_holding_the_wrong_range():
    """partition_check fails when a partition's rows are not its range."""
    from constdb_tpu_torch import workload as W
    from constdb_tpu_torch.engine.cuda import TorchMergeEngine
    from constdb_tpu_torch.store.keyspace import KeySpace

    batches = W.make_workload(3000, 2, seed=1, aligned_counters=True)
    eng = TorchMergeEngine(resident=True, dense_fold="cuda",
                           devices=["cpu"] * 4)
    store = KeySpace()
    eng.merge_many(store, batches)
    eng.flush(store)
    assert chip_smoke.partition_check(eng, store)
    parts = eng._res["cnt"]["cols"]["val"]
    parts[0], parts[1] = parts[1], parts[0]
    with pytest.raises(AssertionError, match="does not hold"):
        chip_smoke.partition_check(eng, store)
