"""portbench/spans.py: the program's labels nested inside the harness's in
the reduction of a trace (the innermost wins; idle under no program span
is counted apart), the readings on synthetic totals (left out where
there is nothing to read), and a run of each cell on the CPU with the
program's tracing on and off."""

import math

import pytest

from constdb_tpu_torch.utils import trace
from constdb_tpu_torch.utils.trace import SpanTotal
from portbench import spans
from portbench.tests.helpers import cells, small_root
from portbench.trace import OUTSIDE

DEVICE = [("k", 100.0, 200.0), ("k", 900.0, 950.0)]
# harness labels (their "pb:" taken off) and the program's, nested
LABELS = [("catchup", 0.0, 1000.0),
          ("node.merge_batches", 40.0, 700.0),
          ("cst:node.merge_batches", 50.0, 690.0),
          ("cst:engine.resolve_keys", 60.0, 150.0),
          ("cst:engine.stage_wait.env", 200.0, 500.0),
          ("engine.dispatch.env", 500.0, 600.0),
          ("cst:engine.dispatch.env", 505.0, 595.0)]


def test_program_labels_nested_in_harness_labels():
    idle, unspanned = spans.idle_by_label(DEVICE, LABELS, (0.0, 1000.0))
    us = {k: v * 1e6 for k, v in idle.items()}
    # 0-40 catchup, 40-50 merge_batches (harness), 50-60 cst merge,
    # 60-100 cst resolve; 200-500 cst stage_wait, 500-505 dispatch
    # (harness), 505-595 cst dispatch, 595-600 dispatch (harness),
    # 600-690 cst merge, 690-700 merge (harness), 700-900 catchup;
    # 950-1000 catchup
    assert us == pytest.approx({
        "catchup": 40 + 200 + 50, "node.merge_batches": 10 + 10,
        "cst:node.merge_batches": 10 + 90, "cst:engine.resolve_keys": 40,
        "cst:engine.stage_wait.env": 300, "engine.dispatch.env": 5 + 5,
        "cst:engine.dispatch.env": 90})
    # under no program span: catchup's 290 and merge_batches' 10 before
    # and 10 after the program's span; the harness's dispatch label lies
    # inside the program's dispatch span
    assert math.isclose(unspanned, (290 + 10 + 10) * 1e-6)
    # with no label at all, every idle second is the harness's, unspanned
    bare, unspanned = spans.idle_by_label(DEVICE, [], (0.0, 1000.0))
    assert list(bare) == [OUTSIDE]
    assert math.isclose(unspanned, 850e-6)


def test_delta_of_totals():
    before = {"a": SpanTotal(2, 1.0, 0.5), "n": 3}
    after = {"a": SpanTotal(5, 4.0, 2.0), "b": SpanTotal(1, 0.25, 0.0),
             "n": 10, "m": 2}
    got = spans.delta(after, before)
    assert got == {"a": SpanTotal(3, 3.0, 1.5), "b": SpanTotal(1, 0.25, 0.0),
                   "n": 7, "m": 2}


def test_readings():
    totals = {"engine.resolve_keys": SpanTotal(4, 0.5, 0.0),
              "engine.stage_wait.env": SpanTotal(4, 1.0, 0.0),
              "engine.stage_wait.el": SpanTotal(4, 0.5, 0.0),
              "engine.stage.env": SpanTotal(4, 2.0, 1.0),
              "engine.stage.el": SpanTotal(4, 2.0, 0.6),
              "gc.seconds": 0.3, "gc.collections": 9}
    got = spans.readings(totals, {"keys": 2_000_000, "wall_s": 10.0},
                         ({"cst:x": 3.0, "catchup": 1.0}, 1.0))
    assert got == pytest.approx({
        "resolve_s_per_mkey": 0.25, "stage_wait_s_per_mkey": 0.75,
        "stage_cpu_share": 40.0, "gc_share": 3.0, "idle_unspanned": 25.0})
    stream = {"replica.encode": SpanTotal(10, 0.02, 0.0),
              "engine.flushes.barrier": 4, "gc.seconds": 0.0}
    got = spans.readings(stream, {"frames": 4000, "wall_s": 2.0})
    assert got == pytest.approx({"encode_us_per_frame": 5.0,
                                 "barrier_flushes_per_kframe": 1.0,
                                 "gc_share": 0.0})
    # nothing to read: left out, never 0
    assert spans.readings({}, {"keys": 10, "wall_s": 1.0}) == {}
    assert spans.readings({}, {}) == {}


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return small_root(tmp_path_factory.mktemp("portbench_spans"))


@pytest.mark.parametrize("workload", cells())
@pytest.mark.parametrize("record", [0, 1])
def test_a_cell_on_the_cpu(root, workload, record):
    import torch
    out = spans.run(root, workload, seed=2 ** 31 + 5, seconds=0.3,
                    traced=False, record=bool(record),
                    device=torch.device("cpu"), log=lambda _m: None)
    assert out["rate"] > 0 and out["record"] == record
    assert not trace.enabled()
    r = out["readings"]
    if workload.endswith(".stream"):
        assert {"encode_us_per_frame", "barrier_flushes_per_kframe",
                "gc_share"} <= set(r)
        assert out["span_wall_s"]["node.merge_stream_batch"] > 0
    else:
        assert {"resolve_s_per_mkey", "stage_wait_s_per_mkey",
                "stage_cpu_share", "gc_share"} <= set(r)
        assert 0 < r["stage_cpu_share"] <= 100.5
        assert out["span_wall_s"]["node.merge_batches"] > 0
    assert "idle_gaps" not in out
