"""The arithmetic the traced run's readers rest on, on synthetic traces:
busy time, idle gaps and what the host was doing in them, the rooflines
and the percentile."""

import math
from types import SimpleNamespace

import pytest

from portbench import roofline, stats, trace
from portbench.tests.helpers import REPO
from portbench.harness import metric_reader

# two kernels overlapping on two streams, a copy, and the gaps between
DEVICE = [("segment_sum_kernel", 100.0, 150.0),
          ("Memcpy HtoD (Pinned -> Device)", 140.0, 200.0),
          ("scatter_round_kernel", 400.0, 410.0),
          ("segment_sum_kernel", 900.0, 950.0)]
LABELS = [("catchup", 0.0, 1000.0), ("node.merge_batches", 50.0, 300.0),
          ("engine.dispatch.el", 220.0, 280.0),
          ("node.ensure_flushed", 600.0, 990.0)]


def test_union_gaps_and_busy():
    busy = trace.union([(s, e) for _n, s, e in DEVICE], 0.0, 1000.0)
    assert busy == [[100.0, 200.0], [400.0, 410.0], [900.0, 950.0]]
    assert trace.gaps(busy, 0.0, 1000.0) == [
        (0.0, 100.0), (200.0, 400.0), (410.0, 900.0), (950.0, 1000.0)]
    s = trace.summarize(DEVICE, LABELS, (0.0, 1000.0))
    assert math.isclose(s["busy_s"], 160e-6)
    assert math.isclose(s["window_s"], 1000e-6)
    assert s["device_ops"][0][0] == "segment_sum_kernel"
    assert math.isclose(s["device_ops"][0][1], 100e-6)
    assert math.isclose(trace.kernel_seconds(s, "scatter_round_kernel"),
                        10e-6)


def test_idle_gaps_go_to_the_innermost_host_label():
    s = trace.summarize(DEVICE, LABELS, (0.0, 1000.0))
    idle = dict(s["idle_gaps"])
    # 0-50 catchup, 50-100 merge_batches; 200-220 merge_batches, 220-280
    # dispatch.el, 280-300 merge_batches, 300-400 catchup; 410-600
    # catchup, 600-900 ensure_flushed; 950-990 ensure_flushed, 990-1000
    # catchup
    assert math.isclose(idle["catchup"], (50 + 100 + 190 + 10) * 1e-6)
    assert math.isclose(idle["node.merge_batches"], (50 + 20 + 20) * 1e-6)
    assert math.isclose(idle["engine.dispatch.el"], 60e-6)
    assert math.isclose(idle["node.ensure_flushed"], (300 + 40) * 1e-6)
    assert math.isclose(sum(idle.values()), 840e-6)
    # outside every label: the harness
    t = trace.summarize(DEVICE, [], (0.0, 1000.0))
    assert dict(t["idle_gaps"]) == {trace.OUTSIDE: pytest.approx(840e-6)}


def _run(summary, shapes):
    return SimpleNamespace(trace=summary, shapes=shapes, window={},
                           engine={}, on_card=True)


def test_roofline_counts_only_what_must_cross_hbm():
    # the mixed catch-up's K4: 4M slot rows over 1.25M keys
    n, n_seg = 4_000_000, 1_250_000
    read, written, ops = roofline.k4(n, n_seg, True)
    assert (read, written, ops) == (n * 20, n_seg * 8, 2 * n)
    # the L2 may hold 50 MiB of the reads at the start, and keeps the
    # 10 MB of sums: only the rest must come from HBM
    assert roofline.hbm_bytes(read, written) == read - roofline.L2_BYTES
    assert roofline.least_s(read, written, ops) == pytest.approx(
        (read - roofline.L2_BYTES) / roofline.HBM_BYTES_PER_S)
    # a launch whose data fits the L2 is bound by its operations alone
    small = roofline.k4(1000, 100, True)
    assert roofline.hbm_bytes(*small[:2]) == 0
    assert roofline.least_s(*small) == pytest.approx(
        2000 / roofline.ALU_OPS_PER_S)
    # writes beyond the L2 count too
    assert roofline.hbm_bytes(0, roofline.L2_BYTES + 8) == 8


def test_roofline_readers():
    n, n_seg = 4_000_000, 1_250_000
    least = roofline.least_s(*roofline.k4(n, n_seg, True))
    kernel_s = 2 * least          # the kernel took twice its least time
    summary = {"kernel_s": {"segment_sum_kernel(int const*)": kernel_s},
               "kernel_n": {"segment_sum_kernel(int const*)": 1}}
    read = metric_reader(REPO, "k4_roofline.catchup")
    assert read(_run(summary, {"segment_sum": [(n, n_seg, True)],
                               "scatter_round": []})) == pytest.approx(50.0)
    # no launch or no kernel time: nothing to read, never 0
    assert read(_run(summary, {"segment_sum": [], "scatter_round": []})) \
        is None
    assert read(_run({"kernel_s": {}, "kernel_n": {}},
                     {"segment_sum": [(n, n_seg, True)],
                      "scatter_round": []})) is None
    # two launches recorded, one in the trace (the profiler dropped the
    # other): the share is over the quicker launch alone, never doubled
    small = (3 * n // 4, n_seg, True)
    small_least = roofline.least_s(*roofline.k4(*small))
    assert 0 < small_least < least
    assert read(_run(summary, {"segment_sum": [(n, n_seg, True), small],
                               "scatter_round": []})) == \
        pytest.approx(100.0 * small_least / kernel_s)
    segs = [("pair_src", 1000), ("max1", 500)]
    b3, w3, o3 = roofline.k3(segs)
    assert (b3, w3, o3) == (1000 * (4 + 16 + 16) + 500 * (4 + 8 + 8), 0,
                            1000 * 2 + 500)
    read3 = metric_reader(REPO, "k3_roofline.stream")
    t3 = o3 / roofline.ALU_OPS_PER_S      # a round fits the L2
    assert read3(_run({"kernel_s": {"scatter_round_kernel": 4 * t3},
                       "kernel_n": {"scatter_round_kernel": 1}},
                      {"segment_sum": [], "scatter_round": [segs]})) == \
        pytest.approx(25.0)


def test_idle_share_reader():
    read = metric_reader(REPO, "device_idle.catchup")
    s = trace.summarize(DEVICE, LABELS, (0.0, 1000.0))
    assert read(_run(s, {})) == pytest.approx(84.0)
    assert read(_run(None, {})) is None


def test_percentile_nearest_rank():
    v = list(range(1, 201))            # 1..200
    assert stats.percentile(v, 99) == 198
    assert stats.percentile(v, 50) == 100
    assert stats.percentile([7.0], 99) == 7.0
    with pytest.raises(ValueError):
        stats.percentile([], 99)

