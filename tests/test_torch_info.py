"""The port's INFO (constdb_tpu_torch/server/info.py) against the
reference's: on the same node state, the same sections in the same order
and the same field names, less the device lines (the reference reads a
JAX device's memory_stats(), the port the engine's torch device, and only
for a card).  The one other difference allowed is a `merge_<family>_seconds`
line of a merge family only the port's engine has (its counter-sum
re-derivation, "sums").  The device lines themselves are checked with
torch.cuda's readers stubbed."""

import pytest
import torch

from constdb_tpu.engine.cpu import CpuMergeEngine as RefCpuEngine
from constdb_tpu.engine.tpu import TpuMergeEngine
from constdb_tpu.resp import message as RM
from constdb_tpu.server.node import Node as RefNode
from constdb_tpu_torch.engine.cpu import CpuMergeEngine
from constdb_tpu_torch.engine.cuda import TorchMergeEngine
from constdb_tpu_torch.ops import kernels
from constdb_tpu_torch.resp import message as PM
from constdb_tpu_torch.server.node import Node

SCRIPT = [
    (b"set", b"r1", b"v1"), (b"incr", b"c1", b"3"), (b"decr", b"c1"),
    (b"sadd", b"s1", b"a", b"b"), (b"srem", b"s1", b"a"),
    (b"hset", b"h1", b"f", b"v"), (b"rpush", b"l1", b"x"),
    (b"mvset", b"m1", b"x"), (b"del", b"r1"), (b"get", b"c1"),
    (b"meet", b"127.0.0.1:7001"),
]
REF_DEVICE_LINES = {"device", "device_hbm_in_use", "device_hbm_limit"}


def run(node, M, cmd=(b"info",)):
    for c in SCRIPT:
        node.execute(M.Arr([M.Bulk(x) for x in c]))
    return node.execute(M.Arr([M.Bulk(x) for x in cmd])).val.decode()


def layout(text: str) -> list:
    """[(section, [field names])] of an INFO reply."""
    out = []
    for ln in text.split("\r\n"):
        if ln.startswith("# "):
            out.append((ln[2:], []))
        elif ln:
            out[-1][1].append(ln.split(":", 1)[0])
    return out


def extra_family_lines(engine) -> set:
    return {f"merge_{name}_seconds" for name in
            getattr(engine, "family_secs", {})}


@pytest.mark.parametrize("kind", ("cpu", "torch"))
def test_sections_and_fields_equal_reference(kind):
    if kind == "cpu":
        ref_eng, eng = RefCpuEngine(), CpuMergeEngine()
    else:
        ref_eng = TpuMergeEngine(resident=True)
        eng = TorchMergeEngine(device="cpu", resident=True)
    want = layout(run(RefNode(node_id=1, engine=ref_eng), RM))
    node = Node(node_id=1, engine=eng)
    got = layout(run(node, PM))
    assert [s for s, _ in got] == [s for s, _ in want]
    allowed = extra_family_lines(eng) - extra_family_lines(ref_eng)
    for (sec, g), (_, w) in zip(got, want):
        w = [f for f in w if f not in REF_DEVICE_LINES]
        assert [f for f in g if f not in allowed] == w, sec
    fields = {f for _, fs in got for f in fs}
    assert not any(f.startswith("device") for f in fields)
    assert "engine_degraded" not in fields
    if kind == "torch":
        assert {"dev_rounds_resident", "host_micro_rounds", "tns_dev_rows",
                "dev_upload_bytes", "dev_download_bytes"} <= fields


@pytest.mark.parametrize("section", ("stats", "replication", "keyspace",
                                     "memory"))
def test_one_section_equals_reference(section):
    want = layout(run(RefNode(node_id=1, engine=RefCpuEngine()), RM,
                      (b"info", section.encode())))
    got = layout(run(Node(node_id=1, engine=CpuMergeEngine()), PM,
                     (b"info", section.encode())))
    assert len(got) == 1 and got[0][0] == section.capitalize()
    assert got == [(s, [f for f in fs if f not in REF_DEVICE_LINES])
                   for s, fs in want]


def test_device_lines_read_the_engines_card(monkeypatch):
    node = Node(node_id=1, engine=CpuMergeEngine())
    node.engine.device = torch.device("cuda", 0)
    monkeypatch.setattr(torch.cuda, "mem_get_info", lambda d: (7, 80))
    monkeypatch.setattr(torch.cuda, "memory_allocated", lambda d: 11)
    monkeypatch.setattr(torch.cuda, "max_memory_allocated", lambda d: 13)
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda d: "card")
    monkeypatch.setattr(kernels, "LAUNCHES",
                        {"segment_sum": 2, "merge_elems": 1})
    text = node.execute(PM.Arr([PM.Bulk(b"info"),
                                PM.Bulk(b"memory")])).val.decode()
    lines = dict(ln.split(":", 1) for ln in text.split("\r\n")
                 if ln and not ln.startswith("#"))
    assert lines["device_mem_allocated"] == "11"
    assert lines["device_mem_peak"] == "13"
    assert lines["device_mem_free"] == "7"
    assert lines["device_mem_total"] == "80"
    assert lines["device"] == "cuda:0"
    assert lines["device_name"] == "card"
    assert lines["device_kernel_launches"] == "merge_elems=1,segment_sum=2"


def test_trace_section_counts_flushes_by_cause_and_the_collector():
    """`INFO trace`, shown only on request: the engine's flushes that ran
    by cause (a replicated barrier's flush of a catch-up still on the
    device counts under `barrier`), and the collector's passes and
    seconds."""
    import gc

    from constdb_tpu_torch import workload
    from constdb_tpu_torch.engine.base import (FLUSH_CAUSES,
                                               MICRO_PYTHON_CAUSES)
    from constdb_tpu_torch.utils.hlc import SEQ_BITS

    node = Node(node_id=1, engine=TorchMergeEngine(device="cpu",
                                                   resident=True))
    node.merge_batches(workload.make_workload(200, 2, seed=3))
    node.apply_replicated(b"delset", [PM.Bulk(b"zzz")], 2,
                          (1_700_000_000_000 + 5) << SEQ_BITS,
                          cause="barrier")
    gc.collect()
    text = node.execute(PM.Arr([PM.Bulk(b"info"),
                                PM.Bulk(b"trace")])).val.decode()
    assert layout(text) == [("Trace", [f"engine_flushes_{c}"
                                       for c in FLUSH_CAUSES] +
                             ["engine_barriers_clean",
                              "engine_micro_planned"] +
                             [f"engine_micro_python_{c}"
                              for c in MICRO_PYTHON_CAUSES] +
                             ["gc_collections", "gc_seconds_total"])]
    lines = dict(ln.split(":", 1) for ln in text.split("\r\n")
                 if ln and not ln.startswith("#"))
    assert {c: lines[f"engine_flushes_{c}"] for c in FLUSH_CAUSES} == \
        {c: "1" if c == "barrier" else "0" for c in FLUSH_CAUSES}
    assert lines["engine_barriers_clean"] == "0"
    assert lines["engine_micro_planned"] == "0"
    assert int(lines["gc_collections"]) >= 1
    assert float(lines["gc_seconds_total"]) > 0
    full = node.execute(PM.Arr([PM.Bulk(b"info")])).val.decode()
    assert "# Trace" not in full and "engine_flushes_" not in full
