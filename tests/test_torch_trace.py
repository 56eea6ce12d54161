"""The port's spans and counters (constdb_tpu_torch/utils/trace.py): the
owners' totals, the profiler labels of the staging threads' spans, the
engine's and the node's timers as views over their span totals after a
catch-up and a coalesced stream (with its one barrier flush counted by
cause), the steady rounds counted by route (the native planner or a
cause for the Python micro path), no profiler label while tracing is
off, none on the per-frame path, and the collector's hook."""

import gc
import threading

import pytest
import torch

from constdb_tpu_torch import workload as W
from constdb_tpu_torch.crdt import semantics as S
from constdb_tpu_torch.engine.cpu import CpuMergeEngine
from constdb_tpu_torch.engine.base import FLUSH_CAUSES, flush_for
from constdb_tpu_torch.engine.cuda import TorchMergeEngine
from constdb_tpu_torch.parallel.host_pool import engine_secs
from constdb_tpu_torch.replica.coalesce import CoalescingApplier
from constdb_tpu_torch.replica.manager import ReplicaMeta
from constdb_tpu_torch.resp import message as PM
from constdb_tpu_torch.server.node import Node
from constdb_tpu_torch.utils import trace
from constdb_tpu_torch.utils.hlc import SEQ_BITS

MS0 = 1_700_000_000_000


def u(i: int) -> int:
    return (MS0 + i) << SEQ_BITS


def frame(prev: int, uuid: int, name: bytes, *args) -> list:
    items = [PM.Bulk(b"replicate"), PM.Int(7), PM.Int(prev), PM.Int(uuid),
             PM.Bulk(name)]
    return items + [PM.Int(a) if isinstance(a, int) else PM.Bulk(a)
                    for a in args]


class Labels:
    """torch.profiler.record_function's stand-in: the labels entered,
    with the thread that entered each."""

    def __init__(self):
        self.entered = []
        outer = self

        class Label:
            def __init__(self, name):
                self.name = name

            def __enter__(self):
                outer.entered.append(
                    (self.name, threading.current_thread().name))

            def __exit__(self, *exc):
                pass

        self.Label = Label

    def names(self) -> list:
        return [n for n, _t in self.entered]


@pytest.fixture
def labels(monkeypatch):
    got = Labels()
    monkeypatch.setattr(torch.profiler, "record_function", got.Label)
    trace.enable(True)
    yield got
    trace.enable(False)


def test_nested_spans_each_add_to_their_own_total():
    own = trace.Totals()
    with trace.span("t.outer", into=own):
        with trace.span("t.inner", into=own):
            sum(range(20000))
        with trace.span("t.inner", into=own):
            pass
    got = own.snapshot()
    assert got["t.outer"].count == 1 and got["t.inner"].count == 2
    assert 0 < got["t.inner"].wall_s <= got["t.outer"].wall_s
    assert got["t.outer"].cpu_s == 0.0


def test_totals_count_spans_and_counters_into_an_owner():
    own, other = trace.Totals(), trace.Totals()
    for _ in range(3):
        with trace.span("t.owned", into=own, cpu=True):
            sum(range(20000))
    trace.count("t.things", own, 5)
    trace.count("t.things", into=own)
    got = own.snapshot()
    assert got["t.owned"].count == 3 and got["t.things"] == 6
    assert got["t.owned"].wall_s > 0 and got["t.owned"].cpu_s > 0
    assert own.wall("t.owned") == got["t.owned"].wall_s
    assert own.wall("t.never") == 0.0 and own.value("t.never") == 0
    # an owner's totals are its own
    assert other.snapshot() == {}


def test_staging_spans_label_the_staging_threads(labels):
    """While tracing is on, a pipelined merge's spans open their profiler
    labels, the staging spans on the staging threads and the rest on
    the thread that called the node."""
    node = Node(node_id=1, engine=TorchMergeEngine(
        device="cpu", resident=True, pipeline=True))
    node.merge_batches(W.make_workload(400, 3, seed=5))
    caller = threading.current_thread().name
    threads = dict(labels.entered)
    assert threads["cst:node.merge_batches"] == caller
    assert threads["cst:engine.resolve_keys"] == caller
    for fam in ("env", "reg", "cnt", "el"):
        assert threads[f"cst:engine.stage.{fam}"].startswith("constdb-stage")
        for name in (f"cst:engine.stage_wait.{fam}",
                     f"cst:engine.dispatch.{fam}"):
            assert threads[name] == caller
    assert labels.names().count("cst:engine.stage.env") == 1
    spans = node.engine.spans.snapshot()
    assert all(spans[f"engine.stage.{f}"].count == 1 and
               spans[f"engine.stage.{f}"].cpu_s > 0
               for f in ("env", "reg", "cnt", "el"))


def test_timers_are_views_over_the_span_totals():
    """A catch-up and a coalesced stream through Node(device="cpu"): its
    one delset lands while the catch-up is still on the device, so its
    barrier flushes once; the engine's family_secs and stage_secs, the
    node's merge_secs and flush_secs, INFO and host_pool's snapshot all
    read the span totals."""
    node = Node(node_id=1, device="cpu")
    eng = node.engine
    node.merge_batches(W.make_workload(600, 4, seed=9))
    assert eng.needs_flush
    ap = CoalescingApplier(node, ReplicaMeta("p:1"), max_frames=64,
                           max_latency=999.0)
    frames = [frame(0, u(1), b"delset", b"k%010d" % 599)]
    for i in range(2, 120):
        frames.append(frame(u(i - 1), u(i), b"sadd", b"s%d" % (i % 7),
                            b"m%d" % i))
    for f in frames:
        ap.apply(f)
    ap.flush()
    node.ensure_flushed()
    spans = eng.spans.snapshot()
    assert {c: eng.spans.value(f"engine.flushes.{c}")
            for c in FLUSH_CAUSES} == {c: int(c == "barrier")
                                       for c in FLUSH_CAUSES}
    w = eng.spans.wall
    fam = eng.family_secs
    assert fam == {**{f: w(f"engine.stage_wait.{f}") +
                      w(f"engine.dispatch.{f}")
                      for f in ("env", "reg", "cnt", "el")},
                   "flush": w("engine.flush"), "sums": w("engine.sums"),
                   "host": w("engine.host_round"),
                   "micro": w("engine.micro_round")}
    assert all(fam[f] > 0 for f in ("env", "reg", "cnt", "el", "flush",
                                     "host"))
    assert eng.stage_secs == {f: w(f"engine.stage.{f}")
                              for f in ("env", "reg", "cnt", "el")}
    assert all(v > 0 for v in eng.stage_secs.values())
    assert all(spans[f"engine.stage.{f}"].cpu_s > 0
               for f in ("env", "reg", "cnt", "el"))
    nw = node.stats.spans.wall
    assert node.stats.merge_secs == nw("node.merge_batch") + \
        nw("node.merge_batches") > 0
    assert node.stats.flush_secs == nw("node.ensure_flushed") > 0
    node_spans = node.stats.spans.snapshot()
    assert node_spans["node.merge_stream_batch"].count == \
        node.stats.repl_coalesce_flushes > 0
    assert node_spans["replica.encode"].count == \
        node.stats.repl_coalesce_flushes
    snap = engine_secs(eng)
    assert snap["family_secs"] == eng.family_secs
    assert snap["stage_secs"] == eng.stage_secs
    text = node.execute(PM.Arr([PM.Bulk(b"info"),
                                PM.Bulk(b"stats")])).val.decode()
    lines = dict(ln.split(":", 1) for ln in text.split("\r\n")
                 if ln and not ln.startswith("#"))
    assert float(lines["merge_seconds_total"]) == \
        round(node.stats.merge_secs, 6)
    assert float(lines["flush_seconds_total"]) == \
        round(node.stats.flush_secs, 6)
    for name, secs in fam.items():
        assert float(lines[f"merge_{name}_seconds"]) == round(secs, 6)


def test_a_flush_counts_only_when_it_runs():
    """A flush counts under its cause only when it has state to write
    back; a replicated frame that is no barrier (a serve shard's, an
    oplog replay's) flushes as a read."""
    node = Node(node_id=1, device="cpu")
    node.ensure_flushed()
    node.merge_batches(W.make_workload(100, 2, seed=1))
    node.ensure_flushed()
    node.ensure_flushed()
    flush_for(node.engine, node.ks, "release")
    node.merge_batches(W.make_workload(100, 2, seed=2))
    node.apply_replicated(b"delset", [PM.Bulk(b"zzz")], 2, u(5))
    value = node.engine.spans.value
    assert value("engine.flushes.read") == 2
    assert value("engine.flushes.release") == 0
    assert value("engine.flushes.barrier") == 0
    assert node.stats.spans.snapshot()["node.ensure_flushed"].count == 2


def test_key_scoped_barriers_count_by_outcome(monkeypatch):
    """A scripted stream through a coalescing applier on a resident steady
    engine: a delset whose key has device-newer rows flushes those rows
    alone, one whose key has none (or is absent) flushes nothing, a
    non-scoped barrier flushes the whole engine; each counts once (none
    while the engine defers nothing), INFO trace shows the counts, and
    the keyspace equals the CPU engine's."""
    from constdb_tpu_torch.server import commands
    monkeypatch.setattr(commands, "now_ms", lambda: W.MS0)

    def run(engine):
        node = Node(node_id=1, engine=engine, clock=lambda: W.MS0)
        ap = CoalescingApplier(node, ReplicaMeta("p:1"), max_frames=64,
                               max_latency=999.0)
        script = [(b"sadd", b"s1", b"m1", b"m2"), (b"sadd", b"s2", b"m3"),
                  (b"sadd", b"s3", b"m4"), None,
                  (b"sadd", b"s1", b"m5"), (b"sadd", b"s2", b"m6"),
                  (b"delset", b"s1"),      # s1 pending: lands, key flush
                  (b"delset", b"s3"),      # s3 flushed before: clean
                  (b"delset", b"s9"),      # absent: no rows, clean
                  (b"sadd", b"s2", b"m7"), (b"sadd", b"s3", b"m8"),
                  (b"delset", b"s3"),      # s3 pending: lands, key flush
                  (b"expire", b"s2", 100),  # not key-scoped: whole flush
                  (b"delset", b"s2")]      # nothing deferred: no count
        i = 0
        for step in script:
            if step is None:
                ap.flush()
                node.ensure_flushed()
                continue
            i += 1
            ap.apply(frame(u(i - 1) if i > 1 else 0, u(i), *step))
        ap.flush()
        return node

    node = run(TorchMergeEngine(resident=True, steady=True, warmup=0,
                                device="cpu"))
    value = node.engine.spans.value
    assert {c: value(f"engine.flushes.{c}") for c in FLUSH_CAUSES} == \
        {c: {"read": 1, "barrier": 1, "barrier_key": 2}.get(c, 0)
         for c in FLUSH_CAUSES}
    assert value("engine.barriers_clean") == 2
    text = node.execute(PM.Arr([PM.Bulk(b"info"),
                                PM.Bulk(b"trace")])).val.decode()
    lines = dict(ln.split(":", 1) for ln in text.split("\r\n")
                 if ln and not ln.startswith("#"))
    assert lines["engine_flushes_barrier_key"] == "2"
    assert lines["engine_flushes_barrier"] == "1"
    assert lines["engine_barriers_clean"] == "2"
    assert node.canonical() == run(CpuMergeEngine()).canonical()


def test_steady_rounds_count_by_route(monkeypatch):
    """Each steady round of a coalesced batch counts once: a round with a
    cold family (first seen, inside the warm-up), one with tensor rows
    and one after a forced-fold catch-up left a device env mirror stay on
    the Python micro path under their cause; every other round is
    planned natively.  INFO trace shows the counts, and the keyspace
    equals the CPU engine's."""
    import numpy as np
    from constdb_tpu_torch.crdt import tensor as T
    from constdb_tpu_torch.engine.base import MICRO_PYTHON_CAUSES
    from constdb_tpu_torch.server import commands
    monkeypatch.setattr(commands, "now_ms", lambda: W.MS0)
    cfg = T.pack_config(T.TensorMeta(T.STRATEGY_IDS["sum"], 0, (4,)))
    pay = np.arange(4, dtype=np.float32).tobytes()
    rounds = [([(b"sadd", b"s1", b"m1")], "cold"),
              ([(b"sadd", b"s1", b"m2")], None),
              ([(b"set", b"r1", b"a"), (b"sadd", b"s2", b"m3")], "cold"),
              ([(b"set", b"r1", b"b"), (b"cntset", b"c1", 4)], "cold"),
              ([(b"set", b"r2", b"c"), (b"cntset", b"c1", 5),
                (b"sadd", b"s1", b"m4")], None),
              ([(b"tset", b"t1", cfg, 1, pay), (b"set", b"r1", b"d")],
               "tns"),
              ([(b"delbytes", b"r2")], None),
              (W.make_workload(60, 2, seed=3), "env_mirror"),
              ([(b"sadd", b"s1", b"m5"), (b"cntset", b"c1", 6)], None)]

    def run(engine, check):
        node = Node(node_id=1, engine=engine, clock=lambda: W.MS0)
        ap = CoalescingApplier(node, ReplicaMeta("p:1"), max_frames=64,
                               max_latency=999.0)
        i = 0
        want = dict.fromkeys(("planned", *MICRO_PYTHON_CAUSES), 0)
        for bodies, cause in rounds:
            if cause == "env_mirror":
                node.merge_batches(bodies)      # a catch-up, then a round
                if check:
                    assert "env" in engine._res
                bodies = [(b"sadd", b"s3", b"m6")]
            for body in bodies:
                i += 1
                ap.apply(frame(u(i - 1) if i > 1 else 0, u(i), *body))
            ap.flush()
            if check:
                want[cause or "planned"] += 1
                value = engine.spans.value
                got = {c: value(f"engine.micro_python.{c}")
                       for c in MICRO_PYTHON_CAUSES}
                got["planned"] = value("engine.micro_planned")
                assert got == want, (bodies, cause)
        node.ensure_flushed()
        return node, want

    node, want = run(TorchMergeEngine(resident=True, steady=True, warmup=1,
                                      dense_fold="eager", device="cpu"),
                     True)
    text = node.execute(PM.Arr([PM.Bulk(b"info"),
                                PM.Bulk(b"trace")])).val.decode()
    lines = dict(ln.split(":", 1) for ln in text.split("\r\n")
                 if ln and not ln.startswith("#"))
    assert lines["engine_micro_planned"] == str(want["planned"]) == "4"
    assert {c: lines[f"engine_micro_python_{c}"]
            for c in MICRO_PYTHON_CAUSES} == \
        {"tns": "1", "cold": "3", "env_mirror": "1"}
    assert node.canonical() == run(CpuMergeEngine(), False)[0].canonical()


def test_an_engine_without_the_key_probe_flushes_whole():
    """An engine with deferred state and no key probe takes the whole
    flush before a key-scoped barrier (counted under its cause); a
    non-resident engine defers nothing, so nothing flushes."""
    class Deferring(CpuMergeEngine):
        def __init__(self):
            self.spans = trace.Totals()
            self.needs_flush = False
            self.flushed = 0

        def merge_many(self, store, batches):
            st = super().merge_many(store, batches)
            self.needs_flush = True
            return st

        def flush(self, store):
            self.flushed += 1
            self.needs_flush = False

    for engine, flushed in ((Deferring(), 1),
                            (TorchMergeEngine(resident=False,
                                              device="cpu"), 0)):
        node = Node(node_id=1, engine=engine, clock=lambda: W.MS0)
        node.merge_batches(W.make_workload(100, 2, seed=5))
        kid = next(k for k in range(node.ks.keys.n)
                   if node.ks.enc_of(k) == S.ENC_SET)
        node.apply_replicated(b"delset", [PM.Bulk(node.ks.key_bytes[kid])],
                              2, u(5), cause="barrier")
        value = engine.spans.value
        assert (value("engine.flushes.barrier"),
                value("engine.flushes.barrier_key"),
                value("engine.barriers_clean")) == (flushed, 0, 0)
        assert getattr(engine, "flushed", 0) == flushed
        assert int(node.ks.keys.dt[kid]) == u(5)


def test_no_label_and_no_record_while_off(monkeypatch):
    got = Labels()
    monkeypatch.setattr(torch.profiler, "record_function", got.Label)
    trace.enable(False)
    node = Node(node_id=1, device="cpu")
    node.merge_batches(W.make_workload(200, 2, seed=2))
    node.ensure_flushed()
    assert got.entered == [] and node.engine.spans.snapshot()
    trace.enable(True)
    try:
        with trace.span("t.on", into=trace.Totals()):
            pass
    finally:
        trace.enable(False)
    assert got.names() == ["cst:t.on"]


def test_the_collector_hook_counts_each_pass():
    trace._install_gc_hook()
    trace._install_gc_hook()
    assert sum(getattr(cb, "__module__", None) == trace.__name__
               for cb in gc.callbacks) == 1
    gc.disable()
    try:
        before = trace.gc_totals()
        gc.collect()
        after = trace.gc_totals()
    finally:
        gc.enable()
    assert after["gc.collections"] - before["gc.collections"] == 1
    assert after["gc.seconds"] > before["gc.seconds"]


def test_no_span_on_the_per_frame_path(labels):
    """Frames taken into a coalescing applier, short of its flush, open no
    span and add to no total."""
    node = Node(node_id=1, device="cpu")
    node.merge_batches(W.make_workload(100, 2, seed=4))
    ap = CoalescingApplier(node, ReplicaMeta("p:1"), max_frames=10_000,
                           max_latency=999.0)
    node_before = node.stats.spans.snapshot()
    eng_before = node.engine.spans.snapshot()
    n0 = len(labels.entered)
    for i in range(1, 200):
        ap.apply(frame(u(i - 1) if i > 1 else 0, u(i), b"sadd",
                       b"s%d" % (i % 7), b"m%d" % i))
    assert len(labels.entered) == n0
    assert node.stats.spans.snapshot() == node_before
    assert node.engine.spans.snapshot() == eng_before
    ap.flush()
    assert "cst:replica.encode" in labels.names()[n0:]


def test_concurrent_spans_lose_no_update():
    """More threads than cores add spans and counters to one owner's
    totals, with the interpreter switching threads as often as it can:
    every span and every count arrives."""
    import os
    import sys
    import threading

    own = trace.Totals()
    n_threads, n_each = 2 * (os.cpu_count() or 2) + 2, 400

    def work():
        for _ in range(n_each):
            with trace.span("t.shared", into=own, cpu=True):
                pass
            trace.count("t.shared_n", own)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work) for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    got = own.snapshot()
    assert got["t.shared"].count == got["t.shared_n"] == n_threads * n_each
