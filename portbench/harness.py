"""One run of one cell: set-up, the measured window, the check, the line.

Everything a cell is made of is found by name from `BENCHMARK.json`:

* the cell (`workloads` entry) names a configuration and a traffic mix;
* the configuration's file is the `file` of its `configs` entry;
* the traffic mix is `portbench/traffic/<traffic>.json`, whose `kind`
  names the code that runs it, in `portbench/kinds/`;
* each metric is read by `portbench/metrics/<metric name>.py`, a module
  with `read(run) -> number or None` (None: nothing to read here, and the
  metric is left out of the line).

With `--trace 0` the line carries the cell's end-to-end metrics, with
`--trace 1` its per-layer metrics, read from a run under the profiler.
"""

from __future__ import annotations

import contextlib
import gc
import importlib
import importlib.util
import json
import os
import sys
import time
from pathlib import Path
from types import SimpleNamespace

from .readout import keyspace_state
from .reference import compare
from .trace import Tracer

FORBIDDEN = ("jax", "jaxlib", "flax", "constdb_tpu")

# engine counters whose change over the window a metric reader may take
# (later readers are new files: the harness hands them every counter)
ENGINE_COUNTERS = ("family_secs", "stage_secs", "bytes_h2d", "bytes_d2h",
                   "h2d_copies", "folds", "dev_rounds_resident",
                   "host_micro_rounds", "flush_rows_downloaded",
                   "mirror_patches", "mirror_rebuilds")


def process_age_s() -> float:
    """Seconds since this process started (its start time in /proc);
    the time since this module was imported where /proc is missing."""
    try:
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            up = float(f.read().split()[0])
        return up - start_ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return time.perf_counter() - _IMPORTED


_IMPORTED = time.perf_counter()


def load_spec(root: Path, workload: str) -> SimpleNamespace:
    """The cell, its configuration and traffic, and its metrics."""
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise SystemExit(f"no workload {workload!r} in BENCHMARK.json "
                         f"(cells: {', '.join(cells)})")
    cell = cells[workload]
    configs = {c["name"]: c for c in bench["configs"]}
    config = json.loads((root / configs[cell["config"]]["file"]).read_text())
    traffic = json.loads(
        (root / "portbench" / "traffic" / f"{cell['traffic']}.json")
        .read_text())

    def mine(metrics):
        return [m for m in metrics
                if workload in m.get("workloads", [workload])]
    return SimpleNamespace(root=root, cell=cell, config=config,
                           traffic=traffic,
                           end_to_end=mine(bench["end_to_end"]),
                           per_layer=mine(bench["per_layer"]))


def metric_reader(root: Path, name: str):
    path = root / "portbench" / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"portbench.metrics.{name.replace('.', '__')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


class Ctx:
    """What a traffic kind may ask of the harness."""

    def __init__(self, spec, seed: int, device, trace: bool):
        self.config, self.traffic = spec.config, spec.traffic
        self.seed, self.device, self.trace = seed, device, trace
        self.on_card = device.type == "cuda"
        self.shapes = {"segment_sum": [], "scatter_round": []}
        self._restore = lambda: None
        self.tracer = Tracer(False)

    def label(self, name: str):
        if not self.trace:
            return contextlib.nullcontext()
        import torch
        return torch.profiler.record_function("pb:" + name)

    def trace_tick(self, elapsed_s: float) -> bool:
        """Called by a kind's window loop between units of work: ends a
        partial trace on time.  -> True on the tick that ended it; the
        kind then starts the untraced part of its window accounts, from
        which a traced run's host and program metrics are read (the
        profiler slows the host)."""
        if not self.tracer.tick(elapsed_s):
            return False
        self.on_trace_stop()
        return True

    def on_trace_stop(self) -> None:
        pass

    def log_setup(self, step: str) -> None:
        """Set-up's progress on standard error: seconds since the
        process started, at the end of each step."""
        self.log(f"[portbench] set-up: {step} done at "
                 f"{process_age_s():.2f} s")

    def sync(self) -> None:
        if self.on_card:
            import torch
            torch.cuda.synchronize(self.device)

    def make_node(self):
        """The node under test, with its default engine on the device."""
        from constdb_tpu_torch.server.node import Node
        return Node(node_id=1, device=self.device)

    @staticmethod
    def freeze_inputs() -> None:
        """Move the generated inputs out of the collector's sight: in a
        deployment they arrive and are dropped, where here they stay
        alive through the window, and Python's collector would scan them
        on the node's time."""
        gc.collect()
        gc.freeze()

    def instrument(self, node) -> None:
        """Traced run: labels around the engine's family dispatches, its
        flush and its counter-sum re-derivation, and the shapes of every
        K3 and K4 launch (for the rooflines)."""
        if not self.trace:
            return
        eng = node.engine
        for attr, name in (("_dispatch_envelopes", "engine.dispatch.env"),
                           ("_dispatch_registers", "engine.dispatch.reg"),
                           ("_dispatch_counter_rows", "engine.dispatch.cnt"),
                           ("_dispatch_elem_rows", "engine.dispatch.el"),
                           ("_merge_micro_resident", "engine.micro_round"),
                           ("flush", "engine.flush"),
                           ("_recompute_sums", "engine.sums")):
            if hasattr(eng, attr):
                setattr(eng, attr, self._labelled(name, getattr(eng, attr)))
        from constdb_tpu_torch.ops import bulk, kernels
        kinds = {bulk.PAIR_SRC: "pair_src", bulk.PAIR: "pair",
                 bulk.MAX1: "max1"}
        k4, k3, shapes = kernels.segment_sum, kernels.scatter_round, \
            self.shapes

        def segment_sum(ids, vals, n_seg, base=None):
            if self.tracer.recording and ids.shape[0] and n_seg:
                shapes["segment_sum"].append(
                    (int(ids.shape[0]), int(n_seg), base is not None))
            return k4(ids, vals, n_seg, base=base)

        def scatter_round(segs):
            if self.tracer.recording:
                shapes["scatter_round"].append(
                    [(kinds[g.kind], int(g.idx.shape[0])) for g in segs
                     if g.idx.shape[0]])
            return k3(segs)
        kernels.segment_sum = segment_sum
        kernels.scatter_round = scatter_round
        self._restore = lambda: (setattr(kernels, "segment_sum", k4),
                                 setattr(kernels, "scatter_round", k3))

    def restore(self) -> None:
        """Put back the kernel wrappers `instrument` replaced."""
        self._restore()

    def _labelled(self, name, fn):
        def run(*a, **kw):
            with self.label(name):
                return fn(*a, **kw)
        return run


def _counters(node) -> dict:
    from constdb_tpu_torch.ops import kernels
    eng = node.engine
    out = {}
    for name in ENGINE_COUNTERS:
        v = getattr(eng, name, None)
        if isinstance(v, dict):
            out.update({f"{name}.{k}": x for k, x in v.items()
                        if isinstance(x, (int, float))})
        elif isinstance(v, (int, float)):
            out[name] = v
    out.update({f"launches.{k}": v for k, v in kernels.LAUNCHES.items()})
    return out


def cpu_s() -> float:
    """This process's CPU seconds so far, all its threads."""
    t = os.times()
    return t.user + t.system


def _power_limit() -> str:
    import subprocess
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "not read"


def run_cell(root: Path, workload: str, seed: int, seconds: float,
             trace: bool, device, log=None) -> dict:
    """One run; -> the result line's object (its `check` key last)."""
    log = log or (lambda msg: print(msg, file=sys.stderr, flush=True))
    spec = load_spec(root, workload)
    metrics = spec.per_layer if trace else spec.end_to_end
    readers = {m["name"]: metric_reader(root, m["name"]) for m in metrics}
    ctx = Ctx(spec, seed, device, trace)
    ctx.log = log
    try:
        return _run(spec, ctx, metrics, readers, seconds, log)
    finally:
        ctx.restore()
        gc.unfreeze()


def _run(spec, ctx, metrics, readers, seconds, log) -> dict:
    import torch
    device, workload, seed = ctx.device, spec.cell["name"], ctx.seed
    trace = ctx.trace
    kind = importlib.import_module(
        f"portbench.kinds.{spec.traffic['kind']}").Kind(ctx)
    kind.setup()
    ctx.sync()
    setup_s = process_age_s()
    log(f"[portbench] {workload} seed {seed}: set-up {setup_s:.3f} s")

    node = kind.node_state()
    before = _counters(node)
    at_stop = {}
    ctx.on_trace_stop = lambda: at_stop.update(_counters(node))
    peak_setup = 0
    if ctx.on_card:
        peak_setup = torch.cuda.max_memory_allocated(device)
        torch.cuda.reset_peak_memory_stats(device)
    tracer = ctx.tracer = Tracer(trace and ctx.on_card,
                                 spec.traffic.get("trace_seconds"))
    cpu0, t0 = cpu_s(), time.perf_counter()
    with tracer.window():
        rec = kind.window(seconds)
    log(f"[portbench] the window kept "
        f"{(cpu_s() - cpu0) / (time.perf_counter() - t0):.2f} of the "
        f"host's cores busy in this process")
    peak_window = torch.cuda.max_memory_allocated(device) \
        if ctx.on_card else None
    after = _counters(node)
    # a partly traced window: host and program metrics over its untraced
    # part, device metrics over the traced part
    base = at_stop or before
    delta = {k: after[k] - base.get(k, 0) for k in after}
    summary = tracer.summary() if ctx.on_card else None
    if trace and ctx.on_card and summary is None:
        raise RuntimeError("the profiler saw no device event in the "
                           "traced window")
    ctx.tracer = tracer = Tracer(False)

    got = keyspace_state(node.ks)
    kind.release()
    node = None
    gc.collect()
    if ctx.on_card:
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    counts = compare.compare(got, kind.reference())
    log(f"[portbench] check took {time.perf_counter() - t0:.3f} s")

    run = SimpleNamespace(window=rec.get("untraced", rec), engine=delta,
                          trace=summary,
                          shapes=ctx.shapes, on_card=ctx.on_card,
                          peak_window_bytes=peak_window, setup_s=setup_s,
                          config=spec.config, traffic=spec.traffic)
    values = {}
    for m in metrics:
        if m["source"] == "device_trace" and not ctx.on_card:
            continue   # no device number from a CPU rehearsal
        v = readers[m["name"]](run)
        if v is not None:
            values[m["name"]] = {"value": v, "unit": m["unit"]}
    if summary is not None:
        from .roofline import KERNEL_NAMES
        from .trace import kernel_events, kernel_seconds
        for key, shapes in (("k4", "segment_sum"), ("k3", "scatter_round")):
            name = KERNEL_NAMES[key]
            log(f"[portbench] {name}: {len(ctx.shapes[shapes])} launches "
                f"recorded, {kernel_events(summary, name)} in the trace, "
                f"{kernel_seconds(summary, name)!r} s")
    if trace and ctx.on_card:
        limit = _power_limit()
        for name, v in values.items():
            if name.endswith("_roofline") or "_roofline." in name:
                log(f"[portbench] {name} {v['value']} % of the data "
                    f"sheet's peak; card and power limit: {limit}")

    correct = sum(counts.values()) == 0
    attempted = int(rec.get("catchups", rec.get("frames", 0)))
    out = {"correct": correct, "attempted": attempted,
           "failed": 0 if correct else attempted, "metrics": values,
           "device": _device(device, peak_setup, peak_window, summary)}
    if summary is not None:
        out["breakdown"] = {"device_ops": summary["device_ops"],
                            "idle_gaps": summary["idle_gaps"]}
    # one number is compared: every key, slot and row that differs from
    # the reference's (an exact comparison: its limit is 0); the count
    # per family is printed beside it, for the reader
    log("[portbench] mismatches by family: " +
        ", ".join(f"{k} {v}" for k, v in counts.items()))
    out["check"] = {"mismatches": {"value": sum(counts.values()),
                                   "limit": 0}}
    return out


def _device(device, peak_setup, peak_window, summary) -> dict:
    import torch
    if device.type != "cuda":
        import platform
        return {"platform": "cpu", "kind": platform.machine() or "cpu",
                "count": 1, "memory_peak_bytes": None}
    d = {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
         "count": 1, "memory_peak_bytes": max(peak_setup, peak_window)}
    if summary is not None:
        d["busy_s"] = summary["busy_s"]
        d["window_s"] = summary["window_s"]
    return d


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's, its libraries' or the
    JAX package's, compared whole."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))
