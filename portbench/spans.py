"""The program's own spans and counters in one run of a cell, by hand:

    python3 -m portbench.spans --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1> --record <0|1>

from the root of a checkout.  The harness does not turn the program's
tracing on (constdb_tpu_torch/utils/trace.py) and reads none of its
totals yet; this runs a cell's set-up and window as the harness does and
prints one JSON line:

* `rate`: the window's frames/s (stream) or keys/s (catch-up), over the
  whole window when untraced; `--record 1` turns the program's tracing
  on for the whole window, so that every span opens its profiler label
  (tracing's cost: compare with `--record 0` on the same seeds);
* `readings`: the per-layer readings below, from the change of the
  node's and its engine's span totals and of the collector's totals
  over the untraced part of the window, as the harness takes the
  engine's counters;
* traced (`--trace 1`, the program's tracing on while the profiler
  runs): `idle_gaps`, the idle seconds under the innermost `cst:`
  (program) or `pb:` (harness) label of the thread that drove the
  window, and `idle_unspanned_s`, those under no `cst:` label.

Readings: resolve_s_per_mkey, stage_wait_s_per_mkey (catch-ups: wall of
`engine.resolve_keys`, of every `engine.stage_wait.*`, per million keys
merged), stage_cpu_share (thread CPU of `engine.stage.*` over their
wall, %), gc_share (`gc.seconds` over the part's wall, %),
encode_us_per_frame (stream: `replica.encode` per frame),
barrier_flushes_per_kframe (`engine.flushes.barrier` per 1000 frames),
idle_unspanned (traced: idle under no `cst:` label over all idle, %).
"""

from __future__ import annotations

import argparse
import contextlib
import gc
import importlib
import json
import sys
from pathlib import Path

from . import harness
from .trace import OUTSIDE, PREFIX, WINDOW, Tracer, attribute, gaps, \
    innermost, union

ROOT = Path(__file__).resolve().parent.parent
CST = "cst:"
FAMILIES = ("env", "reg", "cnt", "el")


def idle_by_label(device: list, labels: list, window: tuple) -> tuple:
    """The idle seconds of the window (start_us, end_us): -> ({innermost
    label: seconds}, seconds under no program span).  `labels` (name,
    start_us, end_us) hold "cst:" names (the program's spans) and bare
    names (the harness's labels, their "pb:" taken off), nested as the
    calls nest; a harness label inside a program span is still under
    that span."""
    lo, hi = window
    busy = union([(s, e) for _n, s, e in device], lo, hi)
    idle = gaps(busy, lo, hi)
    program = [x for x in labels if x[0].startswith(CST)]
    return attribute(idle, innermost(labels)), \
        attribute(idle, innermost(program)).get(OUTSIDE, 0.0)


def totals(node) -> dict:
    """The node's and its engine's span totals and counters, and the
    collector's totals: {name: SpanTotal or value}."""
    from constdb_tpu_torch.utils import trace
    out = node.stats.spans.snapshot()
    spans = getattr(node.engine, "spans", None)
    if spans is not None:
        out.update(spans.snapshot())
    out.update(trace.gc_totals())
    return out


def delta(after: dict, before: dict) -> dict:
    """The change of totals() between two readings: span totals field by
    field, counters by value."""
    out = {}
    for k, v in after.items():
        b = before.get(k)
        if isinstance(v, tuple):
            out[k] = type(v)(*(x - y for x, y in zip(v, b))) if b else v
        else:
            out[k] = v - (b or 0)
    return out


def readings(spans: dict, window: dict, idle=None) -> dict:
    """The readings of one run (module docstring); a reading with nothing
    to read is left out.  `spans`: the change of the program's totals
    over the window's untraced part; `window`: that part's record;
    `idle`: idle_by_label's result over the traced part."""
    def wall(name):
        t = spans.get(name)
        return t.wall_s if t else 0.0
    out = {}
    keys, frames, secs = (window.get(k) for k in ("keys", "frames",
                                                  "wall_s"))
    if keys:
        resolve = wall("engine.resolve_keys")
        wait = sum(wall(f"engine.stage_wait.{f}") for f in FAMILIES)
        stages = [spans[f"engine.stage.{f}"] for f in FAMILIES
                  if f"engine.stage.{f}" in spans]
        if resolve:
            out["resolve_s_per_mkey"] = resolve / keys * 1e6
        if wait:
            out["stage_wait_s_per_mkey"] = wait / keys * 1e6
        if sum(t.wall_s for t in stages):
            out["stage_cpu_share"] = 100.0 * sum(t.cpu_s for t in stages) \
                / sum(t.wall_s for t in stages)
    if secs and "gc.seconds" in spans:
        out["gc_share"] = 100.0 * spans["gc.seconds"] / secs
    if frames:
        if "replica.encode" in spans:
            out["encode_us_per_frame"] = wall("replica.encode") / frames \
                * 1e6
        out["barrier_flushes_per_kframe"] = \
            spans.get("engine.flushes.barrier", 0) / frames * 1e3
    if idle and sum(idle[0].values()):
        out["idle_unspanned"] = 100.0 * idle[1] / sum(idle[0].values())
    return out


class SpanTracer(Tracer):
    """The harness's profiler around the window, with the program's
    tracing on while it runs, and the program's labels beside the
    harness's in the reduction of its events."""

    @contextlib.contextmanager
    def window(self):
        from constdb_tpu_torch.utils import trace
        self._was = trace.enabled()
        with super().window():
            if self.on:
                trace.enable(True)
            yield

    def stop(self) -> None:
        if self.recording:
            from constdb_tpu_torch.utils import trace
            trace.enable(self._was)
        super().stop()

    def idle(self):
        """idle_by_label over the traced window, or None."""
        if self.prof is None:
            return None
        from torch.autograd import DeviceType
        events = list(self.prof.events())
        win = thread = None
        for ev in events:
            if ev.name == WINDOW and ev.device_type == DeviceType.CPU:
                win, thread = (ev.time_range.start, ev.time_range.end), \
                    ev.thread
        device, labels = [], []
        for ev in events:
            tr, name = ev.time_range, ev.name
            if name.startswith((PREFIX, CST)):
                if ev.device_type == DeviceType.CPU and \
                        ev.thread == thread and name != WINDOW:
                    labels.append((name[len(PREFIX):]
                                   if name.startswith(PREFIX) else name,
                                   tr.start, tr.end))
            elif ev.device_type == DeviceType.CUDA:
                device.append((name, tr.start, tr.end))
        if win is None or not device:
            return None
        return idle_by_label(device, labels, win)


def run(root: Path, workload: str, seed: int, seconds: float, traced: bool,
        record: bool, device, log) -> dict:
    from constdb_tpu_torch.utils import trace
    spec = harness.load_spec(root, workload)
    ctx = harness.Ctx(spec, seed, device, traced)
    ctx.log = log
    try:
        kind = importlib.import_module(
            f"portbench.kinds.{spec.traffic['kind']}").Kind(ctx)
        kind.setup()
        ctx.sync()
        node = kind.node_state()
        at_stop = {}
        ctx.on_trace_stop = lambda: at_stop.update(totals(node))
        tracer = ctx.tracer = SpanTracer(traced and ctx.on_card,
                                         spec.traffic.get("trace_seconds"))
        trace.enable(record)
        before = totals(node)
        with tracer.window():
            rec = kind.window(seconds)
        trace.enable(False)
        spans = delta(totals(node), at_stop or before)
        idle = tracer.idle()
    finally:
        trace.enable(False)
        ctx.restore()
        gc.unfreeze()
    part = rec.get("untraced", rec)
    whole = rec.get("frames", rec.get("keys", 0))
    top = sorted(((k, v.wall_s) for k, v in spans.items()
                  if isinstance(v, tuple) and v.wall_s > 0),
                 key=lambda kv: -kv[1])
    out = {"workload": workload, "seed": seed, "trace": int(traced),
           "record": int(record), "rate": whole / rec["wall_s"],
           "readings": readings(spans, part, idle),
           "span_wall_s": dict(top[:16]),
           "counters": {k: v for k, v in spans.items()
                        if not isinstance(v, tuple)}}
    if idle is not None:
        out["idle_gaps"] = dict(sorted(idle[0].items(),
                                       key=lambda kv: -kv[1])[:16])
        out["idle_unspanned_s"] = idle[1]
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--record", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    import torch
    device = torch.device("cuda", 0) if torch.cuda.is_available() \
        else torch.device("cpu")
    out = run(ROOT, args.workload, args.seed, args.seconds,
              bool(args.trace), bool(args.record), device,
              lambda msg: print(msg, file=sys.stderr, flush=True))
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
