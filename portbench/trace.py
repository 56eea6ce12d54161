"""The traced run: host labels around the calls into each layer, the
profiler around the window, and the reduction of its events.

Labels are `torch.profiler.record_function` spans named "pb:<layer call>"
that the harness opens around its own calls into the program (and, in a
traced run only, around engine methods it wraps from outside).  The
reduction works on plain tuples so that it can be tested without a card:

* device events (name, start_us, end_us): kernels and copies;
* host labels (name, start_us, end_us) of the thread that drove the
  window, nested as the calls nest.

From them: the device's busy seconds (the union of its events inside the
window), the seconds each kernel name took, the idle gaps between device
events with the innermost host label that covered each part of them, and
the window's length.
"""

from __future__ import annotations

import contextlib

PREFIX = "pb:"
WINDOW = PREFIX + "window"
OUTSIDE = "harness (no label)"


def union(intervals: list, lo: float, hi: float) -> list:
    """Sorted, merged [start, end) intervals clipped to [lo, hi]."""
    out = []
    for s, e in sorted((max(s, lo), min(e, hi)) for s, e in intervals):
        if e <= s:
            continue
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def gaps(busy: list, lo: float, hi: float) -> list:
    """The idle [start, end) intervals of [lo, hi] between busy ones."""
    out, t = [], lo
    for s, e in busy:
        if s > t:
            out.append((t, s))
        t = max(t, e)
    if hi > t:
        out.append((t, hi))
    return out


def innermost(labels: list) -> list:
    """Nested labels (name, start, end) -> the flat timeline of the
    innermost open label: [(start, end, name)], sorted, disjoint."""
    events = []
    for name, s, e in labels:
        events.append((s, 1, -e, name))
        events.append((e, 0, 0, name))
    events.sort()
    out, stack, t = [], [], None
    for when, is_open, _neg_end, name in events:
        if stack and t is not None and when > t:
            out.append((t, when, stack[-1]))
        if is_open:
            stack.append(name)
        elif name in stack:
            # close the innermost open label of that name
            del stack[len(stack) - 1 - stack[::-1].index(name)]
        t = when
    return out


def attribute(idle: list, timeline: list) -> dict:
    """Seconds of the idle intervals (us) under each innermost label."""
    out: dict = {}
    j = 0
    for s, e in idle:
        covered = 0.0
        while j < len(timeline) and timeline[j][1] <= s:
            j += 1
        k = j
        while k < len(timeline) and timeline[k][0] < e:
            a, b, name = timeline[k]
            o = min(b, e) - max(a, s)
            if o > 0:
                out[name] = out.get(name, 0.0) + o / 1e6
                covered += o
            k += 1
        rest = (e - s) - covered
        if rest > 0:
            out[OUTSIDE] = out.get(OUTSIDE, 0.0) + rest / 1e6
    return out


def summarize(device: list, labels: list, window: tuple) -> dict:
    """-> {"busy_s", "window_s", "kernel_s": {name: seconds},
    "kernel_n": {name: events}, "device_ops": top 10 [name, seconds],
    "idle_gaps": top 10 [label, idle seconds]} over the window
    (start_us, end_us)."""
    lo, hi = window
    busy = union([(s, e) for _n, s, e in device], lo, hi)
    by_name: dict = {}
    launches: dict = {}
    for name, s, e in device:
        d = min(e, hi) - max(s, lo)
        if d > 0:
            by_name[name] = by_name.get(name, 0.0) + d / 1e6
            launches[name] = launches.get(name, 0) + 1
    idle = attribute(gaps(busy, lo, hi), innermost(labels))
    top = lambda d: [[k[:120], v] for k, v in  # noqa: E731
                     sorted(d.items(), key=lambda kv: -kv[1])[:10]]
    return {"busy_s": sum(e - s for s, e in busy) / 1e6,
            "window_s": (hi - lo) / 1e6, "kernel_s": by_name,
            "kernel_n": launches,
            "device_ops": top(by_name), "idle_gaps": top(idle)}


def kernel_seconds(summary: dict, kernel: str) -> float:
    """Device seconds of events whose name holds `kernel`."""
    return sum(v for k, v in summary["kernel_s"].items() if kernel in k)


def kernel_events(summary: dict, kernel: str) -> int:
    """The number of events whose name holds `kernel`."""
    return sum(v for k, v in summary.get("kernel_n", {}).items()
               if kernel in k)


class Tracer:
    """The profiler around a traced run's window (or its first `seconds`
    of it, where a traffic mix sets `trace_seconds`), or nothing at all.
    `recording` is true while the profiler runs: the harness records
    kernel shapes only then, so that they match the trace's kernels."""

    def __init__(self, on: bool, seconds=None):
        self.on, self.seconds = on, seconds
        self.prof = self._label = None
        self.recording = False

    @contextlib.contextmanager
    def window(self):
        if not self.on:
            yield
            return
        import inspect

        import torch
        from torch.profiler import ProfilerActivity, profile
        kw = {"acc_events": True} \
            if "acc_events" in inspect.signature(profile).parameters else {}
        torch.cuda.synchronize()
        self.prof = profile(activities=[ProfilerActivity.CPU,
                                        ProfilerActivity.CUDA], **kw)
        self.prof.start()
        self._label = torch.profiler.record_function(WINDOW)
        self._label.__enter__()
        self.recording = True
        try:
            yield
        finally:
            self.stop()

    def tick(self, elapsed_s: float) -> bool:
        """Stop tracing once `seconds` of the window have passed.  -> True
        on the tick that stopped it."""
        if self.recording and self.seconds and elapsed_s >= self.seconds:
            self.stop()
            return True
        return False

    def stop(self) -> None:
        if not self.recording:
            return
        import torch
        torch.cuda.synchronize()
        self._label.__exit__(None, None, None)
        self.prof.stop()
        self.recording = False

    def summary(self):
        """The reduction of the traced window, or None (no trace, or a
        trace in which the device ran nothing)."""
        if self.prof is None:
            return None
        from torch.autograd import DeviceType
        device, labels, win, thread = [], [], None, None
        events = list(self.prof.events())
        for ev in events:
            if ev.name == WINDOW and ev.device_type == DeviceType.CPU:
                win = (ev.time_range.start, ev.time_range.end)
                thread = ev.thread
        for ev in events:
            tr = ev.time_range
            if ev.name.startswith(PREFIX):
                # the labels also appear on the device's timeline as
                # annotations: they are the host's, not device work
                if ev.device_type == DeviceType.CPU and \
                        ev.thread == thread and ev.name != WINDOW:
                    labels.append((ev.name[len(PREFIX):], tr.start, tr.end))
            elif ev.device_type == DeviceType.CUDA:
                device.append((ev.name, tr.start, tr.end))
        if win is None or not device:
            return None
        return summarize(device, labels, win)
