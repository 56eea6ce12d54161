"""Spans and counters of the port: where the host's time goes.

A span adds its wall time (`perf_counter_ns`) to a per-name total of its
owner's `Totals` (an engine's, a node's), and with `cpu=True` its
thread's CPU time (`thread_time_ns`) too; a counter adds to a per-name
value.  These totals are always on: an engine's and a node's timers are
views over their own, so two engines in one process keep their numbers
apart.

While `enable(True)`, each span also opens
`torch.profiler.record_function("cst:" + name)`, so that a profiler's
trace shows the program's spans on the clock of the device events.
Disabled (the default), no label is opened: it costs microseconds even
with no profiler running.

Python's collector is counted through one `gc.callbacks` hook
(`gc_totals()`: its passes and seconds in this process).

No span belongs on a per-frame path (the parser, the appliers' intake):
a span costs about a microsecond.
"""

from __future__ import annotations

import gc
import threading
import time
from typing import NamedTuple

_now = time.perf_counter_ns
_cpu_now = time.thread_time_ns


class SpanTotal(NamedTuple):
    count: int
    wall_s: float
    cpu_s: float


class Totals:
    """Per-name totals: spans [count, wall ns, thread-CPU ns] and counter
    values.  Updated under one process-wide lock (staging threads add to
    an engine's concurrently)."""

    __slots__ = ("spans", "counters")

    def __init__(self) -> None:
        self.spans: dict = {}
        self.counters: dict = {}

    def wall(self, name: str) -> float:
        """Wall seconds of the spans named `name` (0.0 when none ran)."""
        e = self.spans.get(name)
        return e[1] / 1e9 if e else 0.0

    def value(self, name: str):
        return self.counters.get(name, 0)

    def snapshot(self) -> dict:
        """{span name: SpanTotal, counter name: value}."""
        out: dict = {k: SpanTotal(c, w / 1e9, u / 1e9)
                     for k, (c, w, u) in list(self.spans.items())}
        out.update(self.counters)
        return out


_lock = threading.Lock()
_enabled = False
# the collector's passes and nanoseconds: written only by the gc hook
# (never under _lock: a collection can start while a thread holds it)
_gc = [0, 0, 0]          # collections, ns, start of the running pass


def count(name: str, into: Totals, n=1) -> None:
    """Add `n` to the counter `name` of `into`."""
    with _lock:
        into.counters[name] = into.counters.get(name, 0) + n


def gc_totals() -> dict:
    """The collector's passes and seconds in this process so far."""
    return {"gc.collections": _gc[0], "gc.seconds": _gc[1] / 1e9}


def enable(on: bool) -> None:
    """Open each span's profiler label (on), or keep the totals only
    (off, the default)."""
    global _enabled
    _enabled = bool(on)


def enabled() -> bool:
    return _enabled


class span:
    """`with span(name, into):` adds the block's wall time to `into`'s
    total of `name`; `cpu`: also its thread's CPU time."""

    __slots__ = ("name", "into", "cpu", "t0", "c0", "label")

    def __init__(self, name: str, into: Totals, cpu: bool = False) -> None:
        self.name, self.into, self.cpu = name, into, cpu
        self.label = None

    def __enter__(self) -> "span":
        if _enabled:
            import torch
            self.label = torch.profiler.record_function("cst:" + self.name)
            self.label.__enter__()
        self.c0 = _cpu_now() if self.cpu else 0
        self.t0 = _now()
        return self

    def __exit__(self, *exc) -> None:
        wall = _now() - self.t0
        cpu = _cpu_now() - self.c0 if self.cpu else 0
        with _lock:
            e = self.into.spans.get(self.name)
            if e is None:
                self.into.spans[self.name] = [1, wall, cpu]
            else:
                e[0] += 1
                e[1] += wall
                e[2] += cpu
        if self.label is not None:
            self.label.__exit__(None, None, None)
            self.label = None


def _on_gc(phase: str, info: dict) -> None:
    if phase == "start":
        _gc[2] = _now()
    elif _gc[2]:
        _gc[0] += 1
        _gc[1] += _now() - _gc[2]
        _gc[2] = 0


def _install_gc_hook() -> None:
    """One hook per process, also when this module is loaded again."""
    gc.callbacks[:] = [cb for cb in gc.callbacks
                       if getattr(cb, "__module__", None) != __name__
                       or getattr(cb, "__name__", None) != "_on_gc"]
    gc.callbacks.append(_on_gc)


_install_gc_hook()
