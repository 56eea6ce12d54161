"""Shared by the roofline readers: a kernel's least time over its launches
in the window, over its device seconds in the trace.

Where the trace holds fewer of the kernel's events than launches were
recorded (the profiler can drop records), the share is taken over as many
launches as it holds, the quickest of them: their least time is then a
lower bound, so the share is never read too high."""

from portbench import roofline


def share(run, kernel: str, least_each: list):
    """`least_each`: the least time of every launch recorded."""
    if run.trace is None or not least_each:
        return None
    from portbench.trace import kernel_events, kernel_seconds
    name = roofline.KERNEL_NAMES[kernel]
    seen = kernel_events(run.trace, name)
    if not seen:
        return None
    least = sum(sorted(least_each)[:seen])
    return roofline.share_pct(least, kernel_seconds(run.trace, name))
