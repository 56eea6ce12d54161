"""barrier_us_per_frame.stream: host time inside Node.apply_replicated
(the barriers: their flush of the resident planes and their op) per
frame."""


def read(run):
    w = run.window
    return w["barrier_s"] / w["frames"] * 1e6 if w.get("frames") else None
