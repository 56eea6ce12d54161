"""intake_us_per_frame.stream: the window less the host time inside
Node.merge_stream_batch and Node.apply_replicated (timed by the harness
around those calls): parsing, the appliers' intake, the group encoders,
per frame."""


def read(run):
    w = run.window
    if not w.get("frames"):
        return None
    rest = w["wall_s"] - w["land_s"] - w["barrier_s"]
    return rest / w["frames"] * 1e6
