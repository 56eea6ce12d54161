"""land_us_per_frame.stream: host time inside Node.merge_stream_batch
(the batch's finalize, the engine's steady round, K3) per frame."""


def read(run):
    w = run.window
    return w["land_s"] / w["frames"] * 1e6 if w.get("frames") else None
