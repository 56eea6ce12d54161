"""repl_frames_per_s: every frame fed from all peers in the window, over
the seconds from the first byte parsed to the final flush and
synchronize."""


def read(run):
    w = run.window
    return w["frames"] / w["wall_s"] if w.get("frames") else None
