"""flush_s_per_mkey.catchup: the engine's flush seconds (family_secs
"flush": downloads, win-value resolution, the counter sums) per million
keys merged."""


def read(run):
    keys = run.window.get("keys")
    s = run.engine.get("family_secs.flush", 0.0)
    return s / keys * 1e6 if keys and s > 0 else None
