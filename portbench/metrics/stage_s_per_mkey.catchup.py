"""stage_s_per_mkey.catchup: the engine's staging seconds (its stage_secs,
all families; they run on the staging threads, beside dispatch) per
million keys merged."""


def read(run):
    keys = run.window.get("keys")
    s = sum(v for k, v in run.engine.items() if k.startswith("stage_secs."))
    return s / keys * 1e6 if keys and s > 0 else None
