"""dispatch_s_per_mkey.catchup: the engine's critical-path seconds of the
envelope, register, counter and element families (family_secs: the wait
for each family's staging, then its dispatch and uploads) per million
keys merged."""


def read(run):
    keys = run.window.get("keys")
    s = sum(run.engine.get(f"family_secs.{f}", 0.0)
            for f in ("env", "reg", "cnt", "el"))
    return s / keys * 1e6 if keys and s > 0 else None
