"""h2d_bytes_per_key.catchup: bytes the engine copied to the device
(bytes_h2d) per key merged."""


def read(run):
    keys = run.window.get("keys")
    b = run.engine.get("bytes_h2d", 0)
    return b / keys if keys and b > 0 else None
