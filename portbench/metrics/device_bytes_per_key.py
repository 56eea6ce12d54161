"""device_bytes_per_key: the CUDA allocator's peak over the window (reset
at its start) over the keys the node holds at its end."""


def read(run):
    peak, keys = run.peak_window_bytes, run.window.get("keys_held")
    if not run.on_card or not peak or not keys:
        return None
    return peak / keys
