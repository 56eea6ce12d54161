"""visibility_p99_ms.stream: the 99th percentile of intake -> landed over
every sample of the window (every 64th frame of each peer)."""

from portbench.stats import percentile


def read(run):
    lat = run.window.get("latencies")
    return percentile(lat, 99) * 1e3 if lat else None
