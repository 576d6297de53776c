"""The 95th percentile latency of every search in the traced window, on
the host clock (the single entry's own reading, under the profiler)."""


def read(rec):
    return rec.window_metrics.get("search_p95_ms")
