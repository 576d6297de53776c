"""Queries answered in the traced window over its length, on the host
clock (the batch entry's own rate, read under the profiler)."""


def read(rec):
    return rec.window_metrics.get("qps")
