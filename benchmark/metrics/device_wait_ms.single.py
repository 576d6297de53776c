"""Milliseconds a search the pipeline spent blocked on device readbacks:
``SearchPipeline.device_wait_s`` (``serving_split``) over the traced
window, divided by the searches served in it."""


def read(rec):
    if not rec.searches:
        return None
    return rec.counters["device_wait_s"] * 1e3 / rec.searches
