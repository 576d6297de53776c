"""Milliseconds a batch the pipeline thread spent blocked on device
readbacks: ``SearchPipeline.device_wait_s`` (``serving_split``) over the
traced window, divided by the batches served in it."""


def read(rec):
    if not rec.batches:
        return None
    return rec.counters["device_wait_s"] * 1e3 / rec.batches
