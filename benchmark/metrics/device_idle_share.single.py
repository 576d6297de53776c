"""Percent of the traced window in which no device operation ran: one
less the union of the profiler's device records over the window (from
the first search to the end of the last)."""


def read(rec):
    if not rec.kernels or rec.window_s <= 0:
        return None
    return 100.0 * (1.0 - rec.busy_s() / rec.window_s)
