"""Percent of the window's pre-filter mask lookups that the ColumnStore's
mask cache answered: the program's counters ``prefilter.hit /
(prefilter.hit + prefilter.miss)`` (``SearchEngine._prefilter_mask``, one
lookup a pipeline group with a filter). None where the program counts
neither."""

from benchmark import program_trace as pt

install = pt.install


def read(rec):
    hit = pt.counter(rec, "prefilter.hit")
    miss = pt.counter(rec, "prefilter.miss")
    if hit is None or not hit + miss:
        return None
    return 100.0 * hit / (hit + miss)
