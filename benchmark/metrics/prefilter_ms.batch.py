"""Milliseconds a batch of 128 queries spent finding pre-filter masks:
the program's ``engine.prefilter`` spans (``SearchEngine._prefilter_mask``,
one a pipeline group with a filter: the lookup of its mask by filter key
in the ColumnStore's cache, and the mask's evaluation over every document
where the cache misses), over the batches served. None where the program
records no such span."""

from benchmark import program_trace as pt

install = pt.install


def read(rec):
    return pt.span_ms(rec, ["engine.prefilter"], rec.batches)
