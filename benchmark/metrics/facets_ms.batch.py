"""Milliseconds a batch of 128 queries spent counting facets: the
program's ``engine.facets`` spans (``SearchEngine._build_facets_batch``,
one a call's answers: each facetable field's count matrix on the card or
the host, then each query's top values), over the batches served. None
where the program records no such span."""

from benchmark import program_trace as pt

install = pt.install


def read(rec):
    return pt.span_ms(rec, ["engine.facets"], rec.batches)
