"""Milliseconds a batch the pipeline thread spent assembling coverage
candidates: the program's ``pipeline.coverage_begin`` spans
(``SearchPipeline._coverage_begin_fast``, one a query: the WordMatcher
lookup or the wait on its prefetch, ``prepare_query``, the prior with the
conjunctive pool or the wait on it, the heads and LIM tail, the key memo)
on the pipeline thread alone, over the batches served. One thread and no
nesting, so nothing is counted twice; worker threads' time is not in
it."""

from benchmark import program_trace as pt

install = pt.install


def read(rec):
    return pt.span_ms(rec, ["pipeline.coverage_begin"], rec.batches,
                      main_only=True)
