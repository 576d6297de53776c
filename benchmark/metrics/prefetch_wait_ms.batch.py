"""Milliseconds a batch the pipeline thread spent blocked on its worker
pools: the program's ``pipeline.wm_wait`` (a WordMatcher prefetch),
``pipeline.conj_wait`` (a conjunctive-pool prefetch) and
``pipeline.tier_wait`` (the tier jobs) spans on the pipeline thread, over
the batches served."""

from benchmark import program_trace as pt

install = pt.install

NAMES = ("pipeline.wm_wait", "pipeline.conj_wait", "pipeline.tier_wait")


def read(rec):
    return pt.span_ms(rec, NAMES, rec.batches, main_only=True)
