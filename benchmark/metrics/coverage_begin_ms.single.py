"""Milliseconds a search spent assembling coverage candidates: the
program's ``pipeline.coverage_begin`` spans (``SearchPipeline.
_coverage_begin``, the entries route ``search`` takes), over the
searches of the window."""

from benchmark import program_trace as pt

install = pt.install


def read(rec):
    return pt.span_ms(rec, ["pipeline.coverage_begin"], rec.searches)
