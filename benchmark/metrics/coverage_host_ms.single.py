"""Milliseconds a search spent scoring coverage on the host oracle: the
program's ``pipeline.host_oracle`` spans (phase 3 of
``SearchPipeline._coverage_run_begin``: whole jobs under their device
threshold, and the candidates whose documents overflow the device
tables), over the searches of the window."""

from benchmark import program_trace as pt

install = pt.install


def read(rec):
    return pt.span_ms(rec, ["pipeline.host_oracle"], rec.searches)
