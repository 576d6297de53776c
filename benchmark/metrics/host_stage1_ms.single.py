"""Milliseconds of the host Stage-1 route in a search that took it: the
program's ``vector_model.stage1_host`` spans (``VectorModel.search``
scoring on the host, ``index/mmap_serving.py``), summed, over the
searches (request ids) that had one."""

from benchmark import program_trace as pt

install = pt.install


def read(rec):
    sel = pt.spans(rec, ["vector_model.stage1_host"])
    return pt.span_ms(rec, ["vector_model.stage1_host"],
                      len({s.request_id for s in sel}))
