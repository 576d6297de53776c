"""Pipeline sub-batches a batch of 128 queries: the program's counter
``engine.pipeline_batches`` (one a sub-batch ``search_many`` hands the
pipeline, one a group ``search_batch`` runs), over the batches served.
Queries of one pipeline group share its Stage-1 dispatch and its mask;
a call whose queries all group together reads 1. None where the program
has no such counter."""

from benchmark import program_trace as pt

install = pt.install

NAME = "engine.pipeline_batches"


def read(rec):
    st = pt.state(rec)
    if st is None or st.snap is None or NAME not in st.snap.counters \
            or not rec.batches:
        return None
    return st.snap.counters[NAME] / rec.batches
