"""Seconds of the cell's index build: the sum of the phases the program
reports in ``SearchEngine.get_statistics().build_seconds`` (bulk
indexing, inverted lists, the WordMatcher, the optimized indexes, the
short-query resolver, the cache invalidation), read after set-up."""

from benchmark import program_trace as pt

install = pt.install


def read(rec):
    st = pt.state(rec)
    if st is None or not st.build:
        return None
    return sum(st.build.values())
