"""Percent of the window's conjunctive-pool lookups that the pool memo
answered: the program's counters ``conj_memo.hit / (conj_memo.hit +
conj_memo.miss)`` (``index/conjunctive.py`` ``conjunctive_pool``)."""

from benchmark import program_trace as pt

install = pt.install


def read(rec):
    hit = pt.counter(rec, "conj_memo.hit")
    miss = pt.counter(rec, "conj_memo.miss")
    if hit is None or not hit + miss:
        return None
    return 100.0 * hit / (hit + miss)
