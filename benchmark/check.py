"""The comparison that decides ``correct``.

After the window a run draws from the seed a sample of the queries it
answered and serves them once more through the same entry, with the
pipeline's state read (``Capture``): each query's candidates with their
Stage-1 base scores, whether a WordMatcher list held a document, and its
Stage-1 list. The plain reference (``benchmark/reference/``) works out
Stage 1 again from the texts, and scores every candidate again and ranks
them. Four numbers, each with the limit 0 (the configurations guarantee
exact results):

* ``mismatched``: sampled queries whose answer in the window differs from
  the reference's in any document, place or float32 score, or has none;
* ``stage1_scores``: sampled queries whose Stage-1 list holds a score
  that is not the reference's BM25+ of its title on the route that list
  came from (the card's champions, or every posting);
* ``stage1_top``: sampled queries whose Stage-1 list is not the k best
  titles on that route (queries that may take the tiered route, whose
  candidates are a pool of its own, are held to their scores only);
* ``replay_differs``: sampled queries whose answer on the replay differs
  from the one in the window (the state read would not be the window's).
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional

import numpy as np

from .reference import answers
from .reference.score import f32
from .reference.stage1 import Stage1Index, is_top

LIMITS = {"mismatched": 0, "stage1_scores": 0, "stage1_top": 0,
          "replay_differs": 0}
#: the Stage-1 list's length: the queries' coverage depth
DEPTH = 500


def answer_of(result) -> Optional[list]:
    """A result's ranked (document key, score) records; None for none."""
    if result is None:
        return None
    return [(int(e.document_id), float(e.score)) for e in result.records]


def _entries(stage1, top=None) -> list:
    if hasattr(stage1, "keys") and hasattr(stage1, "scores"):
        return [(int(k), float(s)) for k, s in
                zip(stage1.keys[:top].tolist(), stage1.scores[:top].tolist())]
    return [(int(e.document_id), float(e.score)) for e in stage1[:top]]


class Capture:
    """Reads, on a replay, each query's candidates from the program's
    pipeline: wraps its coverage gate (the Stage-1 list) and the start of
    its coverage run (every job's worklist), keyed by the query's text."""

    def __init__(self, pipeline, top: int):
        self.pipe, self.top = pipeline, top
        self.state: Dict[str, dict] = {}
        gate, begin = pipeline._coverage_gate, pipeline._coverage_run_begin

        def gate_read(text, setup, stage1, *a, **k):
            every = _entries(stage1)
            self.state.setdefault(text, {}).update(
                stage1=every[:top], stage1_all=every)
            return gate(text, setup, stage1, *a, **k)

        def begin_read(jobs, *a, **k):
            for job in jobs:
                if job.get("fast"):
                    ids = job["worklist_ids"].tolist()
                    bases = job["worklist_base"].tolist()
                else:
                    ids = [i for i, _ in job["worklist"]]
                    bases = [b for _, b in job["worklist"]]
                self.state.setdefault(job["search_text"], {}).update(
                    ids=ids, bases=bases, wm=bool(job["wm_count"]))
            return begin(jobs, *a, **k)

        pipeline._coverage_gate = gate_read
        pipeline._coverage_run_begin = begin_read

    def restore(self) -> None:
        for attr in ("_coverage_gate", "_coverage_run_begin"):
            self.pipe.__dict__.pop(attr, None)


def stage1_verdict(index: Stage1Index, text: str, got: list):
    """(whether the scores fit a route, whether the list is the k best
    on such a route; None where the tiered route may have served it)."""
    q = answers.query_text(text)
    docs = np.asarray([d for d, _ in got], np.int64)
    vals = np.asarray([v for _, v in got], np.float32)
    fits = [r for r, s in index.scores(q, docs).items()
            if np.array_equal(s, vals)]
    if not fits:
        return False, False
    if index.tiered(q):
        return True, None
    return True, any(is_top(got, *index.best(q, r, DEPTH), DEPTH)
                     for r in fits)


def judge(corpus, texts: List[str], got: List[Optional[list]],
          replayed: List[Optional[list]], state: Dict[str, dict],
          top: int, rounding: Callable[[float], float] = f32,
          log: Callable[[str], None] = None) -> Dict[str, dict]:
    """The compared numbers of one sample."""
    index = Stage1Index(corpus)
    bad, differs, s1_scores, s1_top = [], [], [], []
    for i, (text, g, r) in enumerate(zip(texts, got, replayed)):
        if r != g:
            differs.append(i)
        st = state.get(answers.query_text(text))
        want = None
        if st is not None and "stage1" in st:
            want = answers.answer(corpus, text, st.get("ids", []),
                                  st.get("bases", []), st.get("wm", False),
                                  st["stage1"], top, rounding)
            scores_ok, top_ok = stage1_verdict(index, text,
                                               st["stage1_all"])
        else:
            scores_ok, top_ok = False, False
        if not scores_ok:
            s1_scores.append(i)
        if top_ok is False:
            s1_top.append(i)
        if g is None or want is None or g != want:
            bad.append(i)
            if log is not None and len(bad) <= 4:
                log(f"[check] {text!r}: program {g}, reference {want}")
    n = len(texts)
    return {name: {"value": len(idx), "limit": LIMITS[name], "of": n}
            for name, idx in (("mismatched", bad),
                              ("stage1_scores", s1_scores),
                              ("stage1_top", s1_top),
                              ("replay_differs", differs))}


def passed(numbers: Dict[str, dict]) -> bool:
    return all(v["value"] <= v["limit"] for v in numbers.values())


def lines(numbers: Dict[str, dict]) -> List[str]:
    return [f"check {k}: {v['value']} (limit {v['limit']})"
            for k, v in numbers.items()]
