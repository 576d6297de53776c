"""The comparison that decides ``correct``.

After the window a run draws from the seed some of the calls the window
made and a sample of their queries (``draw_sample``), and serves those
calls once more, whole, through the same entry, with the pipeline's
state read (``Capture``, ``replay_calls``): each query's candidates with
their Stage-1 base scores, whether a WordMatcher list held a document,
and its Stage-1 list. A call is served again whole because a query's
candidates may depend on the other queries of its batch: the Stage-1
route of a batch's stragglers is chosen by their number and their
postings. The calls' states are merged into rounds that read one state
a text (``rounds``), each round is judged by the deployment's reference,
and the rounds' numbers add up (``total``). The titles reference
(``benchmark/reference/``) works out Stage 1 again from the texts, and
scores every candidate again and ranks them (``judge``). Four numbers,
each with the limit 0 (the configurations guarantee exact results):

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

import unicodedata
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from .reference import answers
from .reference.score import f32
from .reference.stage1 import Stage1Index, is_top

LIMITS = {"mismatched": 0, "stage1_scores": 0, "stage1_top": 0,
          "replay_differs": 0}
#: the Stage-1 list's length: the queries' coverage depth
DEPTH = 500
#: the fewest calls of the window a run serves again, so that its sample
#: spreads over the window
MIN_CALLS = 4


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


def _loose(text: str) -> str:
    """A text as loosely as the engine could read it: marks dropped,
    case folded, spaces collapsed."""
    text = unicodedata.normalize("NFKD", text)
    text = "".join(c for c in text if not unicodedata.combining(c))
    return " ".join(text.casefold().split())


def draw_sample(rng, specs: Sequence, calls: Sequence[Tuple[int, int]],
                n: int) -> Tuple[List[int], List[int]]:
    """The window's calls to serve again and the sample judged in them:
    calls (``(first, end)`` ranges of ``specs``) drawn in random order
    until there are ``MIN_CALLS`` or more holding ``n`` or more queries
    that can be judged, then ``n`` of those. A query cannot be judged
    where another query of its call has its text with other options
    (the pipeline keys what ``Capture`` reads by text). Returns the drawn
    calls' positions in ``calls`` and the sampled indices of ``specs``,
    both in window order."""
    order = list(range(len(calls)))
    rng.shuffle(order)
    drawn: List[int] = []
    pool: List[int] = []
    for c in order:
        if len(drawn) >= MIN_CALLS and len(pool) >= n:
            break
        drawn.append(c)
        lo, hi = calls[c]
        options: Dict[str, set] = {}
        for i in range(lo, hi):
            options.setdefault(_loose(specs[i].text), set()).add(
                specs[i].options)
        pool += [i for i in range(lo, hi)
                 if len(options[_loose(specs[i].text)]) == 1]
    return sorted(drawn), sorted(rng.sample(pool, min(n, len(pool))))


def replay_calls(replay: Callable, pipeline, specs: Sequence,
                 calls: Sequence[Tuple[int, int]], top: int
                 ) -> List[Tuple[list, Dict[str, dict]]]:
    """Each call served again whole through ``replay``, as the window
    served it (a query's candidates may depend on the batch it is in),
    with the pipeline's state read: (answers, state keyed by text) a
    call."""
    out = []
    for lo, hi in calls:
        cap = Capture(pipeline, top)
        try:
            got = [answer_of(r) for r in replay(list(specs[lo:hi]))]
        finally:
            cap.restore()
        out.append((got, cap.state))
    return out


def rounds(states: Sequence[Dict[str, dict]]
           ) -> List[Tuple[List[int], Dict[str, dict]]]:
    """The calls' states merged into as few rounds as keep one state a
    text: a call joins the first round in which none of its texts read
    otherwise. Returns (call positions, merged state) a round."""
    out: List[Tuple[List[int], Dict[str, dict]]] = []
    for p, st in enumerate(states):
        for members, merged in out:
            if all(merged.get(k, v) == v for k, v in st.items()):
                members.append(p)
                merged.update(st)
                break
        else:
            out.append(([p], dict(st)))
    return out


def total(parts: List[Dict[str, dict]]) -> Dict[str, dict]:
    """The numbers of several rounds added up, name by name."""
    out: Dict[str, dict] = {}
    for numbers in parts:
        for name, v in numbers.items():
            have = out.setdefault(name, {"value": 0, "limit": v["limit"],
                                         "of": 0})
            if have["limit"] != v["limit"]:
                raise ValueError(f"check {name}: limits {have['limit']} "
                                 f"and {v['limit']} in one run")
            have["value"] += v["value"]
            have["of"] += v["of"]
    return out


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
