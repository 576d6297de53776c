"""A query's ranked top records, from its candidates and the texts.

The upstream ranking (``SearchPipeline.cs``, ``TopKHeap``,
``ResultProcessor.CalculateTruncationIndex``): every candidate scored;
ordered by score, then tiebreaker (both descending), then document key;
the first ``depth``; each document once, at its best place; cut after
the last record whose word hits equal the most any candidate reached,
or whose LCS is positive, or whose score is 254 or more; the first
``top``. Where no candidate has a word hit and no WordMatcher list held
a document, the answer is the query's Stage-1 list.
"""

from __future__ import annotations

from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np

from . import score as S
from .stats import DELIMITERS, Corpus, normalize, words

Answer = List[Tuple[int, float]]
DEPTH = 500
TRUNCATION_SCORE = 254


def query_text(raw: str) -> str:
    return normalize(raw.strip())


def answer(corpus: Corpus, raw: str, ids: Sequence[int],
           bases: Sequence[float], wm_lists: bool,
           stage1: Optional[Answer], top: int = 10,
           rounding: Callable[[float], float] = S.f32) -> Answer:
    """The ranked (key, score) records. ``ids``, ``bases``: the
    candidates and their Stage-1 base scores; ``wm_lists``: whether a
    WordMatcher list held a document; ``stage1``: the Stage-1 list."""
    q = query_text(raw)
    q_cov = S.distinct(S.slices(q, S.MIN_WORD, DELIMITERS))
    q_all = S.slices(q, 0, DELIMITERS)
    t_idf = [corpus.term_idf(t.text) for t in q_cov]
    w_idf = [corpus.word_idf.get(t.text, 0.0) for t in q_cov]
    n = len(ids)
    sc = np.zeros(n, np.float32)
    tie = np.zeros(n, np.int64)
    hits = np.zeros(n, np.int64)
    lcs = np.zeros(n, np.int64)
    for i, (doc_id, base) in enumerate(zip(ids, bases)):
        doc = corpus.texts[int(doc_id)]
        dw = words(doc)
        sc[i], tie[i], hits[i], lcs[i] = S.score(
            q, doc, q_cov, q_all, t_idf, w_idf, dw[0] if dw else "",
            len(dw), float(base), DELIMITERS, rounding)
    most = int(hits.max()) if n else 0
    if n == 0 or (most == 0 and not wm_lists):
        return list(stage1 or [])[:top]
    keys = np.asarray(ids, np.int64)
    order = np.lexsort((keys, -tie, -sc))[:DEPTH]
    _, first = np.unique(keys[order], return_index=True)
    sel = order[np.sort(first)]
    keep = (hits[sel] >= max(1, most)) | (lcs[sel] > 0) | \
        (sc[sel] >= TRUNCATION_SCORE)
    count = top if not keep.any() else \
        min(int(np.flatnonzero(keep)[-1]) + 1, top)
    return [(int(keys[i]), float(sc[i])) for i in sel[:count]]
