"""First-token index: which docs START with a given word.

Candidate-selection prior for single-word queries. The fusion scorer's
top precedence classes for single-term queries are position-gated
(FusionScorer.cs single-term tiers: exact-at-start > clean-prefix-at-
start > exact-anywhere; fusion.py:_single_term_tier), and within a class
ties resolve by ascending document key — so the docs a deep coverage
pass would surface are, overwhelmingly, the lowest-key docs whose FIRST
token exactly/prefix/fuzzily matches the query word. Surfacing those
into the coverage_depth budget (instead of arbitrary doc-id heads of the
WordMatcher union) is what closes the depth-500 recall gap at corpus
scale; see scripts/recall_study.py.

Fuzzy matching mirrors WordMatcher's symmetric-delete semantics
(WordMatcher.cs:201-246 FastSS): unverified deletion-variant collisions,
which — via deletion-vs-deletion hits — also catch transpositions and
substitutions that plain LD1 verification would reject.
"""

from __future__ import annotations

from bisect import bisect_left, bisect_right
from typing import Dict, List, Optional

import numpy as np

MAX_PREFIX_WORDS = 4096          # same affix budget as WordMatcher
FUZZY_MIN_LEN = 4                # fuzzy class only for real words


def _deletions(word: str) -> List[str]:
    return [word[:i] + word[i + 1:] for i in range(len(word))]


class FirstTokenIndex:
    def __init__(self, word_to_docs: Dict[str, np.ndarray]):
        self._docs = word_to_docs
        self._sorted_words = sorted(word_to_docs.keys())
        # symmetric-delete table over the first-word vocabulary
        self._sd: Dict[str, List[str]] = {}
        for w in self._sorted_words:
            if len(w) < FUZZY_MIN_LEN - 1:
                continue
            for v in _deletions(w):
                self._sd.setdefault(v, []).append(w)
        # class_prior memo: query words repeat (Zipf) and the index is
        # immutable between rebuilds, so the per-word class assembly —
        # the hottest main-thread piece of gate+begin at 1M docs — is
        # computed once per (word, budget).
        self._prior_cache: Dict[tuple, np.ndarray] = {}

    # ------------------------------------------------------------------
    @staticmethod
    def build(norm_texts, delimiters) -> "FirstTokenIndex":
        """One pass over the normalized doc texts; doc id = array index."""
        delims = set(delimiters)
        table: Dict[str, list] = {}
        for i, text in enumerate(norm_texts):
            if not text:
                continue
            # first token = chars up to the first delimiter (skip leading)
            start = 0
            n = len(text)
            while start < n and text[start] in delims:
                start += 1
            end = start
            while end < n and text[end] not in delims:
                end += 1
            if end > start:
                table.setdefault(text[start:end], []).append(i)
        return FirstTokenIndex(
            {w: np.asarray(d, np.int64) for w, d in table.items()})

    # ------------------------------------------------------------------
    def append_docs(self, norm_texts, delimiters, start_id: int) -> None:
        """Extend with appended docs (ids ``start_id..``): per-word doc
        arrays stay ascending because appended ids exceed every existing
        id; new first-words enter the sorted vocabulary and the
        symmetric-delete table. Equivalent to a full rebuild over the
        extended corpus (pinned by tests/test_append_finalize.py)."""
        from bisect import insort

        delims = set(delimiters)
        added: Dict[str, list] = {}
        for j, text in enumerate(norm_texts):
            if not text:
                continue
            start = 0
            n = len(text)
            while start < n and text[start] in delims:
                start += 1
            end = start
            while end < n and text[end] not in delims:
                end += 1
            if end > start:
                added.setdefault(text[start:end], []).append(start_id + j)
        for w, ids in added.items():
            old = self._docs.get(w)
            if old is None:
                self._docs[w] = np.asarray(ids, np.int64)
                insort(self._sorted_words, w)
                if len(w) >= FUZZY_MIN_LEN - 1:
                    for v in _deletions(w):
                        lst = self._sd.setdefault(v, [])
                        insort(lst, w)
            else:
                self._docs[w] = np.concatenate(
                    [old, np.asarray(ids, np.int64)])
        self._prior_cache.clear()

    def docs_exact(self, word: str) -> np.ndarray:
        d = self._docs.get(word)
        return d if d is not None else np.zeros(0, np.int64)

    def docs_prefix(self, word: str, need: Optional[int] = None
                    ) -> np.ndarray:
        """Docs whose first token has ``word`` as a proper prefix
        (exact hits excluded), ascending ids; word budget as WM affix.

        ``need``: only the lowest ``need`` union members are required.
        Per-word doc arrays are ascending (build appends in doc order),
        so the union's lowest ``need`` distinct values always lie within
        each array's first ``need`` elements — clipping before the
        sort-union bounds the cost by the budget instead of the df."""
        lo = bisect_left(self._sorted_words, word)
        hi = bisect_right(self._sorted_words, word + "￿")
        words = [w for w in self._sorted_words[lo:hi][:MAX_PREFIX_WORDS]
                 if w != word]
        if not words:
            return np.zeros(0, np.int64)
        arrs = [self._docs[w] for w in words]
        if need is not None:
            arrs = [a[:need] for a in arrs]
        out = np.unique(np.concatenate(arrs))
        return out if need is None else out[:need]

    def docs_fuzzy(self, word: str, need: Optional[int] = None
                   ) -> np.ndarray:
        """Docs whose first token collides with ``word`` in the
        symmetric-delete space (exact hits excluded). ``need`` as in
        ``docs_prefix``."""
        if len(word) < FUZZY_MIN_LEN:
            return np.zeros(0, np.int64)
        cands: Dict[str, None] = {}
        for v in [word] + _deletions(word):
            for w in self._sd.get(v, ()):
                if w != word:
                    cands[w] = None
            d = self._docs.get(v)
            if d is not None and v != word:
                cands[v] = None
        if not cands:
            return np.zeros(0, np.int64)
        arrs = [self._docs[w] for w in cands]
        if need is not None:
            arrs = [a[:need] for a in arrs]
        out = np.unique(np.concatenate(arrs))
        return out if need is None else out[:need]

    def class_prior(self, word: str, budget: int) -> np.ndarray:
        """Class-major candidate order for one query word: exact-start,
        then prefix-start, then fuzzy-start — each ascending ids, deduped,
        clipped to ``budget``. Memoized per (word, budget)."""
        key = (word, budget)
        hit = self._prior_cache.get(key)
        if hit is not None:
            return hit
        out: List[np.ndarray] = []
        seen: Optional[np.ndarray] = None
        total = 0
        for make in (lambda n: self.docs_exact(word)[:n],
                     lambda n: self.docs_prefix(word, n),
                     lambda n: self.docs_fuzzy(word, n)):
            if total >= budget:
                continue
            # The class is clipped to its lowest ``need`` members BEFORE
            # the seen-dedup: up to seen.size could be removed, so ask
            # for that many extra to keep the result identical to the
            # unclipped computation.
            need = budget - total + (int(seen.size) if seen is not None
                                     else 0)
            cls = make(need)
            if cls.size == 0:
                continue
            if seen is not None and seen.size:
                cls = cls[~np.isin(cls, seen)]
            if cls.size == 0:
                continue
            cls = cls[: budget - total]
            out.append(cls)
            total += int(cls.size)
            seen = cls if seen is None else np.concatenate([seen, cls])
        res = (np.concatenate(out) if out else np.zeros(0, np.int64))
        if len(self._prior_cache) >= 8192:
            self._prior_cache.clear()
        self._prior_cache[key] = res
        return res
