"""Word-level recall engine: exact, LD1 (symmetric delete), and affix lookup.

Behavioral reference: Infidex ``WordMatcher/WordMatcher.cs``:

* Exact word -> doc-id set for word lengths [min_exact, max_exact].
* LD1 via symmetric-delete (FastSS): index all 1-char deletions of words in
  [min_ld1, max_ld1]; at query time check query against the exact index,
  query against the deletion index (target has one extra char), query
  deletions against the deletion index (substitution), and query deletions
  against the exact index (insertion in query) (:201-246, :359-375).
* Affix (prefix/suffix) via forward + reverse sorted word tables with a
  4096-terms-per-lookup budget, prefix first (:41, :277-354). The reference
  uses forward/reverse FSTs; sorted arrays + bisect give the same term
  enumeration order (label-sorted) with simpler persistence.

Doc sets are numpy int32 arrays (the roaring-bitmap equivalent in this
design: candidate sets become dense arrays that feed the batched coverage
kernel directly).
"""

from __future__ import annotations

import bisect
from typing import Dict, List, Optional, Sequence, Set, Tuple

import numpy as np

from .. import tracing
from ..core.config import WordMatcherSetup
from ..tokenization.normalizer import TextNormalizer

MAX_FST_AFFIX_TERMS_PER_QUERY = 4096


def _deletions(word: str) -> List[str]:
    return [word[:i] + word[i + 1:] for i in range(len(word))]


class WordMatcher:
    def __init__(self, setup: WordMatcherSetup, delimiters: Sequence[str],
                 text_normalizer: Optional[TextNormalizer] = None):
        self._setup = setup
        self._delims = set(delimiters)
        self._normalizer = text_normalizer

        # Builders (word -> sorted doc id list)
        self._exact: Dict[str, List[int]] = {}
        self._ld1: Dict[str, List[int]] = {}
        self._affix_words: Dict[str, List[int]] = {}

        # Finalized lookup tables
        self._finalized = False
        self._sorted_words: List[str] = []
        self._sorted_rev: List[str] = []
        self._rev_to_word: Dict[str, str] = {}
        # Per-word merged-affix memo (normalized word -> merged doc ids).
        # Query words repeat Zipf-style across a serving stream and the
        # merge concatenates up to 4096 tiny lists (~1ms/word at 1M docs,
        # 21% of host time in scripts/host_hot_profile.py) — invalidated
        # on finalize_index, bounded FIFO.
        self._affix_cache: Dict[str, List[np.ndarray]] = {}
        # Exact+LD1 union memo (see lookup()) — created here, not only in
        # finalize_index, so pre-finalize instances stay consistent.
        self._lookup_cache: Dict[str, Optional[np.ndarray]] = {}

    # ------------------------------------------------------------------
    def _normalize(self, text: str) -> str:
        text = text.lower()
        if self._normalizer is not None:
            text = self._normalizer.normalize(text)
        return text

    def _split(self, text: str) -> List[str]:
        out: List[str] = []
        cur: List[str] = []
        for ch in text:
            if ch in self._delims:
                if cur:
                    out.append("".join(cur))
                    cur = []
            else:
                cur.append(ch)
        if cur:
            out.append("".join(cur))
        return out

    @staticmethod
    def _add(index: Dict[str, List[int]], word: str, doc: int) -> None:
        docs = index.get(word)
        if docs is None:
            index[word] = [doc]
            return
        if isinstance(docs, np.ndarray):
            # bulk-loaded entry (native/bulk.py): make mutable on demand
            docs = docs.tolist()
            index[word] = docs
        if docs[-1] != doc:
            docs.append(doc)

    def load_bulk(self, exact: Dict[str, np.ndarray],
                  ld1: Dict[str, np.ndarray],
                  affix: Dict[str, np.ndarray]) -> None:
        """Install the native bulk builder's maps (values are int32 doc-id
        arrays with the same last-doc dedupe semantics as _add)."""
        self._exact = exact
        self._ld1 = ld1
        self._affix_words = affix
        self._finalized = False

    # ------------------------------------------------------------------
    def load(self, text: str, doc_index: int) -> None:
        """Index one document's words (WordMatcher.Load)."""
        s = self._setup
        for word in self._split(self._normalize(text)):
            length = len(word)
            if s.minimum_word_size_exact <= length <= s.maximum_word_size_exact:
                self._add(self._exact, word, doc_index)
            if (s.support_ld1 and
                    s.minimum_word_size_ld1 <= length <= s.maximum_word_size_ld1):
                for variant in _deletions(word):
                    self._add(self._ld1, variant, doc_index)
            if s.support_affix and length >= s.minimum_word_size_ld1:
                self._add(self._affix_words, word, doc_index)
        self._finalized = False

    def finalize_index(self) -> None:
        if self._setup.support_affix:
            self._sorted_words = sorted(self._affix_words.keys())
            self._rev_to_word = {w[::-1]: w for w in self._affix_words.keys()}
            self._sorted_rev = sorted(self._rev_to_word.keys())
        self._affix_cache = {}
        self._lookup_cache = {}
        self._finalized = True

    # ------------------------------------------------------------------
    def lookup(self, query: str) -> Optional[np.ndarray]:
        """Exact + LD1 doc union for a query word (WordMatcher.Lookup).

        Memoized per normalized word until the next ``finalize_index``:
        serving streams repeat words Zipf-style, and the union (up to
        ~10 dict probes + a unique over 10^5 ids at 1M docs) is ~40% of
        the WordMatcher's per-query cost. Returned arrays are shared —
        callers treat them as read-only, same contract as the affix
        memo."""
        if not self._finalized:
            self.finalize_index()
        normalized = self._normalize(query)
        if normalized in self._lookup_cache:
            return self._lookup_cache[normalized]
        out = self._lookup_uncached(normalized)
        if len(self._lookup_cache) >= 8192:
            self._lookup_cache.clear()
        self._lookup_cache[normalized] = out
        return out

    def _lookup_uncached(self, normalized: str) -> Optional[np.ndarray]:
        length = len(normalized)
        parts: List[np.ndarray] = []

        def take(docs):
            if docs is not None and len(docs):
                parts.append(np.asarray(docs, dtype=np.int32))

        take(self._exact.get(normalized))

        s = self._setup
        if (s.support_ld1 and s.minimum_word_size_ld1 <= length <= s.maximum_word_size_ld1):
            take(self._ld1.get(normalized))
            for deletion in _deletions(normalized):
                take(self._ld1.get(deletion))
                take(self._exact.get(deletion))

        if not parts:
            return None
        return np.unique(np.concatenate(parts)).astype(np.int32)

    def lookup_affix(self, query: str) -> Optional[np.ndarray]:
        """Prefix/suffix doc union with a 4096-term budget (LookupAffix)."""
        parts = self._affix_parts(query)
        if not parts:
            return None
        return np.unique(np.concatenate(parts)).astype(np.int32)

    def _affix_parts(self, query: str) -> List[np.ndarray]:
        """Budgeted affix matches as un-merged sorted doc lists."""
        if not self._finalized:
            self.finalize_index()
        if not self._setup.support_affix or not self._sorted_words:
            return []
        normalized = self._normalize(query)
        cached = self._affix_cache.get(normalized)
        if cached is not None:
            return cached

        matched_words: List[str] = []
        budget = MAX_FST_AFFIX_TERMS_PER_QUERY

        lo = bisect.bisect_left(self._sorted_words, normalized)
        hi = bisect.bisect_right(self._sorted_words, normalized + "￿")
        prefix_count = hi - lo
        rev = normalized[::-1]
        rlo = bisect.bisect_left(self._sorted_rev, rev)
        rhi = bisect.bisect_right(self._sorted_rev, rev + "￿")
        suffix_count = rhi - rlo

        if prefix_count == 0 and suffix_count == 0:
            return self._affix_memo(normalized, [])

        if prefix_count > 0 and budget > 0:
            take = min(prefix_count, budget)
            matched_words.extend(self._sorted_words[lo : lo + take])
            budget -= take
        if suffix_count > 0 and budget > 0:
            take = min(suffix_count, budget)
            for r in self._sorted_rev[rlo : rlo + take]:
                matched_words.append(self._rev_to_word[r])
            budget -= take

        lists = [docs
                 for docs in (self._affix_words.get(w) for w in matched_words)
                 if docs is not None and len(docs)]
        if not lists:
            return self._affix_memo(normalized, [])
        # One merged sorted part instead of up-to-4096 tiny ones: the
        # roaring-union equivalent (ascending unique doc ids) — downstream
        # consumers do per-part work, so part count is the cost driver.
        merged = np.unique(np.concatenate(
            [np.asarray(d, dtype=np.int32) for d in lists]))
        return self._affix_memo(normalized, [merged.astype(np.int32)])

    def _affix_memo(self, word: str,
                    parts: List[np.ndarray]) -> List[np.ndarray]:
        if len(self._affix_cache) >= 8192:
            self._affix_cache.clear()
        self._affix_cache[word] = parts
        return parts

    # ------------------------------------------------------------------
    def fuzzy_prefix_words(self, token: str,
                           budget: int = MAX_FST_AFFIX_TERMS_PER_QUERY
                           ) -> List[str]:
        """Vocabulary words whose len(token)-prefix is within Damerau-1
        of ``token`` — the candidate-side twin of the coverage cascade's
        fuzzy-prefix pass (PrefixSuffixMatcher Damerau<=1 prefix credit),
        which candidate generation previously had no evidence class for:
        at index_sizes=[3] an interior doc word 'Cekachel' shares NO gram
        with query token 'cee' (the '\\uffffce' boundary gram exists only
        doc-initially, Tokenizer.cs whole-text pads), so fusion's top
        docs never became candidates (ROUND5.md §7 mechanism 2).

        Implementation: bounded best-effort walk of the SORTED affix
        word table as an implicit trie (bisect ranges = nodes; no trie
        memory, naturally current across incremental finalizes), with a
        full Damerau-Levenshtein DP row per node and prune at min > 1.
        At depth len(token) every qualifying subtree's words are taken
        in lexicographic order up to ``budget`` — deterministic."""
        if not self._finalized:
            self.finalize_index()
        words = self._sorted_words
        token = self._normalize(token)
        m = len(token)
        if not words or m == 0:
            return []
        out: List[str] = []
        # DFS stack of (lo, hi, prefix, prev_row, row); children pushed
        # in reverse-lex order so pops are lexicographic.
        stack = [(0, len(words), "", None, list(range(m + 1)))]
        while stack and len(out) < budget:
            lo, hi, prefix, prev, row = stack.pop()
            d = len(prefix)
            if d == m:
                if row[m] <= 1:
                    out.extend(words[lo:hi][: budget - len(out)])
                continue
            if min(row) > 1:
                continue
            children = []
            i = lo
            while i < hi:
                w = words[i]
                if len(w) <= d:   # the word equal to the prefix itself
                    i += 1
                    continue
                c = w[d]
                j = bisect.bisect_right(words, prefix + c + "￿", i, hi)
                new = [row[0] + 1]
                for k in range(1, m + 1):
                    cost = 0 if token[k - 1] == c else 1
                    v = min(new[k - 1] + 1, row[k] + 1, row[k - 1] + cost)
                    if (prev is not None and k >= 2
                            and token[k - 1] == prefix[d - 1]
                            and token[k - 2] == c):
                        v = min(v, prev[k - 2] + 1)
                    new.append(v)
                children.append((i, j, prefix + c, row, new))
                i = j
            stack.extend(reversed(children))
        return out

    def fuzzy_prefix_parts(self, token: str,
                           budget: int = MAX_FST_AFFIX_TERMS_PER_QUERY
                           ) -> List[np.ndarray]:
        """Merged sorted doc ids of ``fuzzy_prefix_words`` matches (one
        part, affix-part convention)."""
        matched = self.fuzzy_prefix_words(token, budget)
        lists = [docs for docs in (self._affix_words.get(w)
                                   for w in matched)
                 if docs is not None and len(docs)]
        if not lists:
            return []
        merged = np.unique(np.concatenate(
            [np.asarray(d, dtype=np.int32) for d in lists]))
        return [merged.astype(np.int32)]

    # ------------------------------------------------------------------
    def lookup_query(self, query_text: str, cover_prefix_suffix: bool) -> np.ndarray:
        """Per-word exact+LD1 (+ affix) union over a whole query
        (Scoring/WordMatcherLookup.cs)."""
        # Unions stay vectorized: a common word matches 10^5 docs on large
        # corpora and Python-set accumulation dominated query latency.
        parts = self.lookup_parts(query_text, cover_prefix_suffix)
        if not parts:
            return np.zeros(0, dtype=np.int32)
        return np.unique(np.concatenate(parts)).astype(np.int32)

    def lookup_parts(self, query_text: str,
                     cover_prefix_suffix: bool) -> List[np.ndarray]:
        """The union's constituent SORTED doc-id lists, un-merged.

        Callers that only need membership tests or the union's smallest K
        ids (the search pipeline) work directly on the parts — at 1M docs
        the materialized union reaches 10^7 ids and its sort dominated
        whole-query latency; the parts keep every consumer O(needed).
        """
        return [p for _, g in
                self.lookup_parts_grouped(query_text, cover_prefix_suffix)
                for p in g]

    def lookup_parts_grouped(self, query_text: str,
                             cover_prefix_suffix: bool
                             ) -> List[Tuple[str, List[np.ndarray]]]:
        """``lookup_parts`` grouped per query token: ``(word, parts)``
        with one list of sorted doc-id parts per word. The per-token
        grouping is what the conjunctive candidate tier consumes
        (``index/conjunctive.py``: its per-token strong-evidence
        anchors are exactly these lists)."""
        with tracing.span("word_matcher.lookup"):
            groups: List[Tuple[str, List[np.ndarray]]] = []
            for word in self._split(query_text):
                if len(word) < 2 or word.isspace():
                    continue
                g: List[np.ndarray] = []
                ids = self.lookup(word)
                if ids is not None and len(ids):
                    g.append(np.asarray(ids))
                if cover_prefix_suffix:
                    g.extend(self._affix_parts(word))
                groups.append((word, g))
            return groups

    # ------------------------------------------------------------------
    # Persistence (engine-level save/load serializes these tables)

    def state_dict(self) -> dict:
        return {
            "exact": self._exact,
            "ld1": self._ld1,
            "affix": self._affix_words,
            "setup": self._setup,
        }

    def load_state_dict(self, state: dict) -> None:
        self._exact = state["exact"]
        self._ld1 = state["ld1"]
        self._affix_words = state["affix"]
        self._finalized = False
        self.finalize_index()

    def clear(self) -> None:
        self._exact.clear()
        self._ld1.clear()
        self._affix_words.clear()
        self._sorted_words = []
        self._sorted_rev = []
        self._rev_to_word = {}
        self._affix_cache = {}
        self._lookup_cache = {}
        self._finalized = False
