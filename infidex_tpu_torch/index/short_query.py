"""Positional prefix index + champion lists for O(1) short-query autocomplete.

Behavioral reference: Infidex ``Indexing/ShortQuery/PositionalPrefixIndex.cs``
(1-3 char token-start prefixes -> positional postings (doc_id, token_pos,
is_word_start=True)) and ``ShortQueryResolver.cs`` (precomputed top-64
champion lists per prefix; packed ushort score: precedence byte << 8 | base
byte — word-start=128, first-word-start=64, exact-token=32, first-token-
exact=16, title==q=8, <=3-token title adds 32; base = position decay +
word-start density, or occurrence density).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np

from ..core.documents import DocumentCollection
from .vector_model import ScoreEntry

CHAMPION_LIST_SIZE = 64
MAX_PREFIX_LENGTH = 3


class PositionalPrefixIndex:
    def __init__(self, min_prefix_length: int = 1, max_prefix_length: int = 3,
                 delimiters=(" ",)):
        self.min_prefix_length = max(1, min_prefix_length)
        self.max_prefix_length = min(MAX_PREFIX_LENGTH, max_prefix_length)
        self._delims = set(delimiters)
        # prefix -> (doc_id, token_pos) rows: int32 [n,2] ndarray once
        # frozen (bulk-loaded or merged), or a legacy list of tuples.
        self._index: Dict[str, List[Tuple[int, int]]] = {}
        # Streamed appends accumulate here and merge into ``_index`` at
        # freeze(). The former design converted a bulk ndarray back into
        # a Python list of tuples on the FIRST append to its prefix —
        # one streamed doc containing an 's'-word re-materialized (and
        # re-sorted, every finalize) a million-entry list, the dominant
        # cost of config-5's 46s re-finalize at 1M docs.
        self._pending: Dict[str, List[Tuple[int, int]]] = {}
        # prefix -> rows appended by the most recent freeze() — the
        # incremental champion-list update (ShortQueryResolver
        # .append_docs) consumes this instead of rescanning full lists.
        self.last_appended: Dict[str, np.ndarray] = {}
        # distinct-doc counts per prefix (coverage gate, every short
        # query) — cleared whenever postings change
        self._count_cache: Dict[str, int] = {}
        self._frozen = False

    def index_document(self, text: str, document_id: int) -> None:
        if not text:
            return
        i, n = 0, len(text)
        token_index = 0
        while i < n:
            while i < n and text[i] in self._delims:
                i += 1
            start = i
            while i < n and text[i] not in self._delims:
                i += 1
            length = i - start
            if length > 0:
                max_len = min(length, self.max_prefix_length)
                for plen in range(self.min_prefix_length, max_len + 1):
                    prefix = text[start : start + plen]
                    lst = self._pending.get(prefix)
                    if lst is None:
                        self._pending[prefix] = [(document_id, token_index)]
                    else:
                        lst.append((document_id, token_index))
                token_index += 1
        self._frozen = False
        if self._count_cache:
            self._count_cache.clear()

    def load_bulk(self, index) -> None:
        """Install the native bulk builder's prefix map (values are
        (doc, token_pos) int32 arrays already in sorted order)."""
        self._index = index
        self._pending = {}
        self.last_appended = {}
        self._count_cache = {}
        self._frozen = True

    @staticmethod
    def _rows_sorted(rows: np.ndarray) -> bool:
        """(doc, pos)-lexicographic sortedness check, vectorized."""
        if rows.shape[0] <= 1:
            return True
        d, p = rows[:, 0], rows[:, 1]
        dd = np.diff(d)
        return bool(np.all((dd > 0) | ((dd == 0) & (np.diff(p) > 0))))

    def freeze(self) -> None:
        appended: Dict[str, np.ndarray] = {}
        for prefix, pend in self._pending.items():
            rows = np.asarray(pend, np.int32).reshape(-1, 2)
            if not self._rows_sorted(rows):
                rows = rows[np.lexsort((rows[:, 1], rows[:, 0]))]
            base = self._index.get(prefix)
            if base is None or len(base) == 0:
                merged = rows
            else:
                if isinstance(base, list):
                    base.sort()
                    base = np.asarray(base, np.int32).reshape(-1, 2)
                merged = np.concatenate([base, rows])
                if not tuple(base[-1]) < tuple(rows[0]):
                    merged = merged[np.lexsort((merged[:, 1],
                                                merged[:, 0]))]
            self._index[prefix] = merged
            appended[prefix] = rows
        self._pending = {}
        # legacy per-doc-built lists (no bulk load): sort once as before
        for prefix, postings in self._index.items():
            if isinstance(postings, list):
                postings.sort()
        self.last_appended = appended
        self._count_cache = {}
        self._frozen = True

    def get_posting_list(self, prefix: str, frozen_only: bool = False
                         ) -> Optional[List[Tuple[int, int]]]:
        """``frozen_only=True`` serves the last-frozen state (champion
        caching reads this so an incremental champion merge never
        double-counts rows that a lazy mid-stream build already saw)."""
        if not prefix or len(prefix) > self.max_prefix_length:
            return None
        base = self._index.get(prefix)
        pend = None if frozen_only else self._pending.get(prefix)
        if not pend:
            return base
        rows = np.asarray(pend, np.int32).reshape(-1, 2)
        if base is None or len(base) == 0:
            return rows
        if isinstance(base, list):
            base = np.asarray(base, np.int32).reshape(-1, 2)
        return np.concatenate([base, rows])

    def has_prefix(self, prefix: str) -> bool:
        lst = self.get_posting_list(prefix)
        return lst is not None and len(lst) > 0

    def count_documents(self, prefix: str) -> int:
        cached = self._count_cache.get(prefix)
        if cached is not None:
            return cached
        lst = self.get_posting_list(prefix)
        if lst is None or len(lst) == 0:
            n = 0
        elif isinstance(lst, np.ndarray):
            n = int(np.unique(lst[:, 0]).size)
        else:
            n = len({int(r[0]) for r in lst})
        if len(self._count_cache) >= 4096:
            self._count_cache.clear()
        self._count_cache[prefix] = n
        return n

    def get_document_ids(self, prefix: str) -> set:
        lst = self.get_posting_list(prefix)
        if lst is None or len(lst) == 0:
            return set()
        if isinstance(lst, np.ndarray):
            return set(np.unique(lst[:, 0]).tolist())
        return {int(r[0]) for r in lst}

    def all_prefixes(self):
        return self._index.items()

    def state_dict(self) -> dict:
        if self._pending:
            self.freeze()
        return {"index": self._index,
                "min": self.min_prefix_length, "max": self.max_prefix_length}

    def load_state_dict(self, state: dict) -> None:
        self._index = state["index"]
        self.min_prefix_length = state["min"]
        self.max_prefix_length = state["max"]
        self.freeze()

    def clear(self) -> None:
        self._index.clear()
        self._pending.clear()
        self.last_appended = {}
        self._count_cache = {}


class _DocScore:
    __slots__ = ("document_key", "occurrences", "word_start_count",
                 "has_word_start", "first_word_start_position")

    def __init__(self, document_key: int):
        self.document_key = document_key
        self.occurrences = 0
        self.word_start_count = 0
        self.has_word_start = False
        self.first_word_start_position = 2**31


class ShortQueryResolver:
    def __init__(self, prefix_index: PositionalPrefixIndex,
                 documents: DocumentCollection, delimiters=(" ",)):
        self._prefix_index = prefix_index
        self._documents = documents
        self._delims = set(delimiters)
        # Champion lists build lazily per prefix on first use: the
        # reference builds them eagerly in parallel at finalize
        # (ShortQueryResolver.cs:113-120); computing only touched prefixes
        # gives the same answers and keeps indexing latency flat.
        self._champion_lists: Dict[str, List[ScoreEntry]] = {}
        self._champion_built: set = set()
        # Persistent doc tables (built once, extended on append-only
        # finalizes): champion builds AND the vectorized short-query
        # processor (scoring/short_query.search_short_query_fast) read
        # them.
        self._tables: Optional[dict] = None

    def _split(self, text: str) -> List[str]:
        out, cur = [], []
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

    def _score_postings(self, postings) -> Dict[int, _DocScore]:
        doc_scores: Dict[int, _DocScore] = {}
        for doc_id, pos in postings:
            score = doc_scores.get(doc_id)
            if score is None:
                doc = self._documents.get_document(doc_id)
                if doc is None or doc.deleted:
                    continue
                score = _DocScore(doc.document_key)
                doc_scores[doc_id] = score
            score.occurrences += 1
            score.word_start_count += 1  # all postings are word starts
            if not score.has_word_start or pos < score.first_word_start_position:
                score.has_word_start = True
                score.first_word_start_position = pos
        return doc_scores

    def _calculate_final_score(self, query: str, doc, score: _DocScore) -> int:
        precedence = 0
        if score.has_word_start:
            precedence |= 128
            if score.first_word_start_position == 0:
                precedence |= 64
        title_lower = (doc.indexed_text or "").lower()
        tokens = self._split(title_lower)
        any_exact = False
        first_exact = False
        for i, t in enumerate(tokens):
            if t == query:
                any_exact = True
                if i == 0:
                    first_exact = True
                break
        if any_exact:
            precedence |= 32
        if first_exact:
            precedence |= 16
        if title_lower.strip() == query:
            precedence |= 8
        if len(tokens) <= 3:
            precedence |= 32

        if score.has_word_start:
            pos_component = 255 - min(score.first_word_start_position * 16, 240)
            density = min(score.word_start_count * 8, 32)
            base = max(0, min(pos_component + density, 255))
        else:
            base = max(1, min(score.occurrences * 4, 200))
        return (precedence << 8) | base

    def _resolve_postings(self, query: str, postings) -> List[ScoreEntry]:
        doc_scores = self._score_postings(postings)
        entries: List[ScoreEntry] = []
        for doc_id, score in doc_scores.items():
            doc = self._documents.get_document(doc_id)
            if doc is None or doc.deleted:
                continue
            final = self._calculate_final_score(query, doc, score)
            entries.append(ScoreEntry(float(final), score.document_key))
        entries.sort(key=lambda e: -e.score)
        return entries

    def _champions_for(self, prefix: str) -> Optional[List[ScoreEntry]]:
        """Champion list for one prefix, built and cached on first access.

        Reads the last-FROZEN postings (reference semantics: champion
        lists are a finalize-time artifact, ShortQueryResolver.cs:113) —
        also what keeps the incremental ``append_docs`` merge exact."""
        if prefix in self._champion_built:
            return self._champion_lists.get(prefix)
        self._champion_built.add(prefix)
        postings = self._prefix_index.get_posting_list(prefix,
                                                       frozen_only=True)
        if postings is None or len(postings) == 0:
            return None
        entries = self._resolve_postings(prefix, postings)
        if entries:
            self._champion_lists[prefix] = entries[:CHAMPION_LIST_SIZE]
            return self._champion_lists[prefix]
        return None

    def resolve(self, query: str, max_results: int = 2**31) -> List[ScoreEntry]:
        if not query or len(query) > self._prefix_index.max_prefix_length:
            return []
        ok, champions = self.try_get_champions(query, max_results)
        if ok:
            return champions
        postings = self._prefix_index.get_posting_list(query)
        if postings is None or len(postings) == 0:
            return []
        entries = self._resolve_postings(query, postings)
        return entries[:max_results]

    def try_get_champions(self, prefix: str, max_results: int) -> Tuple[bool, List[ScoreEntry]]:
        if max_results <= 0 or not prefix or \
                len(prefix) > self._prefix_index.max_prefix_length:
            return False, []
        champions = self._champions_for(prefix)
        if not champions or len(champions) < max_results:
            return False, []
        return True, champions[:max_results]

    # ------------------------------------------------------------------
    # Eager (vectorized) champion builds — ShortQueryResolver.cs:113-204
    # precomputes top-64 lists for ALL prefixes in parallel at freeze; the
    # lazy scalar path above stays as the semantic oracle (parity pinned
    # by tests/test_short_query_champions.py).

    def ensure_tables(self) -> dict:
        """The persistent doc tables, built on first use."""
        if self._tables is None:
            self._tables = self._build_doc_tables()
        return self._tables

    def build_all_champions(self) -> int:
        """Build champion lists for every indexed prefix in one vectorized
        pass; returns the number of prefixes built. Safe to call while
        readers run: results publish per-prefix into the same dicts the
        lazy path uses (identical entries)."""
        tables = self.ensure_tables()
        built_lists: Dict[str, List[ScoreEntry]] = {}
        for prefix, postings in self._prefix_index.all_prefixes():
            if prefix in self._champion_built or len(postings) == 0:
                continue
            entries = self._champions_vec(prefix, postings, tables)
            if entries:
                built_lists[prefix] = entries
        # publish (dict.update is atomic under the GIL; champions must be
        # registered before the built-markers so a concurrent reader never
        # sees "built" without the list)
        self._champion_lists.update(built_lists)
        self._champion_built.update(built_lists.keys())
        return len(built_lists)

    def append_docs(self, appended: Dict[str, np.ndarray],
                    start: int, k: int) -> None:
        """Incremental champion update after an append-only finalize:
        merge the freshly-frozen rows (PositionalPrefixIndex
        .last_appended) into existing champion lists. Exact because
        appends can only ADD entries — any true top-64 member of the
        merged postings is either in the old top-64 or among the new
        docs — and the stable re-sort (old entries first) reproduces
        the full rebuild's ascending-doc tie order. O(touched prefixes
        x delta) instead of an O(corpus) doc-table pass + per-prefix
        rescans."""
        if k <= 0:
            return
        tables = self._build_doc_tables(start=start)
        for prefix, rows in (appended or {}).items():
            if prefix not in self._champion_built:
                continue  # lazy prefixes rebuild from frozen base on use
            old = self._champion_lists.get(prefix) or []
            delta_entries = self._champions_vec(prefix, rows, tables)
            if not delta_entries:
                continue
            merged = sorted(old + delta_entries,
                            key=lambda e: -e.score)[:CHAMPION_LIST_SIZE]
            self._champion_lists[prefix] = merged
        # extend the persistent tables with the delta rows/map entries
        # (delta ids exceed every existing id, so per-token id lists stay
        # ascending under concatenation)
        old_t = self._tables
        if old_t is not None:
            for key in ("short_title", "deleted", "doc_keys",
                        "text_prefix"):
                n_old = old_t[key].shape[0]
                tables[key][:n_old] = old_t[key]
            for mk in ("any_map", "first_map", "title_map"):
                merged_m = dict(old_t[mk])
                for t, arr in tables[mk].items():
                    prev = merged_m.get(t)
                    merged_m[t] = (np.concatenate([prev, arr])
                                   if prev is not None else arr)
                tables[mk] = merged_m
            self._tables = tables

    def _build_doc_tables(self, start: int = 0) -> dict:
        """One pass over the corpus: per-doc exact-token/first-token/title
        equality sets for <=3-char strings + short-title flags, the
        text-dependent precedence inputs of _calculate_final_score.
        ``start``: only docs >= start are scanned (delta tables for the
        incremental champion merge; earlier rows stay zero/deleted and
        are never indexed by delta postings)."""
        docs = self._documents
        n = docs.total_slots()
        short_title = np.zeros(n, bool)
        deleted = np.ones(n, bool)
        doc_keys = np.zeros(n, np.int64)
        # first max_p lowered title chars, 21 bits each (code point + 1;
        # 0 = past end) packed big-end-first: text.startswith(q) for
        # len(q) <= max_p becomes one vectorized shift-compare
        text_prefix = np.zeros(n, np.int64)
        any_map: Dict[str, List[int]] = {}
        first_map: Dict[str, List[int]] = {}
        title_map: Dict[str, List[int]] = {}
        max_p = self._prefix_index.max_prefix_length
        for i in range(start, n):
            doc = docs.get_document(i)
            if doc is None:
                continue
            deleted[i] = doc.deleted
            doc_keys[i] = doc.document_key
            if doc.deleted:
                continue
            title = (doc.indexed_text or "").lower()
            pack = 0
            for ch in title[:max_p]:
                pack = (pack << 21) | (ord(ch) + 1)
            pack <<= 21 * max(0, max_p - len(title))
            text_prefix[i] = pack
            tokens = self._split(title)
            if len(tokens) <= 3:
                short_title[i] = True
            if tokens and len(tokens[0]) <= max_p:
                first_map.setdefault(tokens[0], []).append(i)
            for t in set(tokens):
                if len(t) <= max_p:
                    any_map.setdefault(t, []).append(i)
            s = title.strip()
            if s and len(s) <= max_p:
                title_map.setdefault(s, []).append(i)
        to_arr = lambda m: {k: np.asarray(v, np.int64) for k, v in m.items()}
        return dict(short_title=short_title, deleted=deleted,
                    doc_keys=doc_keys, text_prefix=text_prefix,
                    any_map=to_arr(any_map),
                    first_map=to_arr(first_map), title_map=to_arr(title_map))

    def _champions_vec(self, prefix: str, postings,
                       tables: dict) -> List[ScoreEntry]:
        """Vectorized _resolve_postings for one prefix; identical entries
        (score, key, tie order) to the scalar path."""
        arr = np.asarray(postings, np.int64)
        if arr.ndim != 2:
            arr = arr.reshape(-1, 2)
        doc_col = arr[:, 0]
        pos_col = arr[:, 1]
        # freeze() sorts postings by (doc, pos): unique's first index is
        # each doc's minimum position, matching the scalar accumulation.
        docs_u, first_idx, counts = np.unique(
            doc_col, return_index=True, return_counts=True)
        n = tables["deleted"].size
        ok = (docs_u >= 0) & (docs_u < n)
        docs_u, first_idx, counts = docs_u[ok], first_idx[ok], counts[ok]
        live = ~tables["deleted"][docs_u]
        docs_u, first_idx, counts = (docs_u[live], first_idx[live],
                                     counts[live])
        if docs_u.size == 0:
            return []
        first_pos = pos_col[first_idx]

        base = np.clip(255 - np.minimum(first_pos * 16, 240)
                       + np.minimum(counts * 8, 32), 0, 255)
        prec = np.full(docs_u.size, 128, np.int64)
        prec |= np.where(first_pos == 0, 64, 0)
        for key, bit in (("any_map", 32), ("first_map", 16),
                         ("title_map", 8)):
            a = tables[key].get(prefix)
            if a is not None:
                j = np.searchsorted(a, docs_u)
                jc = np.minimum(j, a.size - 1)
                hit = (j < a.size) & (a[jc] == docs_u)
                prec |= np.where(hit, bit, 0)
        prec |= np.where(tables["short_title"][docs_u], 32, 0)
        score = ((prec << 8) | base).astype(np.float64)

        # scalar tie order: stable sort desc over dict-insertion order
        # (ascending doc id, since postings are sorted)
        order = np.lexsort((docs_u, -score))[:CHAMPION_LIST_SIZE]
        keys = tables["doc_keys"][docs_u[order]]
        return [ScoreEntry(float(s), int(k))
                for s, k in zip(score[order], keys)]
