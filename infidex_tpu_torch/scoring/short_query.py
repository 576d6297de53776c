"""Short-query path: 1-char full scan and 2-3 char padded-prefix search.

Behavioral reference: Infidex ``Scoring/ShortQueryProcessor.cs``:

* ``search_single_character`` (:19-152): full scan with precedence bits
  word-start=128 (+64 if first word), exact-token=32, first-token-exact=16,
  title==q=8, <=3-word title adds 32; base score packs word-start position
  decay + density.
* ``search_short_query`` (:154-231): pad-prefixed n-gram patterns plus
  " "+q -> prefix term lookup -> postings x10 weight -> first-token-prefix
  detection -> fuzzy fallback scan when <100 matched docs -> precedence bits.

This is the host implementation; champion lists (ShortQueryResolver) provide
the O(1) autocomplete fast path and live in index/short_query.py.
"""

from __future__ import annotations

import bisect
from typing import Dict, List, Optional, Sequence, Set, Tuple

from ..index.vector_model import ScoreEntry, VectorModel
from ..tokenization.tokenizer import START_PAD_CHAR

MAX_FST_TERMS_PER_PREFIX = 4096


def _split(text: str, delims) -> List[str]:
    out = []
    cur = []
    for ch in text:
        if ch in delims:
            if cur:
                out.append("".join(cur))
                cur = []
        else:
            cur.append(ch)
    if cur:
        out.append("".join(cur))
    return out


def search_single_character(
    ch: str,
    model: VectorModel,
    max_results: int,
    best_segments_map: Optional[Dict[int, Tuple[float, int]]] = None,
) -> List[ScoreEntry]:
    ch = ch.lower()
    delims = (model.tokenizer.tokenizer_setup.delimiter_set
              if model.tokenizer.tokenizer_setup else {" "})
    raw: List[ScoreEntry] = []
    for doc in model.documents.all_documents():
        text = doc.indexed_text or ""
        if not text:
            continue
        lower = text.lower()
        char_count = lower.count(ch)
        if char_count == 0:
            continue
        first_char_index = lower.find(ch)

        words = _split(lower, delims)
        has_word_start = False
        first_word_index = 2**31
        word_start_count = 0
        for i, w in enumerate(words):
            if w and w[0] == ch:
                has_word_start = True
                word_start_count += 1
                if i < first_word_index:
                    first_word_index = i

        any_exact = False
        first_token_exact = False
        if words:
            first_token_exact = len(words[0]) == 1 and words[0][0] == ch
            any_exact = first_token_exact or any(len(w) == 1 and w[0] == ch for w in words)
        title_equals = len(lower) == 1 and lower[0] == ch

        precedence = 0
        if has_word_start:
            precedence |= 128
            if first_word_index == 0:
                precedence |= 64
        if any_exact:
            precedence |= 32
        if first_token_exact:
            precedence |= 16
        if title_equals:
            precedence |= 8
        if len(words) <= 3:
            precedence |= 32

        if has_word_start:
            pos_component = 255 - min(first_word_index * 16, 240)
            density = min(word_start_count * 8, 32)
            raw_score = max(0, min(pos_component + density, 255))
            base = raw_score / 255.0
        else:
            pos_component = 200 - min(max(first_char_index, 0) * 4, 180)
            density = min(char_count * 4, 40)
            raw_score = max(0, min(pos_component + density, 200))
            base = max(1, raw_score) / 255.0

        raw.append(ScoreEntry(float(precedence) + base, doc.document_key))
        if best_segments_map is not None:
            base_id = doc.id - doc.segment_number
            if base_id >= 0:
                best_segments_map[base_id] = (float(precedence) + base, doc.segment_number)

    from .segment_processor import consolidate_segments

    consolidated = consolidate_segments(raw)
    if max_results < 2**31 and len(consolidated) > max_results:
        consolidated = consolidated[:max_results]
    return consolidated


def build_prefix_patterns(search_lower: str, min_index_size: int,
                          start_pad_size: int) -> List[str]:
    patterns: List[str] = []
    pad_len = start_pad_size
    for i in range(min(min_index_size, pad_len + len(search_lower))):
        pad_count = max(0, pad_len - i)
        query_count = min(len(search_lower), min_index_size - pad_count)
        if query_count > 0:
            patterns.append(START_PAD_CHAR * pad_count + search_lower[:query_count])
    patterns.append(" " + search_lower)
    return patterns


class _SortedVocab:
    """Sorted term table for prefix enumeration (FST GetByPrefix stand-in).

    Built over the finalized unified vocabulary (memory + disk segments).
    Append-only finalizes extend it via ``append_terms`` (a small sorted
    pending tier merged during enumeration) instead of re-sorting the
    whole vocabulary — an O(T log T) string sort per 2s finalize at 1M
    docs otherwise."""

    def __init__(self, model: VectorModel):
        if model.built is None:
            model.build_inverted_lists()
        self.sorted_terms = sorted(
            (t, i) for i, t in enumerate(model.built.terms)
        )
        self.keys = [t for t, _ in self.sorted_terms]
        self.pending: List[tuple] = []      # sorted (term, tid)
        self.pending_keys: List[str] = []

    def append_terms(self, new_terms) -> None:
        """Add (term, tid) pairs from an append-only finalize."""
        merged = sorted(self.pending + list(new_terms))
        self.pending = merged
        self.pending_keys = [t for t, _ in merged]

    def by_prefix(self, prefix: str, limit: int) -> List[int]:
        i = bisect.bisect_left(self.keys, prefix)
        out: List[int] = []
        if not self.pending:
            for k in range(i, len(self.keys)):
                if not self.keys[k].startswith(prefix):
                    break
                out.append(self.sorted_terms[k][1])
                if len(out) >= limit:
                    break
            return out
        # lexicographic merge of base + pending tiers (identical order
        # to a freshly sorted unified vocabulary; terms are unique)
        j = bisect.bisect_left(self.pending_keys, prefix)
        nk, np_ = len(self.keys), len(self.pending_keys)
        while len(out) < limit:
            a = self.keys[i] if i < nk else None
            b = self.pending_keys[j] if j < np_ else None
            a_ok = a is not None and a.startswith(prefix)
            b_ok = b is not None and b.startswith(prefix)
            if not a_ok and not b_ok:
                break
            if a_ok and (not b_ok or a <= b):
                out.append(self.sorted_terms[i][1])
                i += 1
            else:
                out.append(self.pending[j][1])
                j += 1
        return out


def search_short_query_fast(
    search_lower: str,
    model: VectorModel,
    vocab: _SortedVocab,
    max_results: int = 2**31 - 1,
) -> Optional[List[ScoreEntry]]:
    """Vectorized twin of ``search_short_query`` for the 1:1 id<->key
    case — identical entries (pinned by tests/test_short_query_vec.py).

    The scalar port walks every posting of up to 4096 prefix terms in
    Python (ShortQueryProcessor.cs:154-231 runs the same loop at C#
    speeds) — ~2s per 2-char query at 1M docs, the dominant host cost
    of the autocomplete-under-writes workload. Here the posting walk
    becomes CSR slice concatenation + two bincounts, and the per-doc
    precedence bits come from the ShortQueryResolver's persistent doc
    tables (token/title equality maps, packed text prefixes).

    Returns None when inapplicable (multi-segment docs, multi-token or
    over-length query, missing tables, or the <100-match fuzzy-fallback
    regime) — caller runs the scalar oracle."""
    import numpy as np

    if model.documents.multi_segment or model.built is None:
        return None
    res = model.short_query_resolver
    if res is None:
        return None
    max_p = res._prefix_index.max_prefix_length
    if not search_lower or len(search_lower) > max_p:
        return None
    delims = (model.tokenizer.tokenizer_setup.delimiter_set
              if model.tokenizer.tokenizer_setup else {" "})
    q_tokens = _split(search_lower, delims)
    if q_tokens != [search_lower]:
        return None  # delimiters inside/around: scalar handles
    deleted = model.deleted_arr
    keys = model.doc_keys_arr
    n = model.built.num_docs
    if deleted.size < n or keys.size < n:
        return None
    tables = res.ensure_tables()
    if tables["text_prefix"].shape[0] < n:
        return None

    built = model.built
    patterns = build_prefix_patterns(
        search_lower, model.tokenizer.min_index_size,
        model.tokenizer.start_pad_size)
    tids: List[int] = []
    for pattern in patterns:
        # no cross-pattern dedup: the scalar (and the reference) call
        # ProcessTerm once per (pattern, term) occurrence
        tids.extend(vocab.by_prefix(pattern, MAX_FST_TERMS_PER_PREFIX))
    tids = [t for t in tids if built.df[t] > 0]
    if not tids:
        return None  # scalar's fuzzy term-scan fallback decides
    offs = built.term_offsets
    slices_d = [built.postings_docs[offs[t]:offs[t + 1]] for t in tids]
    slices_w = [built.postings_weights[offs[t]:offs[t + 1]] for t in tids]
    docs_cat = np.concatenate(slices_d)
    w_cat = np.concatenate(slices_w)
    live = ~deleted[docs_cat]
    docs_l = docs_cat[live]
    if docs_l.size == 0:
        return None  # scalar's fuzzy term-scan fallback decides
    w_l = w_cat[live].astype(np.float64)
    counts = np.bincount(docs_l, minlength=n)
    matched = np.flatnonzero(counts)
    if matched.size < 100:
        return None  # scalar fuzzy-fallback regime (term-scan semantics)
    scores = np.bincount(docs_l, weights=w_l * 10.0, minlength=n)[matched]
    max_score = scores.max()
    norm = scores / max_score if max_score > 0 else scores / 255.0

    prec = np.zeros(matched.size, np.int64)

    def _bit(id_map, bit):
        a = id_map.get(search_lower)
        if a is None or a.size == 0:
            return
        j = np.searchsorted(a, matched)
        jc = np.minimum(j, a.size - 1)
        hit = (j < a.size) & (a[jc] == matched)
        prec[hit] |= bit

    _bit(tables["any_map"], 1)
    _bit(tables["first_map"], 4)
    _bit(tables["title_map"], 8)
    # text.lower().startswith(q) via the packed prefix compare
    m = len(search_lower)
    qpack = 0
    for ch in search_lower:
        qpack = (qpack << 21) | (ord(ch) + 1)
    shift = np.int64(21 * (max_p - m))
    hit = (tables["text_prefix"][matched] >> shift) == np.int64(qpack)
    prec |= np.where(hit, 2, 0)

    doc_keys = keys[matched]
    final = prec.astype(np.float64) + norm
    # When the coverage gate is certain to skip Stage 2/3 (distinct
    # prefix-doc count above the cap), only the top max_results entries
    # survive downstream — avoid materializing 10^5 ScoreEntry objects
    # to keep 10. ScoreEntry order is (score desc, tiebreaker desc=0,
    # key asc); the downstream re-sort is a no-op on this subset.
    if (max_results < final.size
            and model.short_query_index is not None):
        from .pipeline import SHORT_QUERY_COVERAGE_DOC_CAP

        if (model.short_query_index.count_documents(search_lower)
                > SHORT_QUERY_COVERAGE_DOC_CAP):
            order = np.lexsort((doc_keys, -final))[:max_results]
            final, doc_keys = final[order], doc_keys[order]
    return [ScoreEntry(float(s), int(k))
            for s, k in zip(final.tolist(), doc_keys.tolist())]


def search_short_query(
    search_lower: str,
    model: VectorModel,
    best_segments_map: Optional[Dict] = None,
    vocab: Optional[_SortedVocab] = None,
) -> List[ScoreEntry]:
    min_index_size = model.tokenizer.min_index_size
    start_pad = model.tokenizer.start_pad_size
    delims = (model.tokenizer.tokenizer_setup.delimiter_set
              if model.tokenizer.tokenizer_setup else {" "})

    matched_docs: Set[int] = set()
    first_token_prefix_docs: Set[int] = set()
    doc_scores: Dict[int, int] = {}

    patterns = build_prefix_patterns(search_lower, min_index_size, start_pad)
    if vocab is None:
        vocab = _SortedVocab(model)

    def process_term(term_id: int, multiplier: int) -> None:
        if model.built.df[term_id] <= 0:
            return
        doc_ids, weights = model.built.postings_for(term_id)
        for internal_id, weight in zip(doc_ids.tolist(), weights.tolist()):
            doc = model.documents.get_document(internal_id)
            if doc is None or doc.deleted:
                continue
            score = weight * multiplier
            key = doc.document_key
            if key in doc_scores:
                doc_scores[key] += score
            else:
                doc_scores[key] = score
                matched_docs.add(key)
            if key not in first_token_prefix_docs:
                if doc.indexed_text.lower().startswith(search_lower):
                    first_token_prefix_docs.add(key)
            if best_segments_map is not None:
                base_id = internal_id - doc.segment_number
                if base_id >= 0:
                    best_segments_map[base_id] = (float(score), doc.segment_number)

    for pattern in patterns:
        for tid in vocab.by_prefix(pattern, MAX_FST_TERMS_PER_PREFIX):
            process_term(tid, multiplier=10)

    # Fuzzy fallback when the prefix scan matched few documents (:221-228).
    if len(matched_docs) < 100:
        for tid, term in enumerate(model.built.terms):
            if any(term.startswith(p) for p in patterns):
                continue
            has_word_boundary = False
            char_matches = 0
            for q_char in search_lower:
                if (" " + q_char) in term:
                    has_word_boundary = True
                    char_matches += 1
                elif q_char in term:
                    char_matches += 1
            if has_word_boundary or char_matches > 0:
                process_term(tid, multiplier=2 if has_word_boundary else 1)

    # Final precedence scoring (:355-434).
    entries: List[ScoreEntry] = []
    max_score = max(doc_scores.values()) if doc_scores else 0
    query_tokens = _split(search_lower, delims)

    for key, score in doc_scores.items():
        doc = model.documents.get_document_by_public_key(key)
        if doc is None or doc.deleted:
            continue
        normalized = score / max_score if max_score > 0 else score / 255.0
        title_lower = doc.indexed_text.lower()
        trimmed = title_lower.strip()
        words = _split(title_lower, delims)
        precedence = _compute_precedence(
            query_tokens, words, search_lower, trimmed, key in first_token_prefix_docs)
        entries.append(ScoreEntry(float(precedence) + normalized, key))
    return entries


def _compute_precedence(query_tokens: List[str], words: List[str],
                        search_lower: str, trimmed_title: str,
                        first_token_starts_with_prefix: bool) -> int:
    precedence = 0
    if len(query_tokens) >= 2:
        token_matches = sum(1 for qt in query_tokens if qt in words)
        all_present = len(query_tokens) > 0 and token_matches == len(query_tokens)
        if all_present:
            precedence |= 8
            if len(words) <= len(query_tokens) + 1:
                precedence |= 2
        elif token_matches > 0:
            precedence |= 4
    else:
        any_exact = False
        first_exact = False
        if words:
            first_exact = words[0] == search_lower
            any_exact = first_exact or search_lower in words
        title_equals = trimmed_title == search_lower
        if any_exact:
            precedence |= 1
        if first_token_starts_with_prefix:
            precedence |= 2
        if first_exact:
            precedence |= 4
        if title_equals:
            precedence |= 8
    return precedence


def count_short_query_documents(search_lower: str, model: VectorModel,
                                vocab: Optional[_SortedVocab] = None) -> int:
    """Approximate PositionalPrefixIndex.CountDocuments: number of documents
    matched by the short-query prefix patterns (used for the coverage gate,
    SearchPipeline.cs:125-142)."""
    if model.short_query_index is not None:
        return model.short_query_index.count_documents(search_lower)
    patterns = build_prefix_patterns(
        search_lower, model.tokenizer.min_index_size, model.tokenizer.start_pad_size)
    if vocab is None:
        vocab = _SortedVocab(model)
    docs: Set[int] = set()
    for pattern in patterns:
        for tid in vocab.by_prefix(pattern, MAX_FST_TERMS_PER_PREFIX):
            if model.built.df[tid] > 0:
                docs.update(model.built.postings_for(tid)[0].tolist())
    return len(docs)
