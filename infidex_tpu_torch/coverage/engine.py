"""Stage-2 coverage analysis: the multi-algorithm lexical matcher cascade.

Behavioral reference: Infidex ``Coverage/*`` — this module replicates, in
cascade order with single-consumption token deactivation:

1. WholeWordMatcher.cs  — exact case-insensitive word equality,
2. JoinedWordMatcher.cs — "new york" <-> "newyork" in both directions,
3. PrefixSuffixMatcher.cs — exact prefix/suffix/contains pass then
   Damerau<=1 fuzzy-prefix pass, longest tokens first,
4. FuzzyWordMatcher.cs  — Damerau with per-token typo budget (>=7 chars: 2,
   >=3: 1, special len-2 first-char-anchored case),
then CoverageScorer.CalculateFinalScore and FusionSignalComputer.

This is the exact host oracle; the batched TPU implementation in
ops/coverage_kernel.py is property-tested against it. Candidate volume is
bounded by coverage_depth (default 500) so the oracle also serves as a
correct fallback path.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from .. import tracing
from ..utils.metrics import calculate_damerau
from .setup import CoverageSetup


# ----------------------------------------------------------------------
# Tokenization (Coverage/CoverageTokenizer.cs)

@dataclass
class TokenSlice:
    offset: int
    length: int
    position: int  # original token index in the text
    lower: str     # lowercase text of the slice (hash stand-in)

    @property
    def end(self) -> int:
        return self.offset + self.length


def tokenize_slices(text: str, min_word_size: int, delimiters) -> List[TokenSlice]:
    delims = delimiters if isinstance(delimiters, (set, frozenset)) else set(delimiters)
    out: List[TokenSlice] = []
    i, n = 0, len(text)
    while i < n:
        while i < n and text[i] in delims:
            i += 1
        if i >= n:
            break
        start = i
        while i < n and text[i] not in delims:
            i += 1
        length = i - start
        if length >= min_word_size:
            out.append(TokenSlice(start, length, start, text[start:i].lower()))
    return out


def dedupe_tokens(tokens: List[TokenSlice]) -> List[TokenSlice]:
    seen = set()
    out: List[TokenSlice] = []
    for t in tokens:
        if t.lower not in seen:
            seen.add(t.lower)
            out.append(t)
    return out


# ----------------------------------------------------------------------
# Query context (CoverageEngine.PrepareQuery)

@dataclass
class CoverageQueryContext:
    query: str
    query_tokens: List[TokenSlice]
    term_idf: List[float]
    term_max_chars: List[int]
    word_level_idf: Optional[List[float]]

    @property
    def q_count(self) -> int:
        return len(self.query_tokens)


# ----------------------------------------------------------------------
# Match state (Coverage/MatchState.cs)

class MatchState:
    def __init__(self, query: str, doc: str,
                 q_tokens: List[TokenSlice], d_tokens: List[TokenSlice],
                 term_idf: Sequence[float], term_max_chars: Sequence[int],
                 doc_token_count: int):
        qc, dc = len(q_tokens), len(d_tokens)
        self.query = query
        self.doc = doc
        self.q_tokens = q_tokens
        self.d_tokens = d_tokens
        self.q_active = [True] * qc
        self.d_active = [True] * dc
        self.term_matched_chars = [0.0] * qc
        self.term_max_chars = list(term_max_chars)
        self.term_has_whole = [False] * qc
        self.term_has_joined = [False] * qc
        self.term_has_prefix = [False] * qc
        self.term_first_pos = [-1] * qc
        self.term_idf = list(term_idf)
        self.q_count = qc
        self.d_count = dc
        self.doc_token_count = doc_token_count
        self.word_hits = 0
        self.num_whole = 0.0
        self.num_joined = 0.0
        self.num_fuzzy = 0.0
        self.num_prefix_suffix = 0.0
        self.penalty = 0

    def q_text(self, i: int) -> str:
        return self.q_tokens[i].lower

    def d_text(self, j: int) -> str:
        return self.d_tokens[j].lower

    def _note_pos(self, i: int, pos: int) -> None:
        if self.term_first_pos[i] == -1 or pos < self.term_first_pos[i]:
            self.term_first_pos[i] = pos


# ----------------------------------------------------------------------
# Matchers

def whole_word_matcher(st: MatchState) -> None:
    """Coverage/WholeWordMatcher.cs"""
    p_increment = 1 if st.q_count > 1 else 0
    for i in range(st.q_count):
        q = st.q_text(i)
        match_index = -1
        for j in range(st.d_count):
            if st.d_active[j] and st.d_text(j) == q:
                match_index = j
                break
        if match_index == -1:
            continue
        st.word_hits += 1
        st.num_whole += len(q)
        st.term_matched_chars[i] += len(q)
        st.term_has_whole[i] = True
        st.term_has_prefix[i] = True
        st._note_pos(i, st.d_tokens[match_index].position)
        # Order-mismatch penalty: doc token at position i must equal query
        # token i (WholeWordMatcher.cs:46-60).
        if st.d_count > i:
            if st.d_text(i) != q:
                st.penalty += 1
        else:
            st.penalty += 1
        if i < st.q_count - 1:
            st.num_whole += p_increment
        st.q_active[i] = False
        st.d_active[match_index] = False


def joined_word_matcher(st: MatchState) -> None:
    """Coverage/JoinedWordMatcher.cs"""
    # Query-joined: adjacent query pair == one doc token.
    for i in range(st.q_count - 1):
        if not st.q_active[i] or not st.q_active[i + 1]:
            continue
        next_idx = -1
        for k in range(i + 1, st.q_count):
            if st.q_active[k]:
                next_idx = k
                break
        if next_idx == -1:
            break
        q1, q2 = st.q_text(i), st.q_text(next_idx)
        joined_len = len(q1) + len(q2)
        match_index = -1
        for j in range(st.d_count):
            if st.d_active[j]:
                d = st.d_text(j)
                if len(d) == joined_len and d.startswith(q1) and d.endswith(q2):
                    match_index = j
                    break
        if match_index == -1:
            continue
        st.num_joined += joined_len
        st.word_hits += 2
        pos = st.d_tokens[match_index].position
        st.term_matched_chars[i] += len(q1)
        st.term_has_joined[i] = True
        st.term_has_prefix[i] = True
        st._note_pos(i, pos)
        st.term_matched_chars[next_idx] += len(q2)
        st.term_has_joined[next_idx] = True
        st._note_pos(next_idx, pos)
        st.q_active[i] = False
        st.q_active[next_idx] = False
        st.d_active[match_index] = False

    # Doc-joined: adjacent doc pair == one query token.
    for i in range(st.d_count - 1):
        if not st.d_active[i]:
            continue
        next_idx = -1
        for k in range(i + 1, st.d_count):
            if st.d_active[k]:
                next_idx = k
                break
        if next_idx == -1:
            break
        d1, d2 = st.d_text(i), st.d_text(next_idx)
        joined_len = len(d1) + len(d2)
        match_index = -1
        for j in range(st.q_count):
            if st.q_active[j]:
                q = st.q_text(j)
                if len(q) == joined_len and q.startswith(d1) and q.endswith(d2):
                    match_index = j
                    break
        if match_index == -1:
            continue
        st.num_joined += joined_len
        st.word_hits += 1
        st.term_matched_chars[match_index] += joined_len
        st.term_has_joined[match_index] = True
        st.term_has_prefix[match_index] = True
        st._note_pos(match_index, st.d_tokens[i].position)
        st.q_active[match_index] = False
        st.d_active[i] = False
        st.d_active[next_idx] = False


def _sorted_by_len_desc(indices: List[int], tokens: List[TokenSlice]) -> List[int]:
    # Insertion sort by length desc, stable (PrefixSuffixMatcher.cs:42-56).
    return sorted(indices, key=lambda i: -tokens[i].length)


def prefix_suffix_matcher(st: MatchState) -> None:
    """Coverage/PrefixSuffixMatcher.cs"""
    q_indices = _sorted_by_len_desc(
        [i for i in range(st.q_count) if st.q_active[i]], st.q_tokens)
    d_indices = _sorted_by_len_desc(
        [j for j in range(st.d_count) if st.d_active[j]], st.d_tokens)

    # Pass 1: exact prefix/suffix/contains.
    for i in q_indices:
        if not st.q_active[i]:
            continue
        q = st.q_text(i)
        for j in d_indices:
            if not st.d_active[j]:
                continue
            d = st.d_text(j)
            if len(q) == len(d):
                continue
            is_match = False
            is_prefix = False
            score = 0.0
            if len(q) < len(d):
                if d.startswith(q):
                    score, is_match, is_prefix = float(len(q)), True, True
                elif d.endswith(q):
                    score, is_match = float(max(1, len(q) // 2)), True
                elif len(q) >= 4 and q in d:
                    score, is_match = len(q) * 0.6, True
            else:
                if q.endswith(d):
                    score, is_match = float(len(d)), True
            if is_match:
                st.num_prefix_suffix += score
                st.word_hits += 1
                st.term_matched_chars[i] += score
                if is_prefix:
                    st.term_has_prefix[i] = True
                st._note_pos(i, st.d_tokens[j].position)
                st.q_active[i] = False
                st.d_active[j] = False
                break

    # Pass 2: fuzzy prefix (Damerau<=1 against doc prefixes of len q, q+1, q-1).
    for i in q_indices:
        if not st.q_active[i]:
            continue
        q = st.q_text(i)
        q_len = len(q)
        if not (q_len >= 4 or (i == st.q_count - 1 and q_len >= 2)):
            continue
        for j in d_indices:
            if not st.d_active[j]:
                continue
            d = st.d_text(j)
            if q_len >= len(d):
                continue
            max_edits = 1
            is_match = False
            score = 0.0
            dist = calculate_damerau(q, d[:q_len], max_edits, True)
            if dist <= max_edits:
                score = max(q_len - dist, 0.1)
                is_match = True
            elif len(d) > q_len:
                dist = calculate_damerau(q, d[: q_len + 1], max_edits, True)
                if dist <= max_edits:
                    score = max(q_len - dist, 0.1)
                    is_match = True
                elif q_len > 1:
                    dist = calculate_damerau(q, d[: q_len - 1], max_edits, True)
                    if dist <= max_edits:
                        score = max(q_len - 1 - dist, 0.1)
                        is_match = True
            if is_match:
                st.num_prefix_suffix += score
                st.word_hits += 1
                st.term_matched_chars[i] += score
                st._note_pos(i, st.d_tokens[j].position)
                st.q_active[i] = False
                st.d_active[j] = False
                break


def all_terms_fully_matched(st: MatchState) -> bool:
    for i in range(st.q_count):
        if st.term_max_chars[i] > 0 and st.term_matched_chars[i] < st.term_max_chars[i]:
            return False
    return True


def fuzzy_word_matcher(st: MatchState, setup: CoverageSetup) -> None:
    """Coverage/FuzzyWordMatcher.cs"""
    max_query_len = 0
    for i in range(st.q_count):
        if st.q_active[i] and st.q_tokens[i].length > max_query_len:
            max_query_len = st.q_tokens[i].length
    if max_query_len == 0:
        return

    if max_query_len >= setup.min_length_two_typos:
        max_edit = 2
    elif max_query_len >= setup.min_length_one_typo:
        max_edit = 1
    else:
        max_edit = 0

    if max_query_len == 2 and max_edit == 0 and setup.num_typos >= 1:
        max_edit = 1
    max_edit = min(max_edit, setup.num_typos)
    if max_edit == 0:
        return

    for edit_dist in range(1, max_edit + 1):
        if not any(st.q_active[: st.q_count]):
            break
        for i in range(st.q_count):
            if not st.q_active[i]:
                continue
            q = st.q_text(i)
            q_len = len(q)
            if q_len < setup.min_word_size:
                continue
            if q_len >= setup.min_length_two_typos:
                token_max = 2
            elif q_len >= setup.min_length_one_typo:
                token_max = 1
            else:
                token_max = 0
            special_short = False
            if q_len == 2 and token_max == 0 and setup.num_typos >= 1:
                token_max = 1
                special_short = True
            token_max = min(token_max, setup.num_typos)
            if edit_dist > token_max:
                continue
            if special_short and edit_dist != 1:
                continue
            min_len = max(setup.min_word_size, q_len - edit_dist)
            max_len = min(setup.levenshtein_max_word_size, q_len + edit_dist, 63)
            for j in range(st.d_count):
                if not st.d_active[j]:
                    continue
                d = st.d_text(j)
                if len(d) > max_len or len(d) < min_len:
                    continue
                if special_short and (not d or d[0] != q[0]):
                    continue
                dist = calculate_damerau(q, d, edit_dist, True)
                if dist <= edit_dist:
                    st.word_hits += 1
                    st.num_fuzzy += q_len - dist
                    st.term_matched_chars[i] += q_len - dist
                    st._note_pos(i, st.d_tokens[j].position)
                    st.q_active[i] = False
                    st.d_active[j] = False
                    break


# ----------------------------------------------------------------------
# Coverage scorer (Coverage/CoverageScorer.cs)

@dataclass
class FusionSignals:
    unfiltered_query_token_count: int = 0
    lexical_prefix_last: bool = False
    all_preceding_exact: bool = False
    is_perfect_doc_lexical: bool = False
    has_stem_evidence: bool = False
    has_anchor_stem: bool = False
    trailing_match_density: int = 0    # byte 0..255
    single_term_lexical_sim: int = 0   # byte 0..255
    single_char_last_token_boost: int = 0


@dataclass
class CoverageFeatures:
    coverage_score: int = 0
    terms_count: int = 0
    terms_with_any_match: int = 0
    terms_fully_matched: int = 0
    terms_strict_matched: int = 0
    terms_prefix_matched: int = 0
    first_match_index: int = -1
    sum_ci: float = 0.0
    word_hits: int = 0
    doc_token_count: int = 0
    longest_prefix_run: int = 0
    suffix_prefix_run: int = 0
    phrase_span: int = 0
    preceding_strict_count: int = 0
    last_token_has_prefix: bool = False
    last_term_ci: float = 0.0
    weighted_coverage: float = 0.0
    last_term_is_type_ahead: bool = False
    idf_coverage: float = 0.0
    total_idf: float = 0.0
    missing_idf: float = 0.0
    term_idf: Optional[List[float]] = None
    term_ci: Optional[List[float]] = None
    fusion: FusionSignals = field(default_factory=FusionSignals)


def score_coverage(st: MatchState, query_len: int, lcs_sum: float,
                   cover_whole_query: bool,
                   word_level_idf: Optional[List[float]]) -> CoverageFeatures:
    f = CoverageFeatures()
    q_count = st.q_count
    if not cover_whole_query:
        lcs_sum = 0.0

    num11 = st.num_joined + st.num_whole + st.num_fuzzy + st.num_prefix_suffix - st.penalty
    if num11 == 0.0 and lcs_sum > 2.0:
        num11 = lcs_sum - 2.0
    f.coverage_score = int(max(min(num11 / max(query_len, 1) * 255.0, 255.0), 0.0))

    sum_ci = 0.0
    weighted_sum = 0.0
    total_weight = 0.0
    idf_weighted_sum = 0.0
    total_idf = 0.0
    missing_idf = 0.0
    last_term_ci = 0.0
    last_term_idf = 0.0
    first_match_index = -1
    min_pos, max_pos = 2**31, -1

    term_ci_array = [0.0] * q_count if (word_level_idf is not None and q_count > 0) else None

    for i in range(q_count):
        if st.term_max_chars[i] <= 0:
            continue
        ci = min(1.0, st.term_matched_chars[i] / st.term_max_chars[i])
        sum_ci += ci
        if term_ci_array is not None:
            term_ci_array[i] = ci
        if ci > 0:
            f.terms_with_any_match += 1
        term_len = st.term_max_chars[i]
        total_weight += term_len
        weighted_sum += ci * term_len
        idf = st.term_idf[i]
        total_idf += idf
        idf_weighted_sum += ci * idf
        if ci < 1.0:
            missing_idf += (1.0 - ci) * idf
        if i == q_count - 1:
            last_term_ci = ci
            last_term_idf = idf
        fully = st.term_matched_chars[i] >= (st.term_max_chars[i] - 0.01)
        if fully:
            f.terms_fully_matched += 1
        if (st.term_has_whole[i] or st.term_has_joined[i]) and fully:
            f.terms_strict_matched += 1
        if st.term_has_prefix[i]:
            f.terms_prefix_matched += 1
        if st.term_first_pos[i] >= 0:
            if first_match_index == -1 or st.term_first_pos[i] < first_match_index:
                first_match_index = st.term_first_pos[i]
            min_pos = min(min_pos, st.term_first_pos[i])
            max_pos = max(max_pos, st.term_first_pos[i])

    f.terms_count = q_count
    f.word_hits = st.word_hits
    f.doc_token_count = st.doc_token_count
    f.first_match_index = first_match_index
    f.weighted_coverage = weighted_sum / total_weight if total_weight > 0 else 0.0
    f.idf_coverage = idf_weighted_sum / total_idf if total_idf > 0 else 0.0
    f.total_idf = total_idf
    f.missing_idf = missing_idf
    f.last_term_ci = last_term_ci
    # NOTE: features.term_idf carries the WORD-level idf array (the raw
    # word_level_idf input), while total/missing/coverage idf above use the
    # n-gram-average state idf — this mirrors CoverageScorer.cs:197 exactly.
    f.term_idf = list(word_level_idf[:q_count]) if word_level_idf is not None else None
    f.term_ci = term_ci_array

    if q_count > 0 and total_idf > 0:
        idf_share = last_term_idf / total_idf
        f.last_term_is_type_ahead = idf_share <= 1.0 / (q_count + 1)

    if q_count == 1 and query_len > 0 and lcs_sum > 0.0:
        ci_lcs = min(1.0, lcs_sum / query_len)
        if ci_lcs > sum_ci:
            sum_ci = ci_lcs
    f.sum_ci = sum_ci

    run = 0
    for i in range(q_count):
        hit = st.term_has_prefix[i] and st.term_max_chars[i] > 0 and st.term_matched_chars[i] > 0
        if hit:
            run += 1
            f.longest_prefix_run = max(f.longest_prefix_run, run)
        else:
            run = 0

    suffix_run = 0
    for i in range(q_count - 1, -1, -1):
        hit = st.term_has_prefix[i] and st.term_max_chars[i] > 0 and st.term_matched_chars[i] > 0
        if hit:
            suffix_run += 1
        else:
            break
    f.suffix_prefix_run = suffix_run

    if min_pos != 2**31 and max_pos >= min_pos and f.terms_with_any_match >= 2:
        f.phrase_span = (max_pos - min_pos) + 1

    if q_count >= 1:
        last = q_count - 1
        f.last_token_has_prefix = st.term_has_prefix[last] and st.term_matched_chars[last] > 0
        if q_count >= 2:
            for i in range(q_count - 1):
                strict = (st.term_has_whole[i] or st.term_has_joined[i]) and \
                    st.term_matched_chars[i] >= (st.term_max_chars[i] - 0.01)
                if strict:
                    f.preceding_strict_count += 1
    return f


# ----------------------------------------------------------------------
# Fusion signal computer (Coverage/FusionSignalComputer.cs)

ANCHOR_STEM_LENGTH = 3
MAX_TRAILING_TERM_LENGTH_FOR_BONUS = 2


def compute_fusion_signals(query: str, doc: str,
                           q_tokens: List[TokenSlice], d_tokens: List[TokenSlice],
                           min_stem_length: int,
                           doc_metadata=None) -> FusionSignals:
    sig = FusionSignals(unfiltered_query_token_count=len(q_tokens))
    q_count, d_count = len(q_tokens), len(d_tokens)
    if q_count == 0 or d_count == 0:
        return sig

    ql = [t.lower for t in q_tokens]
    dl = [t.lower for t in d_tokens]

    # 1. CheckPrefixLastMatch
    if q_count == 1:
        q = ql[0]
        for d in dl:
            if d.startswith(q):
                sig.lexical_prefix_last = True
                sig.all_preceding_exact = (d == q)
                break
    else:
        all_prec = True
        for q in ql[:-1]:
            if not q:
                continue
            if q not in dl:
                all_prec = False
                break
        if all_prec:
            last = ql[-1]
            if not last:
                sig.lexical_prefix_last = sig.all_preceding_exact = True
            else:
                sig.all_preceding_exact = True
                for d in dl:
                    if d.startswith(last):
                        sig.lexical_prefix_last = True
                        break
                if not sig.lexical_prefix_last:
                    sig.all_preceding_exact = False

    # 2. ComputePerfectDoc: every doc token prefix-related to some query token.
    perfect = True
    for d in dl:
        explained = False
        for q in ql:
            if d.startswith(q) or q.startswith(d):
                explained = True
                break
        if not explained:
            perfect = False
            break
    sig.is_perfect_doc_lexical = perfect

    # 3. CheckStemEvidence (q_count >= 2)
    if q_count >= 2:
        unmatched = 0
        evidence = 0
        for q in ql:
            if len(q) < min_stem_length:
                continue
            has_word_match = any(d == q or d.startswith(q) for d in dl if d)
            if has_word_match:
                continue
            unmatched += 1
            for d in dl:
                if len(d) < min_stem_length:
                    continue
                if q.startswith(d):
                    evidence += 1
                    break
                max_check = min(len(q), len(d))
                if max_check >= min_stem_length:
                    plen = 0
                    for a, b in zip(q, d):
                        if a == b:
                            plen += 1
                        else:
                            break
                    if plen >= min_stem_length:
                        evidence += 1
                        break
        sig.has_stem_evidence = unmatched > 0 and evidence == unmatched

    # 4. HasAnchorStem
    if q_count > 0 and len(ql[0]) >= ANCHOR_STEM_LENGTH:
        stem = ql[0][:ANCHOR_STEM_LENGTH]
        if doc_metadata is not None and getattr(doc_metadata, "has_tokens", False) \
                and len(doc_metadata.first_token) >= len(stem):
            if doc_metadata.first_token.lower().startswith(stem):
                sig.has_anchor_stem = True
            else:
                for d in dl[1:]:
                    if len(d) >= len(stem) and d.startswith(stem):
                        sig.has_anchor_stem = True
                        break
        elif doc_metadata is None or not getattr(doc_metadata, "has_tokens", False):
            for d in dl:
                if len(d) >= len(stem) and d.startswith(stem):
                    sig.has_anchor_stem = True
                    break

    # 5. TrailingMatchDensity
    if q_count >= 2:
        last = ql[-1]
        if 1 <= len(last) <= MAX_TRAILING_TERM_LENGTH_FOR_BONUS:
            matchable = 0
            for d in dl:
                if d.startswith(last) or (len(d) > len(last) and last in d):
                    matchable += 1
            if matchable > 0:
                density = matchable / d_count
                sig.trailing_match_density = int(np.clip(density * 255.0, 0.0, 255.0))

    # 6. SingleTermLexicalSim
    if q_count == 1:
        sim = _single_term_lexical_similarity(ql[0], dl)
        sig.single_term_lexical_sim = int(np.clip(sim * 255.0, 0.0, 255.0))

    # 7. SingleCharLastTokenBoost
    if q_count >= 2:
        sig.single_char_last_token_boost = _single_char_last_token_match(
            query, doc, q_tokens, d_tokens, ql, dl)
    return sig


def _single_term_lexical_similarity(q: str, dl: List[str]) -> float:
    q_len = len(q)
    if q_len < 3:
        return 0.0
    best = 0.0
    for t in dl:
        if len(t) < 2:
            continue
        idx = q.find(t)
        if idx >= 0:
            score = (len(t) / q_len) * (1.0 - idx / q_len)
            if score > best:
                best = score
            continue
        max_k = min(q_len, len(t))
        best_k = 0
        for k in range(max_k, 1, -1):
            if q[q_len - k:] == t[:k]:
                best_k = k
                break
        prefix_suffix = best_k / q_len if best_k > 0 else 0.0
        fuzzy = 0.0
        if len(t) <= 32:
            dist = calculate_damerau(q, t, 2, False)
            if dist <= 2:
                fuzzy = (q_len - dist) / q_len
        combined = max(prefix_suffix, fuzzy)
        if combined > best:
            best = combined

    MIN_SEG = 3
    if q_len >= 2 * MIN_SEG:
        seg_len = min(2 * MIN_SEG, q_len // 2)
        prefix_frag = q[:seg_len]
        suffix_frag = q[q_len - seg_len:]
        prefix_idx = suffix_idx = -1
        for i, t in enumerate(dl):
            if len(t) < 3:
                continue
            if prefix_idx == -1 and (t.startswith(prefix_frag) or prefix_frag.startswith(t)):
                prefix_idx = i
            if suffix_idx == -1 and (t.endswith(suffix_frag) or suffix_frag.endswith(t)):
                suffix_idx = i
            if prefix_idx != -1 and suffix_idx != -1:
                break
        if prefix_idx != -1 and suffix_idx != -1 and prefix_idx != suffix_idx:
            two_seg = min(1.0, (len(prefix_frag) + len(suffix_frag)) / q_len)
            if two_seg > best:
                best = two_seg
    return best


def _single_char_last_token_match(query: str, doc: str,
                                  q_tokens: List[TokenSlice], d_tokens: List[TokenSlice],
                                  ql: List[str], dl: List[str]) -> int:
    q_count, d_count = len(q_tokens), len(d_tokens)
    last = ql[-1]
    if len(last) != 1:
        return 0
    target = last[0]
    if not target.isalpha():
        return 0
    d_index = 0
    first_match_index = -1
    for i in range(q_count - 1):
        q = ql[i]
        found = False
        while d_index < d_count:
            if q in dl[d_index]:
                found = True
                if first_match_index == -1:
                    first_match_index = d_index
                break
            d_index += 1
        if not found:
            return 0
    if d_index + 1 < d_count:
        nxt = dl[d_index + 1]
        if nxt and nxt[0] == target:
            end_of_last = d_tokens[d_index].end
            start_of_next = d_tokens[d_index + 1].offset
            if all(doc[p].isspace() for p in range(end_of_last, start_of_next)):
                boost = 8 + max(0, 16 - first_match_index)
                if len(nxt) == 1:
                    boost += 4
                return boost
    return 0


# ----------------------------------------------------------------------
# Coverage engine facade (Coverage/CoverageEngine.cs)

class CoverageEngine:
    def __init__(self, tokenizer, setup: Optional[CoverageSetup] = None):
        self._tokenizer = tokenizer
        self._setup = setup or CoverageSetup.create_default()
        self._term_dict = None
        self._df = None
        self._total_documents = 0
        self._query_idf_cache: Dict[str, List[float]] = {}
        self._doc_metadata = None
        self._word_idf_cache: Optional[Dict[str, float]] = None

    @property
    def setup(self) -> CoverageSetup:
        return self._setup

    def set_corpus_statistics(self, term_dict, df, total_documents: int) -> None:
        self._term_dict = term_dict
        self._df = df
        self._total_documents = total_documents
        self._query_idf_cache.clear()

    def set_document_metadata_cache(self, metadata) -> None:
        self._doc_metadata = metadata

    def set_word_idf_cache(self, cache: Optional[Dict[str, float]]) -> None:
        self._word_idf_cache = cache

    def _delims(self):
        ts = self._tokenizer.tokenizer_setup
        return ts.delimiter_set if ts is not None else {" "}

    def prepare_query(self, query: str) -> CoverageQueryContext:
        with tracing.span("coverage.prepare_query"):
            if not query:
                return CoverageQueryContext(query, [], [], [], None)
            tokens = tokenize_slices(query, self._setup.min_word_size, self._delims())
            if not tokens:
                return CoverageQueryContext(query, [], [], [], None)
            tokens = dedupe_tokens(tokens)

            if self._term_dict is not None and self._total_documents > 0:
                cached = self._query_idf_cache.get(query)
                if cached is None or len(cached) < len(tokens):
                    cached = [self._compute_term_idf(t.lower) for t in tokens]
                    self._query_idf_cache[query] = cached
                term_idf = cached[: len(tokens)]
            else:
                term_idf = [float(np.log2(t.length + 1)) for t in tokens]

            term_max_chars = [t.length for t in tokens]

            word_level_idf = None
            if self._word_idf_cache is not None:
                word_level_idf = [
                    self._word_idf_cache.get(t.lower, 0.0) for t in tokens
                ]
            return CoverageQueryContext(query, tokens, term_idf, term_max_chars, word_level_idf)

    def _compute_term_idf(self, term: str) -> float:
        """Average idf over constituent n-grams (CoverageEngine.cs:388-427)."""
        from ..index.device import compute_idf

        if self._term_dict is None or self._total_documents == 0:
            return float(np.log2(len(term) + 1))
        idf_sum = 0.0
        count = 0
        for size in self._tokenizer.index_sizes:
            if len(term) < size:
                continue
            for i in range(len(term) - size + 1):
                gram = term[i : i + size]
                tid = self._term_dict.get_id(gram)
                if tid >= 0:
                    df = int(self._df[tid])
                    if df > 0:
                        idf_sum += compute_idf(self._total_documents, df)
                        count += 1
        if count > 0:
            return idf_sum / count
        return float(np.log2(len(term) + 1))

    def calculate_features(self, context: CoverageQueryContext, doc_text: str,
                           lcs_sum: float, document_id: int = -1) -> CoverageFeatures:
        if context.q_count == 0:
            return CoverageFeatures()
        delims = self._delims()

        d_tokens_raw = tokenize_slices(doc_text, self._setup.min_word_size, delims)
        doc_token_count = len(d_tokens_raw)
        d_tokens = dedupe_tokens(d_tokens_raw)

        st = MatchState(
            context.query, doc_text, context.query_tokens, d_tokens,
            context.term_idf, context.term_max_chars, doc_token_count)

        s = self._setup
        if s.cover_whole_words:
            whole_word_matcher(st)
        if s.cover_joined_words and st.q_count > 0:
            joined_word_matcher(st)
        if s.cover_prefix_suffix and st.q_count > 0:
            prefix_suffix_matcher(st)
        if s.cover_fuzzy_words and st.q_count > 0 and not all_terms_fully_matched(st):
            fuzzy_word_matcher(st, s)

        features = score_coverage(
            st, len(context.query), lcs_sum, s.cover_whole_query,
            context.word_level_idf)

        # Fusion signals over ALL tokens (min word size 0).
        fusion_q = tokenize_slices(context.query, 0, delims)
        fusion_d = tokenize_slices(doc_text, 0, delims)
        metadata = None
        if self._doc_metadata is not None and document_id >= 0 and document_id < len(self._doc_metadata):
            metadata = self._doc_metadata[document_id]
        features.fusion = compute_fusion_signals(
            context.query, doc_text, fusion_q, fusion_d,
            s.min_word_size, metadata)
        return features


def calculate_ranked_score(features: CoverageFeatures, doc_token_count: int,
                           base_tfidf_score: int) -> int:
    """Legacy packed (precedence << 8) | quality ushort scorer
    (CoverageScorer.CalculateRankedScore, CoverageScorer.cs:200-251).

    Kept for capability parity: the README's bit table documents this
    layout; the live pipeline uses fusion_calculate instead.
    """
    terms_count = features.terms_count
    coverage_score = features.coverage_score & 0xFF
    first_match_index = features.first_match_index
    sum_ci = features.sum_ci
    word_hits = features.word_hits
    terms_with_any = features.terms_with_any_match
    terms_fully = features.terms_fully_matched
    terms_strict = features.terms_strict_matched
    terms_prefix = features.terms_prefix_matched

    coord_coverage = sum_ci / terms_count if terms_count > 0 else 0.0
    term_completeness = (terms_fully / terms_count) if terms_count > 0 else 0.0
    combined = 0.5 * coord_coverage + 0.5 * term_completeness
    coverage_tier = int(min(max(combined * 63.0, 0.0), 63.0))
    base_score = base_tfidf_score if coverage_score <= base_tfidf_score \
        else coverage_score
    final_q = base_score / 255.0
    final_quality_tier = int(min(max(final_q * 3.0, 0.0), 3.0))
    base_final = ((coverage_tier << 2) | final_quality_tier) & 0xFF

    precedence = 0
    all_found = terms_with_any == terms_count
    fully = terms_fully == terms_count
    strict_whole = terms_strict == terms_count
    prefix_matched = terms_prefix == terms_count
    if all_found:
        precedence |= 128
    if fully:
        precedence |= 64
    perfect = (doc_token_count > 0 and word_hits == doc_token_count
               and all_found)
    if terms_count == 1:
        if strict_whole:
            precedence |= 32
        if perfect:
            precedence |= 16
    else:
        if perfect:
            precedence |= 32
        if strict_whole:
            precedence |= 16
    if first_match_index == 0:
        precedence |= 8
    if prefix_matched:
        precedence |= 4
    return ((precedence << 8) | base_final) & 0xFFFF
