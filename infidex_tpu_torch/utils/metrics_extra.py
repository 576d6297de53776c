"""Auxiliary metrics: bit-parallel LCS (packed multi-word), autocomplete
scoring, Jaccard.

Behavioral reference: Infidex ``Metrics/PackedBitParallelLcs.cs`` (Hyyro &
Navarro 2006 — multiple words packed into one 64-bit register, LCS per word
in one O(n) pass), ``Metrics/AutocompleteScoring.cs`` (Jaro-like LCS score
with prefix bonus), ``Metrics/JaccardMetric.cs`` (char-frequency and
char-set Jaccard). All three are DORMANT in the reference main path but part
of the public capability surface.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

MAX_PACKED_LENGTH = 60
_WORD_MASK_64 = (1 << 64) - 1


class PackedLcsResult:
    def __init__(self, lcs_values: List[int]):
        self.lcs_values = lcs_values
        self.total_lcs = sum(lcs_values)
        self.matched_words = sum(1 for v in lcs_values if v > 0)


def _bit_parallel_lcs_single(a: str, b: str) -> int:
    """Hyyro bit-parallel LCS for |a| <= 64."""
    m = len(a)
    if m == 0 or not b:
        return 0
    # match masks per char of b
    peq: Dict[str, int] = {}
    for i, ch in enumerate(a):
        peq[ch] = peq.get(ch, 0) | (1 << i)
    v = (1 << m) - 1  # all ones
    for ch in b:
        p = peq.get(ch, 0)
        u = v & p
        # Hyyro LCS recurrence: V' = (V + (V & M)) | (V & ~M)
        v = ((v + u) | (v & ~p)) & _WORD_MASK_64
    # number of zeros in V within m bits = LCS
    zeros = m - bin(v & ((1 << m) - 1)).count("1")
    return zeros


def packed_lcs(query_words: Sequence[str], document: str) -> PackedLcsResult:
    """LCS of each query word vs the document, all words packed into one
    64-bit register (single pass over the document)."""
    words = list(query_words)
    total = sum(len(w) for w in words)
    if total > MAX_PACKED_LENGTH or not words:
        # fall back to per-word bit-parallel
        return PackedLcsResult([
            _bit_parallel_lcs_single(w, document) for w in words])

    # Pack: word i occupies bits [offset_i, offset_i + len_i)
    offsets = []
    off = 0
    peq: Dict[str, int] = {}
    boundary_mask = 0
    for w in words:
        offsets.append(off)
        for k, ch in enumerate(w):
            peq[ch] = peq.get(ch, 0) | (1 << (off + k))
        boundary_mask |= 1 << off  # lowest bit of each word segment
        off += len(w)
    m_total = off
    seg_mask_all = (1 << m_total) - 1

    # The packed Hyyro recurrence: additions must not carry across word
    # boundaries. Standard trick: perform the (v + u) addition per segment by
    # adding boundary guard bits.
    v = seg_mask_all
    for ch in document:
        p = peq.get(ch, 0)
        u = v & p
        # segmented addition: add u to v within each word segment
        summed = 0
        for i, w in enumerate(words):
            lo = offsets[i]
            width = len(w)
            seg = (1 << width) - 1
            sv = (v >> lo) & seg
            su = (u >> lo) & seg
            summed |= ((sv + su) & seg) << lo
        v = (summed | (v & ~p)) & seg_mask_all

    lcs_values = []
    for i, w in enumerate(words):
        seg = ((v >> offsets[i]) & ((1 << len(w)) - 1))
        lcs_values.append(len(w) - bin(seg).count("1"))
    return PackedLcsResult(lcs_values)


def compute_lcs_length(a: str, b: str) -> int:
    """LCS length: bit-parallel for short strings, DP otherwise
    (AutocompleteScoring.ComputeLcsLength)."""
    if not a or not b:
        return 0
    if len(a) <= 64 and len(b) <= 64:
        return _bit_parallel_lcs_single(a, b)
    from .metrics import longest_common_subsequence

    return longest_common_subsequence(a, b)


def compute_jaro_like_score(query: str, candidate: str,
                            prefix_bonus: float = 0.1) -> float:
    """AutocompleteScoring.ComputeJaroLikeScore."""
    if not query or not candidate:
        return 0.0
    query_len, cand_len = len(query), len(candidate)
    prefix = 0
    for a, b in zip(query, candidate):
        if a != b:
            break
        prefix += 1
    lcs = compute_lcs_length(query, candidate)
    if lcs == 0:
        return 0.0
    coverage = lcs / query_len + lcs / cand_len
    base = 0.5 * lcs * coverage
    prefix_score = prefix_bonus * prefix
    max_score = min(query_len, cand_len) + prefix_bonus * min(4, min(query_len, cand_len))
    return max(0.0, min((base + prefix_score) / max(max_score, 1.0), 1.0))


class JaccardMetric:
    """Char-frequency and char-set Jaccard (Metrics/JaccardMetric.cs)."""

    def __init__(self, sought_text: str = ""):
        self.sought_text = sought_text

    def jaccard_of_all_chars(self, query: str, document: str) -> float:
        """Multiset (frequency) Jaccard over characters."""
        if not query or not document:
            return 0.0
        qc: Dict[str, int] = {}
        dc: Dict[str, int] = {}
        for ch in query:
            qc[ch] = qc.get(ch, 0) + 1
        for ch in document:
            dc[ch] = dc.get(ch, 0) + 1
        inter = sum(min(qc.get(ch, 0), dc.get(ch, 0)) for ch in qc)
        union = sum(max(qc.get(ch, 0), dc.get(ch, 0))
                    for ch in set(qc) | set(dc))
        return inter / union if union else 0.0

    def jaccard_of_char_set(self, query: str, document: str) -> float:
        """Set Jaccard over distinct characters."""
        if not query or not document:
            return 0.0
        qs, ds = set(query), set(document)
        union = qs | ds
        return len(qs & ds) / len(union) if union else 0.0
