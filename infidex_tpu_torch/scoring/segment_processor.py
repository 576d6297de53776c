"""Segment consolidation & best-segment text lookup.

Behavioral reference: Infidex ``Scoring/SegmentProcessor.cs`` — best score
per DocumentKey with (score, tiebreaker, lower-key-wins) ordering, then
descending sort; best-segment text resolution via the bestSegments map.
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Optional, Tuple

from ..index.vector_model import ScoreEntry
from ..utils.metrics import lcs


def consolidate_segments(scores: Iterable[ScoreEntry]) -> List[ScoreEntry]:
    best: Dict[int, ScoreEntry] = {}
    for entry in scores:
        existing = best.get(entry.document_id)
        if existing is None or _compare(entry, existing) > 0:
            best[entry.document_id] = entry
    result = list(best.values())
    result.sort(key=lambda e: e.sort_key())
    return result


def _compare(a: ScoreEntry, b: ScoreEntry) -> int:
    if a.score != b.score:
        return 1 if a.score > b.score else -1
    if a.tiebreaker != b.tiebreaker:
        return 1 if a.tiebreaker > b.tiebreaker else -1
    if a.document_id != b.document_id:
        return 1 if a.document_id < b.document_id else -1
    return 0


def _normalized_text(doc, text_normalizer) -> str:
    """Normalized indexed_text, memoized on the document (immutable text)."""
    if text_normalizer is None:
        return doc.indexed_text
    cache = doc._norm_cache
    key = id(text_normalizer)
    if cache is not None and cache[0] == key:
        return cache[1]
    text = text_normalizer.normalize(doc.indexed_text)
    doc._norm_cache = (key, text)
    return text


def get_best_segment_text(doc, best_segments_map, documents, text_normalizer) -> str:
    """SegmentProcessor.GetBestSegmentText: pick the best-scoring segment's
    text for a multi-segment document, then normalize."""
    text_doc = doc
    if best_segments_map:
        all_segments = documents.get_documents_for_public_key(doc.document_key)
        if all_segments:
            first = all_segments[0]
            base_id = first.id - first.segment_number
            entry = best_segments_map.get(base_id)
            if entry is not None:
                _, best_segment_num = entry
                best_doc = documents.get_document_of_segment(doc.document_key, best_segment_num)
                if best_doc is not None:
                    text_doc = best_doc
    return _normalized_text(text_doc, text_normalizer)


def calculate_lcs(q: str, r: str, error_tolerance: int) -> int:
    return lcs(q.lower(), r.lower(), error_tolerance)
