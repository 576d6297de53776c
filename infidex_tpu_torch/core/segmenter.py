"""Automatic segmentation of long documents into overlapping chunks.

Behavioral reference: Infidex ``Core/AutoSegmenter.cs`` + ``CoreDocument.cs``:
numSegments = round((len + overlap*target) / (target - target*overlap));
word-aligned segment ends chosen closest to the per-segment target size;
overlap backtrack of overlap_ratio * segment_chars; first segment keeps the
original text in ``reserved``. As in the reference, the engine facade does
not invoke this automatically — callers segment and index the resulting
per-segment documents (same document_key, increasing segment_number).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence


class CoreDocument:
    """Lightweight (key, segment, text) record used by segmentation."""

    def __init__(self, document_key: int, segment_number: int = 0,
                 indexed_text: str = "",
                 document_client_information: Optional[str] = None,
                 json_index: int = 0):
        self.document_key = document_key
        self.segment_number = segment_number
        self.indexed_text = indexed_text
        self.document_client_information = document_client_information
        self.json_index = json_index
        self.reserved = ""

    @staticmethod
    def copy_of(other: "CoreDocument") -> "CoreDocument":
        doc = CoreDocument(other.document_key, other.segment_number,
                           other.indexed_text,
                           other.document_client_information,
                           other.json_index)
        doc.reserved = other.reserved
        return doc


def segments_required(documents: Sequence[CoreDocument],
                      max_length_of_text_to_be_indexed: int) -> bool:
    return any(len(d.indexed_text) > max_length_of_text_to_be_indexed
               for d in documents)


class AutoSegmenter:
    def __init__(self, overlap_ratio: float, target_segment_size: int,
                 delimiters: Sequence[str]):
        self._overlap_ratio = overlap_ratio
        self._target = target_segment_size
        self._delims = set(delimiters)

    def _word_ranges(self, text: str) -> List[tuple]:
        """(start, end) ranges of delimiter-separated words."""
        out = []
        i, n = 0, len(text)
        while i < n:
            while i < n and text[i] in self._delims:
                i += 1
            start = i
            while i < n and text[i] not in self._delims:
                i += 1
            if i > start:
                out.append((start, i))
        return out

    def segment_documents(self, docs: Sequence[CoreDocument]) -> List[CoreDocument]:
        keys: Dict[int, List[int]] = {}
        result: List[CoreDocument] = []
        for doc in docs:
            self.segment_single_document(result, doc, keys)
        return result

    def segment_single_document(self, destination: List[CoreDocument],
                                source: CoreDocument,
                                keys_per_external: Dict[int, List[int]]) -> bool:
        start_count = len(destination)
        if source is None or not source.indexed_text:
            return False
        keys_per_external.setdefault(source.document_key, [])

        text = source.indexed_text
        length = len(text)
        denom = self._target - self._target * self._overlap_ratio
        num_segments = _net_round(
            (length + self._overlap_ratio * self._target) / denom)

        if num_segments < 2.0:
            single = CoreDocument.copy_of(source)
            keys_per_external[source.document_key].append(len(destination))
            destination.append(single)
            return False

        ranges = self._word_ranges(text)
        word_count = len(ranges)
        if word_count <= 1:
            single = CoreDocument.copy_of(source)
            single.reserved = source.indexed_text
            keys_per_external[source.document_key].append(len(destination))
            destination.append(single)
            return False

        target_size = length / num_segments * (1.0 + self._overlap_ratio)

        current_word = 0
        segment_num = 0
        while current_word < word_count:
            end_word = _find_segment_end(
                current_word, ranges, word_count, _net_round_int(target_size),
                segment_num == int(num_segments) - 1)

            start_pos = ranges[current_word][1] if current_word > 0 else ranges[0][0]
            end_pos = ranges[end_word][1] if end_word < word_count else 0
            if end_pos == 0:
                end_pos = ranges[word_count - 1][1]
            if end_pos < start_pos:
                break
            segment_text = text[start_pos:end_pos]
            if not segment_text:
                break

            segment = CoreDocument(source.document_key, segment_num,
                                   segment_text,
                                   source.document_client_information,
                                   source.json_index)
            if segment_num == 0:
                segment.reserved = source.indexed_text
            else:
                segment.document_client_information = ""
            keys_per_external[source.document_key].append(len(destination))
            destination.append(segment)

            if end_word >= word_count:
                break

            overlap_chars = int((end_pos - start_pos) * self._overlap_ratio)
            backtrack = _find_backtrack(end_word, ranges, overlap_chars)
            segment_num += 1
            current_word = backtrack + 1
            if backtrack <= 0:
                current_word = 1
        return len(destination) - start_count > 1


def _net_round(x: float) -> float:
    """C# Math.Round: banker's rounding (Python round matches)."""
    return float(round(x))


def _net_round_int(x: float) -> int:
    return int(round(x))


def _find_segment_end(start_word: int, ranges, word_count: int,
                      target_size: int, is_last: bool) -> int:
    if is_last:
        return word_count
    current = 0
    previous = 0
    start_pos = ranges[start_word][1] if start_word > 0 else ranges[0][0]
    i = start_word
    while i < word_count:
        previous = current
        current = ranges[i][1] - start_pos
        if current >= target_size:
            break
        i += 1
    overshot = current - target_size
    undershot = target_size - previous
    if undershot < overshot:
        return max(i - 1, 0)
    return min(i, word_count)


def _find_backtrack(end_word: int, ranges, overlap_chars: int) -> int:
    current = 0
    previous = 0
    i = end_word - 1
    while i > 0:
        previous = current
        current = ranges[end_word][1] - ranges[i][1]
        if current >= overlap_chars:
            break
        i -= 1
    overshot = current - overlap_chars
    undershot = overlap_chars - previous
    if undershot < overshot:
        return i - 1
    return i
