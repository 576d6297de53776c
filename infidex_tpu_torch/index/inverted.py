"""Minimal inverted-index wrapper.

Behavioral reference: Infidex ``Core/InvertedIndex.cs`` (66 LoC, DORMANT —
a trivial term->postings dict wrapper kept for API compatibility). Provided
for inventory parity; the real index lives in ``builder.BuiltIndex`` (host
CSR) + ``device.DeviceIndex`` (HBM CSR).
"""

from __future__ import annotations

from typing import Dict, Iterator, List, Optional, Tuple


class InvertedIndex:
    """term -> [(doc_id, weight)] dictionary (Core/InvertedIndex.cs)."""

    def __init__(self) -> None:
        self._postings: Dict[str, List[Tuple[int, float]]] = {}

    def add(self, term: str, doc_id: int, weight: float = 1.0) -> None:
        self._postings.setdefault(term, []).append((doc_id, weight))

    def postings(self, term: str) -> List[Tuple[int, float]]:
        return self._postings.get(term, [])

    def document_frequency(self, term: str) -> int:
        return len(self._postings.get(term, ()))

    def __contains__(self, term: str) -> bool:
        return term in self._postings

    def __len__(self) -> int:
        return len(self._postings)

    def terms(self) -> Iterator[str]:
        return iter(self._postings)
