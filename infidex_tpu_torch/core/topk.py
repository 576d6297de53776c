"""Bounded top-K heap over ScoreEntry ordering.

Behavioral reference: Infidex ``Core/TopKHeap.cs`` (60 LoC): a bounded
min-heap keyed by the ScoreEntry total order (score desc, tiebreaker desc,
lower document id wins — ScoreEntry.cs:25-36). Device paths return already
top-k'd tensors (lax.top_k); this heap serves the host-side paths
(coverage fallback, short queries, post-processing) where candidates
stream in one at a time.
"""

from __future__ import annotations

import heapq
from typing import Iterable, List

from ..index.vector_model import ScoreEntry


class TopKHeap:
    """Keeps the best `k` ScoreEntry items seen (TopKHeap.cs)."""

    def __init__(self, k: int):
        self.k = max(0, int(k))
        # heapq is a min-heap; store inverted sort keys so the WORST kept
        # entry sits at the root and is evicted first.
        self._heap: List[tuple] = []
        self._seq = 0

    @staticmethod
    def _inv_key(entry: ScoreEntry) -> tuple:
        s = entry.sort_key()  # ascending = best first
        return tuple(-x for x in s)

    def push(self, entry: ScoreEntry) -> None:
        if self.k == 0:
            return
        item = (self._inv_key(entry), self._seq, entry)
        self._seq += 1
        if len(self._heap) < self.k:
            heapq.heappush(self._heap, item)
        elif item[0] > self._heap[0][0]:
            heapq.heapreplace(self._heap, item)

    def extend(self, entries: Iterable[ScoreEntry]) -> None:
        for e in entries:
            self.push(e)

    def __len__(self) -> int:
        return len(self._heap)

    @property
    def threshold(self) -> float:
        """Score of the current worst kept entry (pruning bound)."""
        if len(self._heap) < self.k or not self._heap:
            return float("-inf")
        return self._heap[0][2].score

    def sorted_entries(self) -> List[ScoreEntry]:
        """Best-first list (score desc, tiebreaker desc, id asc)."""
        return [e for _, _, e in
                sorted(self._heap, key=lambda t: t[0], reverse=True)]
