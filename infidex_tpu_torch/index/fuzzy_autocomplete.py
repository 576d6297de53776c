"""Top-k fuzzy autocomplete via best-first search over a term trie.

Behavioral reference: Infidex ``Indexing/DepthFirstFuzzySearch.cs`` (DORMANT;
cites AbdelNaby et al. 2020): expand trie nodes in order of
(prefix-edit-distance, -matched-length) from a min-heap, yielding the k
dictionary terms whose prefixes are closest to the query prefix.
"""

from __future__ import annotations

import heapq
import itertools
from typing import Dict, List, Optional, Tuple


class _TrieNode:
    __slots__ = ("children", "term_id")

    def __init__(self) -> None:
        self.children: Dict[str, "_TrieNode"] = {}
        self.term_id: int = -1


class DepthFirstFuzzySearch:
    """Trie + best-first fuzzy prefix matcher."""

    def __init__(self) -> None:
        self._root = _TrieNode()
        self._terms: List[str] = []

    def add(self, term: str, term_id: Optional[int] = None) -> int:
        if term_id is None:
            term_id = len(self._terms)
        node = self._root
        for ch in term:
            nxt = node.children.get(ch)
            if nxt is None:
                nxt = _TrieNode()
                node.children[ch] = nxt
            node = nxt
        node.term_id = term_id
        while len(self._terms) <= term_id:
            self._terms.append("")
        self._terms[term_id] = term
        return term_id

    def search(self, query: str, k: int = 10,
               max_distance: int = 2) -> List[Tuple[str, int, int]]:
        """Top-k (term, term_id, prefix_edit_distance), best-first.

        Ordering: lower prefix edit distance first, longer matched prefix
        breaking ties (the reference's (dist, -matched-len) heap key).
        """
        if not query:
            return []
        m = len(query)
        counter = itertools.count()
        # heap entries: (bound, -depth, tiebreak, node, dp_row, best_pld)
        # best_pld = min over path prefixes p of lev(p, query) — the prefix
        # edit distance once a terminal is reached.
        root_row = list(range(m + 1))
        heap = [(0, 0, next(counter), self._root, root_row, m)]
        results: List[Tuple[str, int, int]] = []
        seen_terms = set()

        while heap and len(results) < k:
            bound, neg_depth, _, node, row, best_pld = heapq.heappop(heap)
            if bound > max_distance:
                break
            if node.term_id >= 0 and node.term_id not in seen_terms:
                dist = min(best_pld, row[m])
                if dist <= max_distance:
                    seen_terms.add(node.term_id)
                    results.append((self._terms[node.term_id],
                                    node.term_id, dist))
            for ch, child in node.children.items():
                new_row = [row[0] + 1]
                for i in range(1, m + 1):
                    cost = 0 if query[i - 1] == ch else 1
                    new_row.append(min(row[i - 1] + cost,
                                       row[i] + 1,
                                       new_row[i - 1] + 1))
                child_best = min(best_pld, new_row[m])
                # min(new_row) lower-bounds every descendant's distance
                child_bound = min(child_best, min(new_row))
                if child_bound <= max_distance:
                    heapq.heappush(heap, (
                        child_bound, neg_depth - 1, next(counter),
                        child, new_row, child_best))
        return results
