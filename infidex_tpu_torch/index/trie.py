"""Flat-array trie over the term dictionary (the reference's "FST").

Behavioral reference: Infidex ``Fst/FstBuilder.cs`` / ``FstIndex.cs`` /
``FstNode.cs`` / ``FstSerializer.cs`` — despite the name a plain trie (no
minimization): BFS-compacted flat node/arc arrays with label-sorted arcs,
FORWARD and REVERSE automata for prefix and suffix queries, exact O(len)
lookup, prefix/suffix collect & count, edit-distance-1 traversal (the
reference uses Myers bit-parallel masks; here a banded DP row carried down
the trie — identical results), and ordinal-ordered term enumeration.

TPU note: the hot LD1 path in this framework is the symmetric-delete index
(word_matcher.py) and affix lookups are binary searches over sorted term
matrices — this trie is the standalone capability for callers that need
the automaton API (fuzzy autocomplete walks it best-first).
"""

from __future__ import annotations

from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np


class TrieIndex:
    """Flat arrays: nodes = (arc_start, arc_count, value); arcs =
    (label, target), labels sorted per node (FstBuilder.cs:80-167)."""

    def __init__(self, terms: List[str], values: Optional[List[int]] = None,
                 reverse: bool = False):
        self.reverse = reverse
        if values is None:
            values = list(range(len(terms)))
        # build dict-trie
        root: Dict = {}
        vals: Dict[int, int] = {}
        node_ids = {id(root): 0}
        nodes = [root]
        for term, val in zip(terms, values):
            key = term[::-1] if reverse else term
            cur = root
            for ch in key:
                nxt = cur.get(ch)
                if nxt is None:
                    nxt = {}
                    cur[ch] = nxt
                    node_ids[id(nxt)] = len(nodes)
                    nodes.append(nxt)
                cur = nxt
            vals[node_ids[id(cur)]] = val
        # BFS-compact to flat arrays with label-sorted arcs
        n = len(nodes)
        self.arc_start = np.zeros(n + 1, np.int64)
        labels: List[str] = []
        targets: List[int] = []
        for i, node in enumerate(nodes):
            for ch in sorted(node.keys()):
                labels.append(ch)
                targets.append(node_ids[id(node[ch])])
            self.arc_start[i + 1] = len(labels)
        self.arc_label = np.array([ord(c) for c in labels], np.int32)
        self.arc_target = np.array(targets, np.int64)
        self.node_value = np.full(n, -1, np.int64)
        for nid, val in vals.items():
            self.node_value[nid] = val

    # ---------------- lookups -----------------------------------------
    def _step(self, node: int, ch: str) -> int:
        """Arc lookup: linear <= 8 arcs else binary (FstIndex.cs:457-496)."""
        s, e = int(self.arc_start[node]), int(self.arc_start[node + 1])
        cp = ord(ch)
        if e - s <= 8:
            for i in range(s, e):
                if self.arc_label[i] == cp:
                    return int(self.arc_target[i])
            return -1
        i = s + int(np.searchsorted(self.arc_label[s:e], cp))
        if i < e and self.arc_label[i] == cp:
            return int(self.arc_target[i])
        return -1

    def exact(self, term: str) -> int:
        """Ordinal of term, or -1 (FstIndex.cs:49-67)."""
        key = term[::-1] if self.reverse else term
        node = 0
        for ch in key:
            node = self._step(node, ch)
            if node < 0:
                return -1
        return int(self.node_value[node])

    def _collect(self, node: int, out: List[int], limit: int) -> None:
        stack = [node]
        while stack and len(out) < limit:
            cur = stack.pop()
            v = int(self.node_value[cur])
            if v >= 0:
                out.append(v)
            s, e = int(self.arc_start[cur]), int(self.arc_start[cur + 1])
            for i in range(e - 1, s - 1, -1):
                stack.append(int(self.arc_target[i]))

    def prefix_lookup(self, prefix: str, limit: int = 2**31 - 1) -> List[int]:
        """Ordinals of all terms starting with prefix (suffix when this is
        the reverse automaton; FstIndex.cs:78-193)."""
        key = prefix[::-1] if self.reverse else prefix
        node = 0
        for ch in key:
            node = self._step(node, ch)
            if node < 0:
                return []
        out: List[int] = []
        self._collect(node, out, limit)
        return out

    def prefix_count(self, prefix: str) -> int:
        return len(self.prefix_lookup(prefix))

    # ---------------- LD1 traversal ------------------------------------
    def within_edit_one(self, query: str, limit: int = 2**31 - 1) -> List[int]:
        """Ordinals of terms at Levenshtein distance <= 1 from query
        (FstIndex.cs:202-352; banded DP row instead of Myers masks)."""
        q = query[::-1] if self.reverse else query
        m = len(q)
        out: List[int] = []
        seen = set()
        first = np.arange(m + 1, dtype=np.int32)
        # iterative DFS with per-node DP row (band width 1)
        stack: List[Tuple[int, np.ndarray]] = [(0, first)]
        while stack and len(out) < limit:
            node, row = stack.pop()
            v = int(self.node_value[node])
            if v >= 0 and row[m] <= 1 and v not in seen:
                seen.add(v)
                out.append(v)
            if row.min() > 1:
                continue
            s, e = int(self.arc_start[node]), int(self.arc_start[node + 1])
            for i in range(s, e):
                ch = int(self.arc_label[i])
                new = np.empty(m + 1, np.int32)
                new[0] = row[0] + 1
                for j in range(1, m + 1):
                    cost = 0 if ord(q[j - 1]) == ch else 1
                    new[j] = min(row[j - 1] + cost, row[j] + 1, new[j - 1] + 1)
                if new.min() <= 1:
                    stack.append((int(self.arc_target[i]), new))
        return out

    # ---------------- enumeration --------------------------------------
    def enumerate_terms(self) -> Iterator[Tuple[str, int]]:
        """(term, ordinal) in label order (FstIndex.cs:626-697)."""
        stack: List[Tuple[int, str]] = [(0, "")]
        while stack:
            node, prefix = stack.pop()
            v = int(self.node_value[node])
            if v >= 0:
                yield (prefix[::-1] if self.reverse else prefix, v)
            s, e = int(self.arc_start[node]), int(self.arc_start[node + 1])
            for i in range(e - 1, s - 1, -1):
                stack.append((int(self.arc_target[i]),
                              prefix + chr(int(self.arc_label[i]))))
