"""Bidirectional synonym map with union-find canonicalization.

Behavioral reference: Infidex ``Synonyms/SynonymMap.cs`` — terms are
normalized to lowercase; canonical representative of each equivalence class
is the longer surface form (lexicographically smaller on ties);
``canonicalize_text`` rewrites every token to its canonical form, preserving
delimiters exactly. Applied both at index time and to queries.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Set


class SynonymMap:
    def __init__(self) -> None:
        self._synonyms: Dict[str, Set[str]] = {}
        self._parent: Dict[str, str] = {}
        # Bumped on every mutation: the append-only fast finalize keys
        # its derived-structure reuse on this (changed synonyms rewrite
        # canonicalized doc texts, which forces a full rebuild).
        self.mutation_epoch = 0

    def add_synonym(self, term1: str, term2: str) -> None:
        if not term1 or not term2 or term1.isspace() or term2.isspace():
            return
        term1 = term1.strip().lower()
        term2 = term2.strip().lower()
        if term1 == term2:
            return
        self.mutation_epoch += 1
        self._synonyms.setdefault(term1, set()).add(term2)
        self._synonyms.setdefault(term2, set()).add(term1)
        self._union(term1, term2)

    def add_synonym_group(self, *terms: str) -> None:
        if len(terms) < 2:
            return
        for i in range(len(terms)):
            for j in range(i + 1, len(terms)):
                self.add_synonym(terms[i], terms[j])

    def get_synonyms(self, term: str) -> Set[str]:
        if not term or term.isspace():
            return set()
        return self._synonyms.get(term.strip().lower(), set())

    def has_synonyms(self, term: str) -> bool:
        if not term or term.isspace():
            return False
        return term.strip().lower() in self._synonyms

    @property
    def count(self) -> int:
        return len(self._synonyms)

    def clear(self) -> None:
        self._synonyms.clear()
        self._parent.clear()
        self.mutation_epoch += 1

    @property
    def has_canonical_mappings(self) -> bool:
        return bool(self._parent)

    def get_canonical(self, term: str) -> str:
        if not term or term.isspace():
            return ""
        term = term.strip().lower()
        if term not in self._parent:
            return term
        return self._find(term)

    def canonicalize_text(self, text: str, delimiters: Sequence[str]) -> str:
        if not text or not delimiters or not self._parent:
            return text
        delims = set(delimiters)
        out: List[str] = []
        i, n = 0, len(text)
        while i < n:
            c = text[i]
            if c in delims:
                out.append(c)
                i += 1
                continue
            start = i
            while i < n and text[i] not in delims:
                i += 1
            out.append(self.get_canonical(text[start:i]))
        return "".join(out)

    # -- union-find ------------------------------------------------------
    def _find(self, term: str) -> str:
        parent = self._parent.setdefault(term, term)
        if parent != term:
            self._parent[term] = self._find(parent)
        return self._parent[term]

    def _union(self, term1: str, term2: str) -> None:
        self._parent.setdefault(term1, term1)
        self._parent.setdefault(term2, term2)
        root1, root2 = self._find(term1), self._find(term2)
        if root1 == root2:
            return
        # Longer form wins; lexicographically smaller wins ties.
        if len(root1) != len(root2):
            canonical = root1 if len(root1) >= len(root2) else root2
        else:
            canonical = root1 if root1 <= root2 else root2
        other = root2 if canonical == root1 else root1
        self._parent[other] = canonical

    def state_dict(self) -> dict:
        return {"synonyms": {k: sorted(v) for k, v in self._synonyms.items()},
                "parent": dict(self._parent)}

    def load_state_dict(self, state: dict) -> None:
        self._synonyms = {k: set(v) for k, v in state["synonyms"].items()}
        self._parent = dict(state["parent"])
