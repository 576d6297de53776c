"""Lucene-style postings iterators over the three posting backends.

Behavioral reference: Infidex ``Indexing/PostingsEnum.cs`` (abstract
``NextDoc/Advance(target)/Freq/Cost``), ``ArrayPostingsEnum.cs`` (in-memory
lists), ``RoaringPostingsEnum.cs`` (fuzzy virtual terms, fixed Freq=1.0) and
``Segments/MMapBlockPostingsEnum.cs`` (block-decoded disk postings with a
skip table).

TPU note: the device Stage-1 never iterates — postings are flat CSR
tensors scored as one dense scatter (index/device.py). These enums are the
host-side capability: leapfrog intersections (candidates.py), diagnostics,
and parity tests against the reference's iterator semantics.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

NO_MORE_DOCS = 2**31 - 1


class PostingsEnum:
    """Iterator contract (PostingsEnum.cs): doc() is -1 before first
    next_doc(); NO_MORE_DOCS after exhaustion."""

    def doc(self) -> int:
        raise NotImplementedError

    def next_doc(self) -> int:
        raise NotImplementedError

    def advance(self, target: int) -> int:
        """First doc >= target (may be the current doc per Lucene rules)."""
        d = self.doc()
        while d < target:
            d = self.next_doc()
        return d

    def freq(self) -> float:
        raise NotImplementedError

    def cost(self) -> int:
        raise NotImplementedError


class ArrayPostingsEnum(PostingsEnum):
    """In-memory (docs, weights) arrays (ArrayPostingsEnum.cs)."""

    def __init__(self, docs: np.ndarray, weights: Optional[np.ndarray] = None):
        self._docs = np.asarray(docs)
        self._weights = weights
        self._i = -1

    def doc(self) -> int:
        if self._i < 0:
            return -1
        if self._i >= self._docs.size:
            return NO_MORE_DOCS
        return int(self._docs[self._i])

    def next_doc(self) -> int:
        self._i += 1
        return self.doc()

    def advance(self, target: int) -> int:
        # galloping via searchsorted (the reference uses binary search too)
        if self._i >= self._docs.size:
            return NO_MORE_DOCS
        j = int(np.searchsorted(self._docs, target, side="left"))
        self._i = max(j, self._i if self._i >= 0 else 0)
        return self.doc()

    def freq(self) -> float:
        if self._weights is None or self._i < 0 or self._i >= self._docs.size:
            return 1.0
        return float(self._weights[self._i])

    def cost(self) -> int:
        return int(self._docs.size)


class RoaringPostingsEnum(ArrayPostingsEnum):
    """Fuzzy virtual-term postings: union doc set, Freq fixed at 1.0
    (RoaringPostingsEnum.cs)."""

    def __init__(self, bitmap_or_docs):
        docs = (bitmap_or_docs.to_array()
                if hasattr(bitmap_or_docs, "to_array")
                else np.asarray(bitmap_or_docs))
        super().__init__(docs.astype(np.int64), None)

    def freq(self) -> float:
        return 1.0


class CSRPostingsEnum(ArrayPostingsEnum):
    """View over one term's slice of the unified CSR (BuiltIndex) — the
    analogue of MMapBlockPostingsEnum over the block skip table: the CSR
    row IS the fully-decoded block, so advance() is one binary search."""

    def __init__(self, built, term_id: int):
        s = built.term_offsets[term_id]
        e = built.term_offsets[term_id + 1]
        super().__init__(built.postings_docs[s:e],
                         built.postings_weights[s:e])
