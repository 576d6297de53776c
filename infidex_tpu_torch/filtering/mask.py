"""Document filter masks and compiled-filter cache.

Behavioral reference: Infidex ``Filtering/FilterMask.cs`` (114 LoC) — a
BitArray over doc ids with boolean combinators — and
``Filtering/FilterCache.cs`` (176 LoC) — an LRU of compiled filters (the
live cache in the facade is a plain dict; this is the standalone
capability).

TPU note: a FilterMask converts for free into the device live-mask /
columnar-evaluation boolean vectors (np.ndarray of bool), which is how
query-time filtering actually runs on device.
"""

from __future__ import annotations

import threading
from collections import OrderedDict
from typing import Iterable, Optional

import numpy as np


class FilterMask:
    """Boolean doc mask with set algebra (FilterMask.cs)."""

    def __init__(self, size: int, fill: bool = False):
        self.bits = np.full(size, bool(fill), dtype=bool)

    @classmethod
    def from_ids(cls, size: int, ids: Iterable[int]) -> "FilterMask":
        m = cls(size)
        idx = np.fromiter(ids, dtype=np.int64)
        if idx.size:
            m.bits[idx] = True
        return m

    @property
    def size(self) -> int:
        return int(self.bits.size)

    def set(self, doc_id: int, value: bool = True) -> None:
        self.bits[doc_id] = value

    def get(self, doc_id: int) -> bool:
        return bool(self.bits[doc_id])

    def count(self) -> int:
        return int(self.bits.sum())

    def ids(self) -> np.ndarray:
        return np.nonzero(self.bits)[0]

    def and_(self, other: "FilterMask") -> "FilterMask":
        out = FilterMask(self.size)
        np.logical_and(self.bits, other.bits, out=out.bits)
        return out

    def or_(self, other: "FilterMask") -> "FilterMask":
        out = FilterMask(self.size)
        np.logical_or(self.bits, other.bits, out=out.bits)
        return out

    def and_not(self, other: "FilterMask") -> "FilterMask":
        out = FilterMask(self.size)
        np.logical_and(self.bits, ~other.bits, out=out.bits)
        return out

    def not_(self) -> "FilterMask":
        out = FilterMask(self.size)
        np.logical_not(self.bits, out=out.bits)
        return out


class FilterCache:
    """LRU cache of compiled filters keyed by filter identity
    (FilterCache.cs; the facade's live cache is a plain dict)."""

    def __init__(self, capacity: int = 256):
        self.capacity = capacity
        self._items: OrderedDict = OrderedDict()
        self._lock = threading.Lock()
        self.hits = 0
        self.misses = 0

    def get(self, key) -> Optional[object]:
        with self._lock:
            if key in self._items:
                self._items.move_to_end(key)
                self.hits += 1
                return self._items[key]
            self.misses += 1
            return None

    def put(self, key, compiled) -> None:
        with self._lock:
            self._items[key] = compiled
            self._items.move_to_end(key)
            while len(self._items) > self.capacity:
                self._items.popitem(last=False)

    def get_or_compile(self, key, compile_fn):
        cached = self.get(key)
        if cached is None:
            cached = compile_fn()
            self.put(key, cached)
        return cached

    def clear(self) -> None:
        with self._lock:
            self._items.clear()
