"""LRU cache for tokenization results.

Behavioral reference: Infidex ``Tokenization/TokenCache.cs`` (DORMANT in the
reference main path): caches (text -> token list) with LRU eviction and hit/
miss statistics; thread-safe.
"""

from __future__ import annotations

import threading
from collections import OrderedDict
from typing import Callable, List, Optional, Tuple


class TokenCache:
    def __init__(self, capacity: int = 10_000):
        self._capacity = capacity
        self._cache: "OrderedDict[str, list]" = OrderedDict()
        self._lock = threading.Lock()
        self.hits = 0
        self.misses = 0

    def get(self, text: str) -> Optional[list]:
        with self._lock:
            tokens = self._cache.get(text)
            if tokens is not None:
                self._cache.move_to_end(text)
                self.hits += 1
                return tokens
            self.misses += 1
            return None

    def put(self, text: str, tokens: list) -> None:
        with self._lock:
            if text in self._cache:
                self._cache.move_to_end(text)
            self._cache[text] = tokens
            while len(self._cache) > self._capacity:
                self._cache.popitem(last=False)

    def get_or_compute(self, text: str, compute: Callable[[str], list]) -> list:
        tokens = self.get(text)
        if tokens is None:
            tokens = compute(text)
            self.put(text, tokens)
        return tokens

    @property
    def hit_rate(self) -> float:
        total = self.hits + self.misses
        return self.hits / total if total else 0.0

    def __len__(self) -> int:
        with self._lock:
            return len(self._cache)

    def clear(self) -> None:
        with self._lock:
            self._cache.clear()
            self.hits = 0
            self.misses = 0
