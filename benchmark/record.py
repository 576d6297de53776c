"""What a traced window leaves for the per-layer metric readers.

Spans are taken by the benchmark's own wrappers around the program's
callables (``wrap``), on the host clock (``time.perf_counter`` seconds),
with the thread that ran them. Kernel records come from the profiler
(``devtrace.py``), moved onto the same clock. Wrappers are put in place
only for the traced run and taken away after it (``restore``).
"""

from __future__ import annotations

import functools
import threading
import time
from collections import defaultdict
from typing import Callable, Dict, List, Optional, Tuple


class Record:
    def __init__(self):
        self.batches = 0          # batches the window served
        self.searches = 0         # single searches the window served
        self.window_metrics: Dict[str, float] = {}   # the entry's rates
        self.window = (0.0, 0.0)  # host clock seconds, first call to last
        self.counters: Dict[str, float] = {}   # program counters' deltas
        self.spans: List[Tuple[str, int, float, float]] = []
        self.kernels: List[Tuple[str, float, float]] = []   # host seconds
        self.calls: Dict[str, List[float]] = defaultdict(list)
        self.marked: Dict[str, set] = defaultdict(set)
        self.current: Optional[int] = None    # the search in flight
        self.main_thread = threading.get_ident()
        self.card = ""            # the card's name and power limit
        self._lock = threading.Lock()
        self._undo: List[Callable[[], None]] = []

    @property
    def window_s(self) -> float:
        return self.window[1] - self.window[0]

    def add_span(self, name: str, t0: float, t1: float) -> None:
        with self._lock:
            self.spans.append((name, threading.get_ident(), t0, t1))

    def wrap(self, owner, attr: str, name: str,
             on_call: Optional[Callable] = None) -> None:
        """Replace ``owner.attr`` by a wrapper that records a span
        ``name`` around each call and, with ``on_call``, calls
        ``on_call(self, *args, **kwargs)`` first. ``restore`` puts the
        original back (for an attribute set on an instance, by deleting
        it)."""
        had_own = attr in getattr(owner, "__dict__", {})
        orig = getattr(owner, attr)

        @functools.wraps(orig)
        def wrapper(*args, **kwargs):
            if on_call is not None:
                on_call(self, *args, **kwargs)
            t0 = time.perf_counter()
            try:
                return orig(*args, **kwargs)
            finally:
                self.add_span(name, t0, time.perf_counter())

        setattr(owner, attr, wrapper)
        if had_own:
            self._undo.append(lambda: setattr(owner, attr, orig))
        else:
            self._undo.append(lambda: delattr(owner, attr))

    def restore(self) -> None:
        while self._undo:
            self._undo.pop()()

    # -- readers' helpers -------------------------------------------------
    def span_s(self, *names: str) -> float:
        """Seconds spent in spans of these names, summed over threads."""
        return sum(t1 - t0 for n, _, t0, t1 in self.spans if n in names)

    def kernel_s(self, match: Callable[[str], bool]) -> Tuple[float, int]:
        """(seconds, records) of the kernels whose names ``match``."""
        sel = [t1 - t0 for n, t0, t1 in self.kernels if match(n)]
        return sum(sel), len(sel)

    def busy_s(self) -> float:
        """Seconds of the window in which some device operation ran."""
        lo, hi = self.window
        busy, end = 0.0, lo
        for _, t0, t1 in sorted(self.kernels, key=lambda k: k[1]):
            t0, t1 = max(t0, end), min(t1, hi)
            if t1 > t0:
                busy += t1 - t0
                end = t1
        return busy
