"""Progress / cancellation / timeout monitor for long-running operations.

Behavioral reference: Infidex ``Api/ProcessMonitor.cs`` — progress events,
cooperative cancellation, timeout tracking and wait handles for observers.
"""

from __future__ import annotations

import threading
import time
from typing import Callable, List, Optional


class ProcessMonitor:
    def __init__(self, timeout_seconds: Optional[float] = None):
        self._lock = threading.Lock()
        self._progress = 0
        self._cancelled = threading.Event()
        self._completed = threading.Event()
        self._started_at: Optional[float] = None
        self._timeout = timeout_seconds
        self.progress_changed: List[Callable[[int], None]] = []
        self.completed_callbacks: List[Callable[[], None]] = []

    # -- lifecycle --------------------------------------------------------
    def start(self) -> None:
        with self._lock:
            self._started_at = time.monotonic()
            self._progress = 0
        self._cancelled.clear()
        self._completed.clear()

    def report_progress(self, percent: int) -> None:
        percent = max(0, min(100, int(percent)))
        with self._lock:
            if percent == self._progress:
                return
            self._progress = percent
        for cb in list(self.progress_changed):
            cb(percent)
        if percent >= 100:
            self.complete()

    def complete(self) -> None:
        if not self._completed.is_set():
            self._completed.set()
            for cb in list(self.completed_callbacks):
                cb()

    def cancel(self) -> None:
        self._cancelled.set()

    # -- state ------------------------------------------------------------
    @property
    def progress(self) -> int:
        with self._lock:
            return self._progress

    @property
    def is_cancelled(self) -> bool:
        return self._cancelled.is_set()

    @property
    def is_completed(self) -> bool:
        return self._completed.is_set()

    @property
    def elapsed_seconds(self) -> float:
        with self._lock:
            if self._started_at is None:
                return 0.0
            return time.monotonic() - self._started_at

    @property
    def timed_out(self) -> bool:
        if self._timeout is None:
            return False
        return self.elapsed_seconds > self._timeout

    def throw_if_cancelled(self) -> None:
        if self._cancelled.is_set():
            raise OperationCancelledError("operation was cancelled")
        if self.timed_out:
            raise TimeoutError("operation timed out")

    # -- waiting ----------------------------------------------------------
    def wait_for_completion(self, timeout: Optional[float] = None) -> bool:
        return self._completed.wait(timeout)

    def wait_for_cancellation(self, timeout: Optional[float] = None) -> bool:
        return self._cancelled.wait(timeout)


class OperationCancelledError(RuntimeError):
    pass
