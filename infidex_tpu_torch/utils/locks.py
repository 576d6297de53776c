"""Reader/writer lock for the engine facade.

Behavioral reference: Infidex uses a ``ReaderWriterLockSlim`` at the facade
(SearchEngine.cs:33) — many concurrent readers, exclusive writers. Python's
GIL does not serialize the multi-step index mutations, so the same discipline
applies.
"""

from __future__ import annotations

import threading
from contextlib import contextmanager


class ReadWriteLock:
    """Many readers / one writer, WITH writer preference.

    A waiting writer blocks NEW readers (matching ReaderWriterLockSlim's
    queueing) — without this, a continuous stream of readers starves the
    writer forever (observed as a live-lock in search-during-index
    workloads: the indexer never acquires the write lock, so reader loops
    gated on its completion never terminate). Reads are re-entrant per
    thread so a reader is never blocked by a writer it would deadlock with.
    """

    def __init__(self) -> None:
        self._cond = threading.Condition()
        self._readers = 0
        self._writer = False
        self._writer_thread = None
        self._writers_waiting = 0
        self._local = threading.local()

    @contextmanager
    def read_lock(self):
        self.acquire_read()
        try:
            yield
        finally:
            self.release_read()

    @contextmanager
    def write_lock(self):
        self.acquire_write()
        try:
            yield
        finally:
            self.release_write()

    def acquire_read(self) -> None:
        held = getattr(self._local, "count", 0)
        with self._cond:
            # Re-entrant for the writer thread (mirrors RW-lock recursion).
            if self._writer and self._writer_thread == threading.current_thread():
                self._readers += 1
                self._local.count = held + 1
                return
            if held > 0:
                # Re-entrant read: never wait (a queued writer would
                # deadlock against our own outer read hold).
                self._readers += 1
                self._local.count = held + 1
                return
            while self._writer or self._writers_waiting > 0:
                self._cond.wait()
            self._readers += 1
            self._local.count = 1

    def release_read(self) -> None:
        with self._cond:
            self._readers -= 1
            self._local.count = getattr(self._local, "count", 1) - 1
            if self._readers == 0:
                self._cond.notify_all()

    def acquire_write(self) -> None:
        with self._cond:
            if self._writer and self._writer_thread == threading.current_thread():
                raise RuntimeError("write lock is not re-entrant")
            self._writers_waiting += 1
            try:
                while self._writer or self._readers > 0:
                    self._cond.wait()
            finally:
                self._writers_waiting -= 1
            self._writer = True
            self._writer_thread = threading.current_thread()

    def release_write(self) -> None:
        with self._cond:
            self._writer = False
            self._writer_thread = None
            self._cond.notify_all()
