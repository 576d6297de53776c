"""Spans and counters inside the port, off by default.

One in-process tracer for the whole package. ``start()`` turns it on;
``stop()`` turns it off and returns everything recorded since, as a
``Snapshot``; ``snapshot()`` copies what is recorded so far and keeps it.

A span is a named interval on ``time.perf_counter()`` (the clock the
benchmark's own spans and its device trace use), with an id, the id of
the span that caused it, a request id and the thread that ran it::

    with tracing.span("pipeline.coverage_begin"):
        ...

The parent is the innermost span open on the same thread. A job handed
to a worker thread is wrapped by ``bind`` when it is submitted, so its
span's parent is the submitting span. A span that opens a request (one
``SearchEngine.search`` call, one ``search_many`` sub-batch) is given
``request=tracing.request()``; every span under it carries that id.
Names are dotted ``layer.step``.

A span must close on the thread that opened it, and never stay open
across a ``yield``: the batch pipeline's generators interleave on one
thread.

Counters (``count(name, n)``) are sums kept under the same switch.

When the tracer is off, ``span`` returns one shared do-nothing context,
``count`` returns at once and ``bind`` returns its function: nothing is
allocated and no clock is read. Spans sit at per-query boundaries or
coarser, never in a per-candidate or per-chunk loop; per-job counts are
summed by the caller and added once a job.

``timed`` always times its block into a mapping (the index build's
phases, ``IndexStatistics.build_seconds``) and is a span as well when the
tracer is on.
"""

from __future__ import annotations

import itertools
import threading
import time
from typing import Callable, Dict, List, NamedTuple, Optional


class SpanRecord(NamedTuple):
    name: str
    span_id: int
    parent_id: Optional[int]
    request_id: Optional[int]
    thread_id: int
    start: float
    end: float


class Snapshot(NamedTuple):
    spans: List[SpanRecord]
    counters: Dict[str, int]


class _Recording:
    """What one ``start()`` .. ``stop()`` records: spans as plain tuples
    in ``SpanRecord`` order (made into records when read)."""

    def __init__(self):
        self.spans: List[tuple] = []
        self.counters: Dict[str, int] = {}
        self.lock = threading.Lock()


_recording: Optional[_Recording] = None
_ids = itertools.count(1)


class _Local(threading.local):
    """Per thread: the open spans, innermost last, and the thread's id."""

    def __init__(self):
        self.stack: list = []
        self.thread_id = threading.get_ident()


_local = _Local()


class _NoSpan:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NO_SPAN = _NoSpan()


class _Span:
    __slots__ = ("recording", "name", "span_id", "parent_id", "request_id",
                 "bound", "start")

    def __init__(self, recording: _Recording, name: str,
                 request_id: Optional[int] = None,
                 bound: Optional[tuple] = None):
        self.recording = recording
        self.name = name
        self.request_id = request_id
        #: (parent id, request id) captured by ``bind`` on another thread
        self.bound = bound

    def __enter__(self):
        stack = _local.stack
        if self.bound is not None:
            self.parent_id, inherited = self.bound
        elif stack:
            self.parent_id = stack[-1].span_id
            inherited = stack[-1].request_id
        else:
            self.parent_id = inherited = None
        if self.request_id is None:
            self.request_id = inherited
        self.span_id = next(_ids)
        stack.append(self)
        self.start = time.perf_counter()
        return self

    def __exit__(self, *exc):
        end = time.perf_counter()
        local = _local
        stack = local.stack
        if stack and stack[-1] is self:
            stack.pop()
        elif self in stack:
            stack.remove(self)
        # list.append is atomic; worker threads append beside the caller
        self.recording.spans.append((
            self.name, self.span_id, self.parent_id, self.request_id,
            local.thread_id, self.start, end))
        return False


def start() -> None:
    """Turn the tracer on with nothing recorded."""
    global _recording
    _recording = _Recording()


def stop() -> Snapshot:
    """Turn the tracer off; everything recorded since ``start()``."""
    global _recording
    recording, _recording = _recording, None
    return _copy(recording)


def snapshot() -> Snapshot:
    """What is recorded so far; recording goes on and nothing is cleared."""
    return _copy(_recording)


def _copy(recording: Optional[_Recording]) -> Snapshot:
    if recording is None:
        return Snapshot([], {})
    with recording.lock:
        spans, counters = list(recording.spans), dict(recording.counters)
    return Snapshot([SpanRecord._make(s) for s in spans], counters)


def enabled() -> bool:
    return _recording is not None


def span(name: str, request: Optional[int] = None):
    """A context that records a span ``name`` when the tracer is on."""
    recording = _recording
    if recording is None:
        return _NO_SPAN
    return _Span(recording, name, request)


def request() -> Optional[int]:
    """A fresh request id (None when the tracer is off)."""
    return next(_ids) if _recording is not None else None


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to counter ``name`` when the tracer is on."""
    recording = _recording
    if recording is None:
        return
    with recording.lock:
        recording.counters[name] = recording.counters.get(name, 0) + n


def bind(name: str, fn: Callable) -> Callable:
    """``fn`` for a worker thread: run under a span ``name`` whose parent
    and request are the span open on this thread now. ``fn`` itself when
    the tracer is off."""
    recording = _recording
    if recording is None:
        return fn
    stack = _local.stack
    parent = (stack[-1].span_id, stack[-1].request_id) if stack \
        else (None, None)

    def run(*args, **kwargs):
        with _Span(recording, name, bound=parent):
            return fn(*args, **kwargs)

    return run


class timed:
    """Time a block into ``sink[key]`` (seconds, added), always; a span
    ``name`` as well when the tracer is on."""

    __slots__ = ("name", "sink", "key", "t0", "ctx")

    def __init__(self, name: str, sink: Dict[str, float], key: str):
        self.name, self.sink, self.key = name, sink, key

    def __enter__(self):
        self.ctx = span(self.name)
        self.ctx.__enter__()
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.sink[self.key] = (self.sink.get(self.key, 0.0)
                               + time.perf_counter() - self.t0)
        return self.ctx.__exit__(*exc)
