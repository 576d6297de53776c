"""The program's own spans and counters, for the per-layer readers.

The program (``infidex_tpu_torch.tracing``) records spans on
``time.perf_counter()``, the clock of this benchmark's own spans and of
the device trace once ``devtrace.py`` has moved it, so the three line up
as they are. ``install`` starts the program's tracer once a run, however
many readers ask; the first ``state`` after the window stops it, keeps
what it recorded and appends the program's spans to ``rec.spans`` with
their threads, so that ``devtrace.breakdown``, which runs after the
readers, names each idle gap by the innermost program span in flight.

Every reader returns None where the program records nothing of what it
reads: a program without the tracer, a window without such spans.
"""

from __future__ import annotations

from types import SimpleNamespace
from typing import Iterable, List, Optional

#: the attribute of the record that holds this module's state
KEY = "program_trace"


def install(ctx, rec) -> None:
    """Start the program's tracer and note the build's phases, once."""
    if getattr(rec, KEY, None) is not None:
        return
    try:
        from infidex_tpu_torch import tracing
    except ImportError:          # a program without its own tracer
        tracing = None
    stats = ctx.eng.get_statistics()
    build = getattr(stats, "build_seconds", None)
    setattr(rec, KEY, SimpleNamespace(tracing=tracing, snap=None,
                                      build=dict(build) if build else None))
    if tracing is not None:
        tracing.start()


def state(rec) -> Optional[SimpleNamespace]:
    """The run's program trace; the first call stops the tracer."""
    st = getattr(rec, KEY, None)
    if st is None:
        return None
    if st.snap is None and st.tracing is not None:
        st.snap = st.tracing.stop()
        rec.spans.extend((s.name, s.thread_id, s.start, s.end)
                         for s in st.snap.spans)
    return st


def spans(rec, names: Iterable[str], main_only: bool = False) -> List:
    """The program's spans of these names inside the window (on the
    pipeline thread alone with ``main_only``)."""
    st = state(rec)
    if st is None or st.snap is None:
        return []
    names = set(names)
    lo, hi = rec.window
    return [s for s in st.snap.spans
            if s.name in names and lo <= s.start and s.end <= hi
            and (not main_only or s.thread_id == rec.main_thread)]


def counter(rec, name: str) -> Optional[int]:
    """The program's counter ``name`` over the window; None without a
    tracer."""
    st = state(rec)
    if st is None or st.snap is None:
        return None
    return st.snap.counters.get(name, 0)


def span_ms(rec, names: Iterable[str], per: int,
            main_only: bool = False) -> Optional[float]:
    """Milliseconds in spans of these names, over ``per``; None where
    none was recorded or ``per`` is 0."""
    sel = spans(rec, names, main_only)
    if not sel or not per:
        return None
    return sum(s.end - s.start for s in sel) * 1e3 / per
