"""The device trace of a window: torch.profiler over CUDA activity.

The profiler's kernel times are put on the host clock by a marker: one
small kernel launched on an idle card right after the host clock was
read, the first device record of the session. ``breakdown`` gives the
device operations that took most time and the longest idle gaps, each
named by the host span in flight at its middle.
"""

from __future__ import annotations

import re
import sys
import time
from typing import Callable, List, Tuple

#: NVIDIA H100 SXM, HBM3 bytes/s (data sheet, at the 700 W limit)
HBM_BYTES_S = 3.35e12


def traced(torch, window: Callable[[], object], rec):
    """Run ``window()`` under the profiler; fill ``rec.kernels``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    pad = torch.zeros(1, device="cuda")
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t_mark = time.perf_counter()
        pad.add_(1)
        torch.cuda.synchronize()
        out = window()
        torch.cuda.synchronize()
    t_read = time.perf_counter()
    events = sorted(((e.name, e.time_range.start, e.time_range.end)
                     for e in prof.events()
                     if e.device_type == DeviceType.CUDA),
                    key=lambda e: e[1])
    if events:
        m0 = events[0][1]
        rec.kernels = [(kernel_name(n), t_mark + (s - m0) / 1e6,
                        t_mark + (e - m0) / 1e6) for n, s, e in events[1:]]
    print(f"[trace] {len(events)} device records read in "
          f"{time.perf_counter() - t_read:.1f} s", file=sys.stderr)
    return out


def kernel_name(name: str) -> str:
    """A device record's name without ``void`` and the arguments."""
    name = re.sub(r"^void ", "", name).replace("(anonymous namespace)::", "")
    return name.split("(")[0]


def short_name(name: str) -> str:
    """A kernel's name as ``kernel_name`` gives it, long templates cut."""
    if len(name) > 80:
        name = name.split("<")[0] + "<...>"
    return name


def breakdown(rec, top: int = 10) -> dict:
    lo, hi = rec.window
    by_op = {}
    for n, t0, t1 in rec.kernels:
        t0, t1 = max(t0, lo), min(t1, hi)
        if t1 > t0:
            k = short_name(n)
            by_op[k] = by_op.get(k, 0.0) + (t1 - t0)
    ops = sorted(by_op.items(), key=lambda kv: -kv[1])[:top]
    gaps: List[Tuple[float, float]] = []
    end = lo
    for _, t0, t1 in sorted(rec.kernels, key=lambda k: k[1]):
        if t0 > end:
            gaps.append((end, min(t0, hi)))
        end = max(end, t1)
        if end >= hi:
            break
    if end < hi:
        gaps.append((end, hi))
    gaps = sorted(gaps, key=lambda g: g[0] - g[1])[:top]
    return {"device_ops": [[k, v] for k, v in ops],
            "idle_gaps": [[host_doing(rec, (a + b) / 2), b - a]
                          for a, b in gaps]}


def host_doing(rec, t: float) -> str:
    """The innermost span of the main thread in flight at ``t``, and the
    other threads' spans in flight then."""
    main, other = None, set()
    for n, th, t0, t1 in rec.spans:
        if t0 <= t <= t1:
            if th == rec.main_thread:
                if main is None or t0 >= main[1]:
                    main = (n, t0)
            else:
                other.add(n)
    label = main[0] if main else "host (no span)"
    if other:
        label += " | threads: " + ",".join(sorted(other))
    return label
