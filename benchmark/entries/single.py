"""``SearchEngine.search``, one query at a time, in a closed loop.

One caller sends a search and waits for its result before it sends the
next (an application thread serving one user's search-as-you-type), until
the search that ends past ``seconds``. A search's latency is the host
clock around its ``search`` call; ``search_p50_ms`` and ``search_p95_ms``
are the median and the 95th percentile of every search in the window.
"""

from __future__ import annotations

import sys
import time
import traceback

import numpy as np

from . import make_query

#: queries drawn at a time from the timed stream
CHUNK = 256


def _search(ctx, spec):
    return ctx.eng.search(make_query(ctx.it, spec, ctx.traffic["top"]))


def warm_up(ctx) -> list:
    tr = ctx.traffic
    for s in ctx.gen.queries(ctx.made, tr, tr["warmup_searches"],
                             ctx.rngs["warmup"]):
        _search(ctx, s)
    return []


def window(ctx, seconds: float, rec) -> dict:
    tr = ctx.traffic
    specs, answers, lat, failed = [], [], [], 0
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        for spec in ctx.gen.queries(ctx.made, tr, CHUNK, ctx.rngs["timed"]):
            if rec is not None:
                rec.current = len(specs)
            start = time.perf_counter()
            try:
                res = _search(ctx, spec)
            except Exception:      # a failed search counts failed
                traceback.print_exc(file=sys.stderr)
                res, failed = None, failed + 1
            end = time.perf_counter()
            specs.append(spec)
            answers.append(res)
            lat.append(end - start)
            if end - t0 >= seconds:
                break
    t1 = time.perf_counter()
    if rec is not None:
        rec.current = None
        rec.searches = len(specs)
        rec.window = (t0, t1)
    p50, p95 = np.percentile(np.asarray(lat) * 1e3, [50, 95])
    return dict(metrics={"search_p50_ms": float(p50),
                         "search_p95_ms": float(p95)},
                attempted=len(specs), failed=failed, specs=specs,
                answers=answers, calls=[(i, i + 1) for i in range(len(specs))],
                load={"searches": len(specs), "window_s": t1 - t0,
                      "mean_ms": (t1 - t0) * 1e3 / len(specs)})


def replay(ctx, specs):
    """``specs`` searched again, one after another."""
    return [_search(ctx, s) for s in specs]
