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

from .. import queries as Q

#: queries drawn at a time from the timed stream
CHUNK = 256


def _search(ctx, text):
    return ctx.eng.search(ctx.it.Query(text, ctx.traffic["top"]))


def warm_up(ctx) -> list:
    tr = ctx.traffic
    for t in Q.make_queries(ctx.titles, tr["kinds"], tr["warmup_searches"],
                            ctx.rngs["warmup"]):
        _search(ctx, t)
    return []


def window(ctx, seconds: float, rec) -> dict:
    tr = ctx.traffic
    texts, answers, lat, failed = [], [], [], 0
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        for text in Q.make_queries(ctx.titles, tr["kinds"], CHUNK,
                                   ctx.rngs["timed"]):
            if rec is not None:
                rec.current = len(texts)
            start = time.perf_counter()
            try:
                res = _search(ctx, text)
            except Exception:      # a failed search counts failed
                traceback.print_exc(file=sys.stderr)
                res, failed = None, failed + 1
            end = time.perf_counter()
            texts.append(text)
            answers.append(res)
            lat.append(end - start)
            if end - t0 >= seconds:
                break
    t1 = time.perf_counter()
    if rec is not None:
        rec.current = None
        rec.searches = len(texts)
        rec.window = (t0, t1)
    p50, p95 = np.percentile(np.asarray(lat) * 1e3, [50, 95])
    return dict(metrics={"search_p50_ms": float(p50),
                         "search_p95_ms": float(p95)},
                attempted=len(texts), failed=failed, texts=texts,
                answers=answers,
                load={"searches": len(texts), "window_s": t1 - t0,
                      "mean_ms": (t1 - t0) * 1e3 / len(texts)})


def replay(ctx, texts):
    """``texts`` searched again, one after another."""
    return [_search(ctx, t) for t in texts]
