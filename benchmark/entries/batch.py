"""``SearchEngine.search_many`` from a backlog.

Every query is due when the window opens (an offered rate above what the
engine sustains). The caller sends ``call_batches`` batches of
``batch_size`` queries a call, with the engine's default pipeline depth,
call after call, and stops after the call that ends past ``seconds``:
the window runs from the first call to the end of the last, and ``qps``
is every query answered in it over its length.

Set-up warms up with ``warmup_calls`` calls from the warm-up stream: the
WordMatcher's and the conjunctive pool's memos fill over the first calls
(a call's rate rose from 63 to 216 queries/s over six calls on an H100)
and clear when full (8,192 entries).
"""

from __future__ import annotations

import sys
import time
import traceback

from .. import queries as Q


def _texts(ctx, rng_name: str):
    tr = ctx.traffic
    return Q.make_queries(ctx.titles, tr["kinds"],
                          tr["batch_size"] * tr["call_batches"],
                          ctx.rngs[rng_name])


def _serve(ctx, texts):
    tr = ctx.traffic
    return ctx.eng.search_many([ctx.it.Query(t, tr["top"]) for t in texts],
                               batch_size=tr["batch_size"])


def warm_up(ctx) -> list:
    """The warm-up calls' rates, queries/s."""
    rates = []
    for _ in range(ctx.traffic["warmup_calls"]):
        texts = _texts(ctx, "warmup")
        t0 = time.perf_counter()
        _serve(ctx, texts)
        rates.append(len(texts) / (time.perf_counter() - t0))
    return rates


def window(ctx, seconds: float, rec) -> dict:
    bs = ctx.traffic["batch_size"]
    texts, answers, failed = [], [], 0
    t0 = time.perf_counter()
    while True:
        chunk = _texts(ctx, "timed")
        try:
            res = _serve(ctx, chunk)
        except Exception:          # a failed call: its queries count failed
            traceback.print_exc(file=sys.stderr)
            res, failed = [None] * len(chunk), failed + len(chunk)
        texts += chunk
        answers += res
        if rec is not None:
            rec.batches += -(-len(chunk) // bs)
        if time.perf_counter() - t0 >= seconds:
            break
    t1 = time.perf_counter()
    if rec is not None:
        rec.window = (t0, t1)
    return dict(metrics={"qps": (len(texts) - failed) / (t1 - t0)},
                attempted=len(texts), failed=failed, texts=texts,
                answers=answers, load={"calls": len(texts) // len(chunk),
                                       "window_s": t1 - t0})


def replay(ctx, texts):
    """``texts`` served again through the window's call."""
    return _serve(ctx, texts)
