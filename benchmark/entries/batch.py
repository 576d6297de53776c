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

from . import make_query


def _specs(ctx, rng_name: str):
    tr = ctx.traffic
    return ctx.gen.queries(ctx.made, tr, tr["batch_size"] * tr["call_batches"],
                           ctx.rngs[rng_name])


def _serve(ctx, specs):
    tr = ctx.traffic
    return ctx.eng.search_many(
        [make_query(ctx.it, s, tr["top"]) for s in specs],
        batch_size=tr["batch_size"])


def warm_up(ctx) -> list:
    """The warm-up calls' rates, queries/s."""
    rates = []
    for _ in range(ctx.traffic["warmup_calls"]):
        specs = _specs(ctx, "warmup")
        t0 = time.perf_counter()
        _serve(ctx, specs)
        rates.append(len(specs) / (time.perf_counter() - t0))
    return rates


def window(ctx, seconds: float, rec) -> dict:
    bs = ctx.traffic["batch_size"]
    specs, answers, calls, failed = [], [], [], 0
    t0 = time.perf_counter()
    while True:
        chunk = _specs(ctx, "timed")
        try:
            res = _serve(ctx, chunk)
        except Exception:          # a failed call: its queries count failed
            traceback.print_exc(file=sys.stderr)
            res, failed = [None] * len(chunk), failed + len(chunk)
        calls.append((len(specs), len(specs) + len(chunk)))
        specs += chunk
        answers += res
        if rec is not None:
            rec.batches += -(-len(chunk) // bs)
        if time.perf_counter() - t0 >= seconds:
            break
    t1 = time.perf_counter()
    if rec is not None:
        rec.window = (t0, t1)
    return dict(metrics={"qps": (len(specs) - failed) / (t1 - t0)},
                attempted=len(specs), failed=failed, specs=specs,
                answers=answers, calls=calls, load={"calls": len(calls),
                                       "window_s": t1 - t0})


def replay(ctx, specs):
    """``specs`` (one call of the window) served again through the
    window's call."""
    return _serve(ctx, specs)
