"""What the port's own tracer shows of a benchmark cell, and what it costs.

    python3 scripts/trace_report.py [--cells C1,C2] [--seed N]
        [--seconds S] [--windows K] [--window-s W] [--device cuda|cpu]
        [--shrink] [--out DIR]

For each cell of BENCHMARK.json named (both by default) it makes one
traced run through ``benchmark/run.py``'s ``run_cell`` (its set-up, the
window under the profiler, the readers, the breakdown and the check),
keeping the run's record, and prints:

* the result line's per-layer metrics, ``correct`` and its ten longest
  idle gaps with the span each is named by;
* the root span's self time: the part of the roots that no child span on
  the same thread covers (batch cell: the ``pipeline.batch`` steps of
  each sub-batch; single cell: ``engine.search``), over the roots' time;
* self time by span name on the pipeline thread, and spans and counters
  a batch or a search.

Then, on the same engine, it serves ``--windows`` windows of
``--window-s`` seconds in turns with the tracer off and on (off, on, on,
off, ...) and prints each window's ``qps`` (batch) or p50 (single),
the process's CPU time a query and the garbage collector's passes by
generation.
First of all it times ``tracing.span`` with the tracer off and on (ns a
span, nested two deep as in the program, and ``tracing.count``) on this
host. Writes everything to DIR/trace_report.json.

``--shrink`` runs at the benchmark tests' tiny sizes (``--device cpu``
rehearses the script without a card).
"""

import argparse
import gc
import json
import os
import statistics
import sys
import time
from collections import Counter, defaultdict

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "benchmark", "tests"))

from benchmark import run  # noqa: E402
from benchmark.record import Record  # noqa: E402


def ns_per_span(tracing, n=200_000):
    """ns of one ``with span(...)`` (two deep: an outer and an inner),
    of one ``count``, off and on; the empty loop taken away."""
    def loop_empty():
        t = time.perf_counter()
        for _ in range(n):
            pass
        return time.perf_counter() - t

    def loop_spans():
        t = time.perf_counter()
        for _ in range(n):
            with tracing.span("cost.outer"):
                with tracing.span("cost.inner"):
                    pass
        return time.perf_counter() - t

    def loop_counts():
        t = time.perf_counter()
        for _ in range(n):
            tracing.count("cost.n")
        return time.perf_counter() - t

    out = {}
    for state in ("off", "on", "off", "on"):
        if state == "on":
            tracing.start()
        base = min(loop_empty() for _ in range(3))
        spans = min(loop_spans() for _ in range(3))
        counts = min(loop_counts() for _ in range(3))
        tracing.stop()
        out.setdefault(state, []).append(dict(
            span_ns=(spans - base) / (2 * n) * 1e9,
            count_ns=(counts - base) / n * 1e9))
    return {k: {m: statistics.median(r[m] for r in v) for m in v[0]}
            for k, v in out.items()}


def self_time(spans, roots):
    """(seconds in ``roots``, seconds of them no child on the same thread
    covers, self seconds by span name over every span given)."""
    kids = defaultdict(list)
    for s in spans:
        if s.parent_id is not None:
            kids[s.parent_id].append(s)
    by_name = Counter()
    for s in spans:
        ivs = sorted((max(c.start, s.start), min(c.end, s.end))
                     for c in kids[s.span_id] if c.thread_id == s.thread_id)
        covered, end = 0.0, s.start
        for a, b in ivs:
            a = max(a, end)
            if b > a:
                covered += b - a
                end = b
        by_name[s.name] += (s.end - s.start) - covered
        s_self = (s.end - s.start) - covered
        if s.span_id in roots:
            roots[s.span_id] = (s.end - s.start, s_self)
    total = sum(v[0] for v in roots.values())
    own = sum(v[1] for v in roots.values())
    return total, own, by_name


def report_cell(cell, args, tracing):
    made = []

    class Kept(Record):
        def __init__(self):
            super().__init__()
            made.append(self)

    kept = {}
    run.Record = Kept
    shrink = None
    if args.shrink:
        import helpers
        shrink = helpers.SHRINK
    t0 = time.perf_counter()
    res = run.run_cell(run.load_manifest(), cell, args.seed, args.seconds,
                       True, device=args.device, shrink=shrink,
                       tamper=lambda ctx: kept.update(ctx=ctx, eng=ctx.eng))
    run.Record = Record
    rec, = made
    snap = getattr(rec, "program_trace").snap
    lo, hi = rec.window
    spans = [s for s in snap.spans if lo <= s.start and s.end <= hi]
    batch = "batch" in cell
    root_name = "pipeline.batch" if batch else "engine.search"
    roots = {s.span_id: None for s in spans if s.name == root_name}
    total, own, by_name = self_time(spans, roots)
    main = [s for s in spans if s.thread_id == rec.main_thread]
    per = rec.batches if batch else rec.searches
    _, _, main_self = self_time(main, {})
    out = dict(
        cell=cell, seconds_total=time.perf_counter() - t0,
        correct=res["correct"], checks=res["checks"],
        metrics={k: v["value"] for k, v in res["metrics"].items()},
        device=res["device"], idle_gaps=res["breakdown"]["idle_gaps"],
        device_ops=res["breakdown"]["device_ops"],
        root=root_name, root_s=total, root_self_s=own,
        root_self_share=own / total if total else None,
        units=per, spans_per_unit=len(spans) / per if per else None,
        main_spans_per_unit=len(main) / per if per else None,
        self_ms_per_unit_main={
            k: v * 1e3 / per for k, v in main_self.most_common(25)},
        counters_per_unit={k: v / per for k, v in
                           sorted(snap.counters.items())},
        window_s=rec.window_s)
    return out, kept


def interleave(ctx, cell, args, tracing):
    from benchmark.entries import batch as batch_entry
    from benchmark.entries import single as single_entry

    entry = batch_entry if "batch" in cell else single_entry
    key = "qps" if "batch" in cell else "search_p50_ms"
    rows = []
    pattern = ["off", "on", "on", "off"]
    for k in range(args.windows):
        state = pattern[k % 4]
        gc0 = [g["collections"] for g in gc.get_stats()]
        cpu0 = time.process_time()
        if state == "on":
            tracing.start()
        w = entry.window(ctx, args.window_s, None)
        snap = tracing.stop()
        cpu = time.process_time() - cpu0
        gcs = [g["collections"] - c for g, c in zip(gc.get_stats(), gc0)]
        rows.append(dict(state=state, value=w["metrics"][key],
                         attempted=w["attempted"], spans=len(snap.spans),
                         cpu_ms_per_query=cpu * 1e3 / w["attempted"],
                         gc_collections=gcs))
        log(f"[interleave] {cell} {state}: {key} "
            f"{w['metrics'][key]:.3f}, {len(snap.spans)} spans, "
            f"{rows[-1]['cpu_ms_per_query']:.2f} ms CPU a query, "
            f"gc {gcs}")
    return dict(metric=key, windows=rows,
                median_off=statistics.median(
                    r["value"] for r in rows if r["state"] == "off"),
                median_on=statistics.median(
                    r["value"] for r in rows if r["state"] == "on"))


def log(msg):
    print(msg, file=sys.stderr, flush=True)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--cells", default="movies1m.batch-mixed,"
                    "movies1m.single-mixed")
    ap.add_argument("--seed", type=int, default=2147483917)
    ap.add_argument("--seconds", type=float, default=51)
    ap.add_argument("--windows", type=int, default=8)
    ap.add_argument("--window-s", type=float, default=12)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--shrink", action="store_true")
    ap.add_argument("--out", default="chiprun_out")
    args = ap.parse_args(argv)
    import torch

    if args.device == "cuda" and not torch.cuda.is_available():
        log("no CUDA card")
        return 2
    from infidex_tpu_torch import tracing

    report = dict(card=run.card_line() if args.device == "cuda" else "cpu",
                  cost=ns_per_span(tracing), cells=[])
    log(f"[cost] {json.dumps(report['cost'])}")
    for cell in args.cells.split(","):
        out, kept = report_cell(cell, args, tracing)
        log(f"[report] {json.dumps(out)}")
        if args.windows:
            out["interleave"] = interleave(kept["ctx"].__class__(
                **{**vars(kept["ctx"]), "eng": kept["eng"]}), cell, args,
                tracing)
        report["cells"].append(out)
        del kept
    os.makedirs(args.out, exist_ok=True)
    with open(os.path.join(args.out, "trace_report.json"), "w") as f:
        json.dump(report, f, indent=1)
    print(json.dumps(report))
    return 0


if __name__ == "__main__":
    sys.exit(main())
