#!/usr/bin/env python3
"""Smoke run of the PyTorch port (infidex_tpu_torch) on one CUDA card.

    python3 chip_smoke.py [--recall]

Run from the repository root. Phases, in order; any failure exits non-zero:

  0. Set-up: require CUDA; print the torch and CUDA versions and the card's
     name and power limit; build the hand-written kernels with nvcc and
     print the build seconds; require the host C++ library (native).
  1. Index bench.py's corpus at 1,000,000 docs on the card; print the
     build seconds and the resident device bytes.
  2. Kernel phase: the Stage-1 lane kernel against its plain PyTorch
     version on the chunk table of a real 128-query batch of that index.
     Bit equality and two identical kernel runs are required; both times
     come from CUDA events.
  3. Cross-device phase: the 3000-doc engine test's corpus and 64 queries,
     indexed and served once on the CPU and once on the card; ids and
     scores must be identical.
  4. Main path: ``search_batch`` on two batches of 128 bench queries and
     ``search_many`` over 256, with the kernels' launch counts reset just
     before and read just after; every kernel must have launched. Prints
     per-batch wall ms, queries per second, device calls, host fallbacks,
     peak device memory and the top hit of a typo query.
  5. ``--recall``: recall@10 against the depth oracle (bench.py's
     procedure, n=128), printed beside the reference's figure.

The line before the last is one JSON object describing each kernel; the
last line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

N_DOCS = 1_000_000
BATCH = 128
CROSS_DOCS, CROSS_QUERIES, CROSS_BATCH = 3000, 64, 32
#: recall@10 of the JAX reference at this workload (BENCH_r05.json)
REFERENCE_RECALL = 0.9766


class SmokeFailure(RuntimeError):
    pass


def check(cond, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def log(msg: str) -> None:
    print(msg, flush=True)


def nvidia_smi_line() -> str:
    res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    check(res.returncode == 0, f"nvidia-smi failed: {res.stderr.strip()}")
    return res.stdout.strip().splitlines()[0]


def cuda_ms(torch, fn, reps: int) -> float:
    """Mean device milliseconds of ``fn`` over ``reps`` back-to-back runs
    (CUDA events; one warm-up run first)."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def build_engine(it, titles):
    eng = it.SearchEngine.create_default()
    eng.index_documents([it.Document(i, t) for i, t in enumerate(titles)])
    return eng


def run_batches(it, eng, queries, batch):
    out = []
    for i in range(0, len(queries), batch):
        out += eng.search_batch([it.Query(q, 10)
                                 for q in queries[i:i + batch]])
    return out


def flatten(results):
    return [[(r.document_id, r.score) for r in res.records]
            for res in results]


def check_results(results, n_docs: int, what: str) -> int:
    """Ranked lists are well formed: finite scores, descending, ids in
    range. Returns how many queries found anything."""
    import math

    found = 0
    for res in results:
        recs = res.records
        found += bool(recs)
        check(len(recs) <= 10, f"{what}: more than 10 records")
        for r in recs:
            check(0 <= r.document_id < n_docs, f"{what}: id out of range")
            check(math.isfinite(r.score), f"{what}: non-finite score")
        check(all(a.score >= b.score for a, b in zip(recs, recs[1:])),
              f"{what}: records not in score order")
    return found


def resident_bytes(eng) -> int:
    """Bytes of the index state the card holds (Stage-1 CSR, per-posting
    factors, doc axis, coverage tables)."""
    import torch

    m = eng.vector_model
    tensors = [m.device.postings_docs, m.device.cfac, m.device.doc_lengths,
               m.device.live_mask]
    t = m.coverage_tables
    tensors += [v for v in vars(t).values() if isinstance(v, torch.Tensor)]
    return sum(x.numel() * x.element_size() for x in tensors)


def kernel_phase(torch, eng, queries, _kernels, lanes):
    """Lane kernel vs its plain version on a real batch's chunk table."""
    from infidex_tpu_torch.index.device import split_batch_by_lanes

    m = eng.vector_model
    dev_index = m.device
    preps = [m.prepare_stage1(q) for q in queries[:BATCH]]
    lo, hi = split_batch_by_lanes(dev_index.built, preps)[0]
    chunks = dev_index.stage1_chunks(preps[lo:hi])
    n_cells = (hi - lo) * dev_index.n_pad
    n_lanes = int((chunks.vend - chunks.vstart).sum())
    log(f"[kernel] group of {hi - lo} queries: {chunks.off.numel()} chunks "
        f"in {len(chunks.bounds) - 1} rank passes, {n_lanes} lanes, "
        f"score matrix {hi - lo} x {dev_index.n_pad}")
    check(n_lanes > 0, "kernel phase: the batch expands no lanes")
    docs, cfac = dev_index.postings_docs, dev_index.cfac

    def run(fn):
        s = torch.zeros(n_cells, dtype=torch.float32, device=docs.device)
        c = torch.zeros(n_cells, dtype=torch.float32, device=docs.device)
        fn(s, c, chunks, docs, cfac)
        return s, c

    plain = run(lanes.scatter_lanes_plain)
    n0 = _kernels.launch_counts["stage1_scatter_lanes"]
    k1 = run(lanes.scatter_lanes)
    k2 = run(lanes.scatter_lanes)
    torch.cuda.synchronize()
    check(_kernels.launch_counts["stage1_scatter_lanes"] - n0
          == 2 * (len(chunks.bounds) - 1), "kernel phase: launch count")

    def bits(t):
        return t.view(torch.int32)

    for name, a, b in (("scores", k1[0], plain[0]), ("cnt", k1[1], plain[1])):
        check(torch.equal(bits(a), bits(b)),
              f"kernel phase: {name} differ from the plain version")
    check(torch.equal(bits(k1[0]), bits(k2[0]))
          and torch.equal(bits(k1[1]), bits(k2[1])),
          "kernel phase: two kernel runs differ")
    err = max(float((k1[0] - plain[0]).abs().max()),
              float((k1[1] - plain[1]).abs().max()))
    check(int((plain[1] > 0).sum()) > 0, "kernel phase: nothing scattered")

    # Timing in turns (plain, kernel, kernel, plain) on one set of
    # accumulators; the scatter is in place, so values only grow.
    s, c = run(lanes.scatter_lanes_plain)
    times = {"plain": [], "cuda": []}
    for route in ("plain", "cuda", "cuda", "plain"):
        fn = (lanes.scatter_lanes_plain if route == "plain"
              else lanes.scatter_lanes)
        times[route].append(cuda_ms(
            torch, lambda: fn(s, c, chunks, docs, cfac), reps=10))
    ms = sum(times["cuda"]) / 2
    plain_ms = sum(times["plain"]) / 2
    gbps = n_lanes * 24 / (ms * 1e6)
    log(f"[kernel] bit-equal to the plain version, deterministic across "
        f"runs; kernel {ms:.4f} ms ({times['cuda']}), plain "
        f"{plain_ms:.4f} ms ({times['plain']}); {gbps:.1f} GB/s at 24 B "
        f"per lane (8 B read + 2 x 8 B read-modify-write)")
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, lanes=n_lanes)


def cross_device_phase(it, runtime, bench):
    """The same small corpus served on the CPU and on the card."""
    titles = bench.make_corpus(CROSS_DOCS)
    queries = bench.make_queries(titles, CROSS_QUERIES)
    out = {}
    for dev in ("cpu", "cuda"):
        runtime.set_device(dev)
        eng = build_engine(it, titles)
        res = run_batches(it, eng, queries, CROSS_BATCH)
        check(eng.vector_model.device.device.type == dev,
              f"cross-device: index not on {dev}")
        out[dev] = flatten(res)
    runtime.set_device("cuda")
    bad = [q for q, a, b in zip(queries, out["cpu"], out["cuda"]) if a != b]
    check(not bad, f"cross-device: {len(bad)} queries differ, e.g. {bad[:3]}")
    n_found = sum(bool(r) for r in out["cuda"])
    log(f"[cross] {CROSS_DOCS} docs, {len(queries)} queries: CPU and CUDA "
        f"identical (ids and f32 scores); {n_found} queries with hits")


def main_phase(torch, it, eng, queries, _kernels):
    """The slice's main path at 1M docs; returns the launch counts."""
    batches = [queries[i:i + BATCH] for i in (0, BATCH)]
    eng.serving_split(reset=True)
    pipe = eng._pipeline
    fallback0 = pipe.coverage_host_fallback_count
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _kernels.reset_launch_counts()
    walls, results = [], []
    for b in batches:
        t0 = time.perf_counter()
        results.append(eng.search_batch([it.Query(q, 10) for q in b]))
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    t0 = time.perf_counter()
    many = eng.search_many([it.Query(q, 10) for q in queries[:2 * BATCH]],
                           batch_size=BATCH)
    torch.cuda.synchronize()
    wall_many = time.perf_counter() - t0
    counts = dict(_kernels.launch_counts)
    split = eng.serving_split(reset=True)
    peak = torch.cuda.max_memory_allocated()

    for i, w in enumerate(walls):
        log(f"[main] search_batch {i + 1}: {len(batches[i])} queries in "
            f"{w * 1e3:.1f} ms wall, {len(batches[i]) / w:.1f} queries/s")
    log(f"[main] search_many: {2 * BATCH} queries in {wall_many * 1e3:.1f} "
        f"ms wall, {2 * BATCH / wall_many:.1f} queries/s")
    log(f"[main] kernel launches {counts}; device calls "
        f"{split['device_calls']}; device wait {split['device_wait_s']:.3f}"
        f" s; coverage host fallbacks "
        f"{pipe.coverage_host_fallback_count - fallback0}; peak device "
        f"memory {peak} B ({peak / 2**30:.2f} GiB)")
    for name, n in counts.items():
        check(n > 0, f"main path: kernel {name} never launched")
    flat = [r for b in results for r in b]
    found = check_results(flat, N_DOCS, "search_batch")
    check(found >= len(flat) * 0.9,
          f"main path: only {found}/{len(flat)} queries found anything")
    check_results(many, N_DOCS, "search_many")
    check(flatten(many) == flatten(flat),
          "main path: search_many differs from search_batch")
    log(f"[main] {found}/{len(flat)} queries with hits; search_many equals "
        f"search_batch on all {len(flat)} queries")
    (res,) = eng.search_batch([it.Query("shawshenk", 10)])
    check(res.records, "typo query: no hits")
    top = res.records[0]
    log(f"[main] top hit for 'shawshenk': doc {top.document_id} "
        f"({eng.get_document(top.document_id).indexed_text!r}, score "
        f"{top.score})")
    check(top.document_id == 0, "typo query: doc 0 is not the top hit")
    return counts


def recall_phase(it, eng, queries, bench):
    bench.BATCH = BATCH
    t0 = time.perf_counter()
    recall, n = bench._recall_at_10(eng, queries, it.Query, N_DOCS,
                                    sample=128)
    log(f"[recall] recall@10 = {recall:.4f} (n={n}) against the depth "
        f"oracle, {time.perf_counter() - t0:.1f} s; the JAX reference's "
        f"is {REFERENCE_RECALL} at this workload")
    return recall


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--recall", action="store_true",
                    help="also measure recall@10 against the depth oracle")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this check needs one "
              "CUDA card", file=sys.stderr)
        return 2
    root = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, root)
    import bench
    import infidex_tpu_torch as it
    from infidex_tpu_torch import native, runtime
    from infidex_tpu_torch.ops import _kernels
    from infidex_tpu_torch.ops import stage1_lanes as lanes

    card = nvidia_smi_line()
    log(f"[setup] python {sys.version.split()[0]}, torch {torch.__version__}"
        f", CUDA {torch.version.cuda}, {torch.cuda.device_count()} card(s)")
    log(f"[setup] card: {card}")
    runtime.set_device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    check(not torch.backends.cuda.matmul.allow_tf32
          and torch.get_float32_matmul_precision() == "highest",
          "f32 matmuls must run in full f32")
    build_s = _kernels.build(verbose=True)
    log(f"[setup] kernels built in {build_s:.2f} s "
        f"({_kernels.library_path()})")
    log(f"[setup] native.available = {native.available}")
    check(native.available, "the host C++ library (native) did not build")

    t0 = time.perf_counter()
    titles = bench.make_corpus(N_DOCS)
    queries = bench.make_queries(titles, 4 * BATCH)
    log(f"[index] corpus of {N_DOCS} docs made in "
        f"{time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    eng = build_engine(it, titles)
    torch.cuda.synchronize()
    log(f"[index] {N_DOCS} docs indexed in {time.perf_counter() - t0:.1f} s;"
        f" resident index state {resident_bytes(eng)} B, allocated "
        f"{torch.cuda.memory_allocated()} B")

    k = kernel_phase(torch, eng, queries, _kernels, lanes)
    cross_device_phase(it, runtime, bench)
    counts = main_phase(torch, it, eng, queries, _kernels)
    if args.recall:
        recall_phase(it, eng, queries, bench)

    print(json.dumps({"kernels": [{
        "name": "stage1_scatter_lanes", "route": "cuda",
        "source": "infidex_tpu_torch/csrc/stage1_lanes.cu",
        "replaces": "infidex_tpu/ops/stage1_lanes.py:184",
        "launches": counts["stage1_scatter_lanes"],
        "max_abs_err": k["max_abs_err"], "ms": k["ms"],
        "plain_ms": k["plain_ms"]}]}), flush=True)
    print(nvidia_smi_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
