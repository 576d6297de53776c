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
     Bit equality, two identical kernel runs and one launch per group are
     required; both times come from CUDA events, beside the bound and one
     ``index_add_`` of the pre-expanded lanes ("scatter only").
  3. Cross-device phase: the 3000-doc engine test's corpus and 64 queries,
     indexed and served once on the CPU and once on the card; ids and
     scores must be identical.
     Single ``search`` calls are compared the same way.
  4. Main path: ``search_batch`` on two batches of 128 bench queries and
     ``search_many`` over 256, with the kernels' launch counts reset just
     before and read just after; the lane kernel must have launched.
     Prints per-batch wall ms, queries per second, device calls, host
     fallbacks, peak device memory and the top hit of a typo query.
  5. ``--recall``: recall@10 against the depth oracle (bench.py's
     procedure, n=128), printed beside the reference's figure.
  6. Single queries on the 1M-doc index: ``search`` over 64 bench
     queries one at a time (p50/p95 ms; the host Stage-1 route must be
     taken), ``search_async`` over the same 64 (results equal to
     ``search``'s), and the typo query.
  7. Large vocabulary: 1,000,000 titles built like bench.py's corpus from
     a 400,000-word list, whose vocabulary passes the engine's own
     signature-matcher threshold (no override). The signature-match
     kernel against its plain version on the unknown tokens of a real
     128-query batch (bit equality, two identical runs, CUDA-event times),
     then two 128-query batches served with the kernels' counts reset
     just before and read just after: the match kernel must have
     launched.
  8. Writes under readers on the large-vocabulary index: a writer thread
     adds 10,000 documents (two known words and a fresh one each) and
     finalizes after every 2,000, while the main thread serves prefix
     batches of 128; every finalize must take the in-place append route.
     Then typo queries for fresh words, a delete, and a 3000-doc append
     parity check (CPU against CUDA, append against a fresh build).
  9. Segments: ``flush(materialize=False)`` of the 1M-doc bench index;
     Stage 1 of phase 4's first batch streamed from the segment must equal
     the resident Stage 1 bit for bit; the batch is served by device
     streaming (ids counted against phase 4's) and a single query on the
     host route.
 10. Facets: 100,000 fielded docs (title; genre and year facetable) built
     with the port's classes, a 128-query batch with ``enable_facets``
     under ``INFIDEX_TPU_DEVICE_FACETS=1``: every device count matrix must
     equal ``facet_counts_batch_host`` on the same id lists, and the
     facets those of the host route.

At the end no loaded module and no native library may come from the JAX
package's directory. Each phase prints its seconds. The line before the
last is one JSON object describing each kernel (with its bound and
launches per batch); the line before it the card's name and power limit;
the last line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import argparse
import json
import os
import random
import subprocess
import sys
import tempfile
import threading
import time

N_DOCS = 1_000_000
BATCH = 128
CROSS_DOCS, CROSS_QUERIES, CROSS_BATCH = 3000, 64, 32
#: recall@10 of the JAX reference at this workload (BENCH_r05.json)
REFERENCE_RECALL = 0.9766
SINGLE_QUERIES = 64
#: word list of the large-vocabulary corpus (bench.py builds 50,000)
BIG_VOCAB_WORDS = 400_000
WRITES, WRITES_PER_FINALIZE = 10_000, 2_000
#: reader batches served while the writer runs, at most (the engine's lock
#: prefers writers; a reader batch holds the writer for its whole length)
READER_BATCHES_MAX = 12
PARITY_APPENDS, PARITY_FINALIZES = 200, 4
#: the fielded corpus of the facets phase
FACET_DOCS = 100_000
GENRES = ["Drama", "Comedy", "Action", "Horror", "Documentary", "Crime",
          "Animation", "Romance", "SciFi", "Thriller", "Western", "Musical"]


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


#: the card's published peaks (NVIDIA H100 SXM data sheet, dense, at its
#: 700 W limit): HBM bytes/s, f32 outside the tensor cores, int8 tensor ops
HBM_BYTES_S = 3.35e12
F32_PEAK = 67e12
INT8_PEAK = 1979e12


def bound_ms(nbytes: float, ops: float, peak: float):
    """(least ms, "bytes" or "operations"): the larger of the bytes over
    the memory rate and the operations over their peak rate."""
    t_bytes, t_ops = nbytes / HBM_BYTES_S * 1e3, ops / peak * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


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
    ranked = chunks.ranked()
    n_cells = (hi - lo) * dev_index.n_pad
    n_lanes = int((chunks.vend - chunks.vstart).sum())
    n_ranks = len(ranked.bounds) - 1
    log(f"[kernel] group of {hi - lo} queries: {chunks.off.numel()} chunks "
        f"in {n_ranks} term ranks, {n_lanes} lanes, score matrix "
        f"{hi - lo} x {dev_index.n_pad}")
    check(n_lanes > 0, "kernel phase: the batch expands no lanes")
    docs, cfac = dev_index.postings_docs, dev_index.cfac

    def run(fn, table):
        s = torch.zeros(n_cells, dtype=torch.float32, device=docs.device)
        c = torch.zeros(n_cells, dtype=torch.float32, device=docs.device)
        fn(s, c, table, docs, cfac)
        return s, c

    plain = run(lanes.scatter_lanes_plain, ranked)
    n0 = _kernels.launch_counts["stage1_scatter_lanes"]
    k1 = run(lanes.scatter_lanes, chunks)
    k2 = run(lanes.scatter_lanes, chunks)
    torch.cuda.synchronize()
    check(_kernels.launch_counts["stage1_scatter_lanes"] - n0 == 2,
          "kernel phase: not one launch per group")
    log(f"[kernel] one launch per group ({n_ranks} term ranks; the "
        f"earlier design launched once per rank)")

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
    cells = int((plain[1] > 0).sum())
    check(cells > 0, "kernel phase: nothing scattered")

    # Timing in turns (plain, kernel, kernel, plain) on one set of
    # accumulators; the scatter is in place, so values only grow.
    s, c = run(lanes.scatter_lanes_plain, ranked)
    times = {"plain": [], "cuda": []}
    for route in ("plain", "cuda", "cuda", "plain"):
        fn, table = ((lanes.scatter_lanes_plain, ranked) if route == "plain"
                     else (lanes.scatter_lanes, chunks))
        times[route].append(cuda_ms(
            torch, lambda: fn(s, c, table, docs, cfac), reps=10))
    ms = sum(times["cuda"]) / 2
    plain_ms = sum(times["plain"]) / 2
    # yardstick: one index_add_ of the pre-expanded lanes into the scores
    # (float atomics, cnt not updated): the scatter alone. Parked lanes
    # (outside a chunk's window) are dropped first: they all hit one cell
    keys, contrib = lanes.expand_lanes(
        chunks.off, chunks.vstart, chunks.vend, chunks.idf, chunks.base,
        docs, cfac, n_cells - 1)
    real = keys != n_cells - 1
    keys, contrib = keys[real].long(), contrib[real]
    check(keys.numel() == n_lanes, "kernel phase: expanded lane count")
    scatter_ms = cuda_ms(torch, lambda: s.index_add_(0, keys, contrib),
                         reps=10)
    # bound: each lane's doc and factor read once (8 B), each touched score
    # and count cell read once and written once (16 B)
    nbytes = 8 * n_lanes + 16 * cells
    bound = bound_ms(nbytes, 3 * n_lanes, F32_PEAK)
    log(f"[kernel] bit-equal to the plain version, deterministic across "
        f"runs; kernel {ms:.4f} ms ({times['cuda']}), plain "
        f"{plain_ms:.4f} ms ({times['plain']}); scatter only "
        f"(index_add_ of the pre-expanded lanes) {scatter_ms:.4f} ms; "
        f"bound {bound[0]:.4f} ms by {bound[1]} ({nbytes} B: {n_lanes} "
        f"lanes x 8 B + {cells} cells x 16 B), {bound[0] / ms:.1%} of it")
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, lanes=n_lanes,
                bound_ms=bound[0], bound_by=bound[1], scatter_ms=scatter_ms)


def cross_device_phase(it, runtime, bench):
    """The same small corpus served on the CPU and on the card, in batches
    and one query at a time."""
    titles = bench.make_corpus(CROSS_DOCS)
    queries = bench.make_queries(titles, CROSS_QUERIES)
    out, single = {}, {}
    for dev in ("cpu", "cuda"):
        runtime.set_device(dev)
        eng = build_engine(it, titles)
        res = run_batches(it, eng, queries, CROSS_BATCH)
        check(eng.vector_model.device.device.type == dev,
              f"cross-device: index not on {dev}")
        out[dev] = flatten(res)
        single[dev] = flatten([eng.search(it.Query(q, 10)) for q in queries])
    runtime.set_device("cuda")
    for what, got in (("search_batch", out), ("search", single)):
        bad = [q for q, a, b in zip(queries, got["cpu"], got["cuda"])
               if a != b]
        check(not bad, f"cross-device {what}: {len(bad)} queries differ, "
              f"e.g. {bad[:3]}")
    n_found = sum(bool(r) for r in out["cuda"])
    log(f"[cross] {CROSS_DOCS} docs, {len(queries)} queries: CPU and CUDA "
        f"identical (ids and f32 scores) in search_batch and in single "
        f"search; {n_found} queries with hits")


def main_phase(torch, it, eng, queries, _kernels):
    """The slice's main path at 1M docs; returns the launch counts and the
    first batch's results."""
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
    # the bench vocabulary (~65k terms) is below the signature-matcher
    # threshold: this path runs the lane kernel only (phase 7 runs both)
    check(counts["stage1_scatter_lanes"] > 0,
          "main path: the lane kernel never launched")
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
    return counts, results[0]


def recall_phase(it, eng, queries, bench):
    bench.BATCH = BATCH
    t0 = time.perf_counter()
    recall, n = bench._recall_at_10(eng, queries, it.Query, N_DOCS,
                                    sample=128)
    log(f"[recall] recall@10 = {recall:.4f} (n={n}) against the depth "
        f"oracle, {time.perf_counter() - t0:.1f} s; the JAX reference's "
        f"is {REFERENCE_RECALL} at this workload")
    return recall


def percentiles_ms(walls):
    import numpy as np

    p50, p95 = np.percentile(np.asarray(walls) * 1e3, [50, 95])
    return float(p50), float(p95)


def single_query_phase(it, eng, queries):
    """``search`` and ``search_async`` one query at a time on the 1M-doc
    index; single queries of few lanes take the host Stage-1 route."""
    m = eng.vector_model
    qs = queries[:SINGLE_QUERIES]
    host = []
    orig = m.host_stage1.search_batch
    m.host_stage1.search_batch = lambda *a, **k: host.append(1) or orig(
        *a, **k)
    try:
        walls, res = [], []
        for q in qs:
            t0 = time.perf_counter()
            res.append(eng.search(it.Query(q, 10)))
            walls.append(time.perf_counter() - t0)
    finally:
        del m.host_stage1.search_batch
    p50, p95 = percentiles_ms(walls)
    log(f"[single] search over {len(qs)} queries one at a time: p50 "
        f"{p50:.1f} ms, p95 {p95:.1f} ms; {len(host)} took the host "
        f"Stage-1 route")
    check(host, "single queries: the host Stage-1 route was never taken")
    found = check_results(res, N_DOCS, "search")
    check(found >= len(res) * 0.9,
          f"single queries: only {found}/{len(res)} found anything")
    t0 = time.perf_counter()
    asy = []
    for i in range(0, len(qs), 16):          # 16 in flight at a time
        futs = [eng.search_async(it.Query(q, 10)) for q in qs[i:i + 16]]
        asy += [f.result(timeout=600) for f in futs]
    log(f"[single] search_async over the same {len(qs)} queries (16 in "
        f"flight) in {time.perf_counter() - t0:.1f} s")
    check(flatten(asy) == flatten(res), "search_async differs from search")
    top = eng.search(it.Query("shawshenk", 10)).records
    check(top and top[0].document_id == 0,
          "single typo query: doc 0 is not the top hit")
    log(f"[single] search_async equals search on all {len(qs)} queries; "
        f"'shawshenk' -> doc 0 first")


def big_vocab_corpus(bench, n: int):
    """bench.make_corpus's recipe (Zipf weight 1/(rank+10), 2-5 words,
    titles[0] the Shawshank title) over a BIG_VOCAB_WORDS-word list."""
    import bisect

    rng = random.Random(1234)
    vocab = bench._make_vocab(rng, BIG_VOCAB_WORDS)
    weights = [1.0 / (r + 10.0) for r in range(len(vocab))]
    total = sum(weights)
    cum, acc = [], 0.0
    for w in weights:
        acc += w / total
        cum.append(acc)
    titles = []
    for _ in range(n):
        k = rng.randint(2, 5)
        titles.append(" ".join(vocab[bisect.bisect_left(cum, rng.random())]
                               for _ in range(k)).title())
    titles[0] = "The Shawshank Redemption"
    return titles, vocab


def big_vocab_phase(torch, it, bench, _kernels):
    """The signature matcher at a vocabulary past the engine's threshold:
    the kernel against its plain version, then two served batches."""
    from infidex_tpu_torch.ops import fuzzy

    t0 = time.perf_counter()
    titles, vocab = big_vocab_corpus(bench, N_DOCS)
    queries = bench.make_queries(titles, 2 * BATCH)
    log(f"[vocab] corpus of {N_DOCS} docs over a {len(vocab)}-word list "
        f"made in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    eng = build_engine(it, titles)
    m = eng.vector_model
    n_terms = len(m.built.terms)
    log(f"[vocab] indexed in {time.perf_counter() - t0:.1f} s: "
        f"{n_terms} terms (signature threshold "
        f"{m.SIGNATURE_VOCAB_THRESHOLD})")
    check(m._use_signature_index(),
          "large vocabulary: below the signature-matcher threshold")
    t0 = time.perf_counter()
    sig = m._ensure_sig_index()
    log(f"[vocab] signature index built in {time.perf_counter() - t0:.1f} "
        f"s: {sig.v} terms in {sig.v_pad} slots")

    # the unknown tokens of a real batch, as the pipeline collects them
    tokens = []
    m.prime_fuzzy_cache = tokens.extend
    try:
        eng._pipeline._prime_fuzzy_tokens(queries[:BATCH])
    finally:
        del m.prime_fuzzy_cache
    check(tokens, "large vocabulary: the batch has no unknown tokens")
    args = sig.match_args(tokens)
    plain = fuzzy.match_plain(*args)
    n0 = _kernels.launch_counts["fuzzy_match"]
    k1 = _kernels.fuzzy_match(*args)
    k2 = _kernels.fuzzy_match(*args)
    torch.cuda.synchronize()
    check(_kernels.launch_counts["fuzzy_match"] - n0 == 2,
          "match kernel phase: launch count")
    check(torch.equal(k1, plain), "match kernel differs from its plain "
          "version")
    check(torch.equal(k1, k2), "match kernel: two runs differ")
    err = float((k1.long() - plain.long()).abs().max())
    n_pass = int((k1 < sig.v_pad).sum())
    times = {"plain": [], "cuda": []}
    for route in ("plain", "cuda", "cuda", "plain"):
        fn = fuzzy.match_plain if route == "plain" else _kernels.fuzzy_match
        times[route].append(cuda_ms(torch, lambda: fn(*args), reps=10))
    ms, plain_ms = sum(times["cuda"]) / 2, sum(times["plain"]) / 2
    # bound: the vocabulary (16 + 4 + 4 + 1 B an id) and the token rows
    # (16 + 4 + 4 B) read once, the [T, cap] ids written once; operations:
    # the reference's int8 [T,128]x[128,V] product at the int8 peak
    n_rows, cap = args[4].shape[0], args[7]
    nbytes = 25 * sig.v_pad + 24 * n_rows + 4 * n_rows * cap
    bound = bound_ms(nbytes, 2 * n_rows * 128 * sig.v_pad, INT8_PEAK)
    log(f"[vocab] match kernel on {len(tokens)} unknown tokens "
        f"({n_rows} rows, cap {cap}, {sig.v_pad} slots, {n_pass} ids "
        f"out): bit-equal to the plain version, deterministic; kernel "
        f"{ms:.4f} ms ({times['cuda']}), plain {plain_ms:.4f} ms "
        f"({times['plain']}); bound {bound[0]:.4f} ms by {bound[1]} "
        f"({nbytes} B), {bound[0] / ms:.1%} of it")

    _kernels.reset_launch_counts()
    walls, results = [], []
    for i in (0, BATCH):
        t0 = time.perf_counter()
        results += eng.search_batch([it.Query(q, 10)
                                     for q in queries[i:i + BATCH]])
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    counts = dict(_kernels.launch_counts)
    log(f"[vocab] two search_batch of {BATCH}: "
        f"{[round(w * 1e3, 1) for w in walls]} ms wall; kernel launches "
        f"{counts}")
    check(counts["fuzzy_match"] > 0, "large vocabulary: the match kernel "
          "never launched")
    check(counts["stage1_scatter_lanes"] > 0, "large vocabulary: the lane "
          "kernel never launched")
    found = check_results(results, N_DOCS, "large-vocabulary batch")
    check(found >= len(results) * 0.9,
          f"large vocabulary: only {found}/{len(results)} found anything")
    (res,) = eng.search_batch([it.Query("shawshenk", 10)])
    check(res.records and res.records[0].document_id == 0,
          "large vocabulary: 'shawshenk' does not find doc 0 first")
    log(f"[vocab] {found}/{len(results)} queries with hits; 'shawshenk' -> "
        f"doc 0 first")
    return eng, titles, vocab, dict(max_abs_err=err, ms=ms,
                                    plain_ms=plain_ms, bound_ms=bound[0],
                                    bound_by=bound[1]), counts


def fresh_words(bench, vocab, n: int, seed: int):
    """``n`` distinct five-syllable words; the corpus' words have two to
    four syllables (or come from bench.py's English lists), so none is in
    the base vocabulary."""
    rng = random.Random(seed)
    known = set(vocab)
    out, seen = [], set()
    while len(out) < n:
        w = "".join(rng.choice(bench._SYLLABLES) for _ in range(5))
        if w not in known and w not in seen:
            seen.add(w)
            out.append(w)
    return out


def writes_phase(torch, it, bench, eng, titles, vocab):
    """A writer thread appends and finalizes while the main thread serves
    prefix batches; every finalize must extend the index in place."""
    m = eng.vector_model
    tables, sig = m.coverage_tables, m._sig_index
    log(f"[writes] headroom before the first finalize: signature "
        f"{sig.v_pad - sig.v} slots (APPEND_SLACK {sig.APPEND_SLACK}); "
        f"coverage docs {tables.overflow.shape[0] - tables.n_docs} rows, "
        f"words {tables.word_lens.shape[0] - tables.n_words} rows")
    rng = random.Random(7)
    words = fresh_words(bench, vocab, WRITES, seed=11)
    base = vocab[:20_000]               # the corpus' frequent words
    docs = [(N_DOCS + i, f"{rng.choice(base)} {rng.choice(base)} "
             f"{w}".title()) for i, w in enumerate(words)]
    prefixes = []
    for _ in range(4 * BATCH):          # bench_incremental's query recipe
        w = rng.choice(rng.choice(titles).lower().split())
        prefixes.append(w[: max(2, len(w) - rng.randrange(1, 4))])

    finalizes, errors = [], []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    def writer():
        try:
            for lo in range(0, WRITES, WRITES_PER_FINALIZE):
                for key, text in docs[lo:lo + WRITES_PER_FINALIZE]:
                    eng.index_document(it.Document(key, text))
                n0 = tables.n_docs
                t0 = time.perf_counter()
                eng.calculate_weights()
                torch.cuda.synchronize()
                finalizes.append(dict(
                    s=time.perf_counter() - t0,
                    same=(m.coverage_tables is tables
                          and m._sig_index is sig),
                    grew=tables.n_docs - n0,
                    allocated=torch.cuda.memory_allocated()))
        except Exception as e:  # reported and failed below
            errors.append(repr(e))

    t0 = time.perf_counter()
    th = threading.Thread(target=writer, name="chip-smoke-writer")
    th.start()
    walls, served = [], 0
    while th.is_alive() and served < READER_BATCHES_MAX:
        batch = [prefixes[(served * BATCH + j) % len(prefixes)]
                 for j in range(BATCH)]
        t1 = time.perf_counter()
        res = eng.search_batch([it.Query(q, 10) for q in batch])
        walls.append(time.perf_counter() - t1)
        check_results(res, N_DOCS + WRITES, "batch under writes")
        served += 1
    th.join(timeout=600)
    peak = torch.cuda.max_memory_allocated()
    check(not th.is_alive(), "writes: the writer did not finish")
    check(not errors, f"writes: the writer failed: {errors}")
    p50, _ = percentiles_ms(walls or [0.0])
    log(f"[writes] {WRITES} docs added in {len(finalizes)} finalizes "
        f"within {time.perf_counter() - t0:.1f} s; finalize seconds "
        f"{[round(f['s'], 2) for f in finalizes]}; allocated after each "
        f"{[f['allocated'] for f in finalizes]} B; peak device memory "
        f"{peak} B ({peak / 2**30:.2f} GiB)")
    log(f"[writes] readers served {served} prefix batches of {BATCH} "
        f"meanwhile (p50 {p50:.1f} ms wall)")
    check(len(finalizes) == WRITES // WRITES_PER_FINALIZE,
          "writes: wrong number of finalizes")
    check(all(f["same"] and f["grew"] == WRITES_PER_FINALIZE
              for f in finalizes),
          f"writes: a finalize left the append route: {finalizes}")
    # the DeviceIndex is rebuilt at each finalize: the old one must go
    check(finalizes[-1]["allocated"] - finalizes[0]["allocated"] < 2**30,
          "writes: device memory grows from finalize to finalize")

    sample = list(range(0, WRITES, WRITES // 16))
    trng = random.Random(3)
    res = eng.search_batch([it.Query(bench.typo(words[i], trng), 10)
                            for i in sample])
    bad = [words[i] for i, r in zip(sample, res)
           if not r.records or r.records[0].document_id != N_DOCS + i]
    check(not bad, f"writes: typo queries miss their new doc: {bad}")
    gone = N_DOCS + sample[1]
    eng.delete_documents(gone)
    res = eng.search(it.Query(words[sample[1]], 10))
    check(all(r.document_id != gone for r in res.records),
          "writes: a deleted doc is still returned")
    log(f"[writes] typo queries for {len(sample)} fresh words find their "
        f"new doc first; doc {gone} deleted and gone from the results")


def append_parity_phase(it, runtime, bench):
    """Appends on a small corpus with the signature matcher forced on
    (the instance threshold): CPU and CUDA identical, and each identical
    to a fresh build of the final corpus on the same device."""
    titles = bench.make_corpus(CROSS_DOCS)
    vocab = sorted({w for t in titles for w in t.lower().split()})
    rng = random.Random(5)
    adds = [f"{rng.choice(vocab)} {w}".title()
            for w in fresh_words(bench, vocab, PARITY_APPENDS, seed=13)]
    trng = random.Random(17)
    queries = bench.make_queries(titles, CROSS_QUERIES) + [
        bench.typo(t.split()[-1].lower(), trng) for t in adds[::10]]
    step = PARITY_APPENDS // PARITY_FINALIZES
    out = {}
    for dev in ("cpu", "cuda"):
        runtime.set_device(dev)
        eng = build_engine(it, titles)
        m = eng.vector_model
        m.SIGNATURE_VOCAB_THRESHOLD = 0
        run_batches(it, eng, queries[:CROSS_BATCH], CROSS_BATCH)
        tables, sig = m.coverage_tables, m._sig_index
        check(sig is not None, "append parity: no signature index")
        for lo in range(0, PARITY_APPENDS, step):
            for j in range(lo, lo + step):
                eng.index_document(it.Document(CROSS_DOCS + j, adds[j]))
            eng.calculate_weights()
            check(m.coverage_tables is tables and m._sig_index is sig,
                  f"append parity ({dev}): a finalize left the append route")
        fresh = build_engine(it, titles + adds)
        fresh.vector_model.SIGNATURE_VOCAB_THRESHOLD = 0
        out[dev] = flatten(run_batches(it, eng, queries, CROSS_BATCH))
        want = flatten(run_batches(it, fresh, queries, CROSS_BATCH))
        bad = [q for q, a, b in zip(queries, out[dev], want) if a != b]
        check(not bad, f"append parity ({dev}): {len(bad)} queries differ "
              f"from a fresh build, e.g. {bad[:3]}")
    runtime.set_device("cuda")
    bad = [q for q, a, b in zip(queries, out["cpu"], out["cuda"]) if a != b]
    check(not bad, f"append parity: CPU and CUDA differ on {len(bad)} "
          f"queries, e.g. {bad[:3]}")
    log(f"[writes] {CROSS_DOCS} docs + {PARITY_APPENDS} appended in "
        f"{PARITY_FINALIZES} finalizes: CPU and CUDA identical, and equal "
        f"to a fresh build on each, on {len(queries)} queries")


def segments_phase(torch, it, eng, queries, resident, _kernels, root):
    """flush(materialize=False), then device streaming and the host route
    from the segment.

    Stage 1 streamed from the segment must equal the resident Stage 1 bit
    for bit (scores, ids, LIM rows), as the reference's own test requires.
    Final ids are counted against phase 4's, not required equal: in mmap
    mode the reference's host candidate assembly reads the union CSR,
    whose flushed terms have empty ranges, and both packages return other
    lists for some multi-term prefix queries (ROADMAP §3)."""
    import numpy as np

    from infidex_tpu_torch.index.mmap_serving import MmapStage1

    m = eng.vector_model
    texts = queries[:BATCH]
    preps = [p for p in map(m.prepare_stage1, texts) if p is not None]
    s1_resident = m.device.search_batch(preps, 50)
    seg_dir = os.path.join(root, "build", "chip_smoke")
    os.makedirs(seg_dir, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=seg_dir) as tmp:
        path = os.path.join(tmp, "seg0.ifts")
        t0 = time.perf_counter()
        eng.flush(path, materialize=False)
        torch.cuda.synchronize()
        log(f"[segments] flush(materialize=False) of {N_DOCS} docs in "
            f"{time.perf_counter() - t0:.1f} s; segment "
            f"{os.path.getsize(path)} B; device memory allocated {torch.cuda.memory_allocated()} B")
        s1 = m._mmap_stage1
        check(m.mmap_serving and isinstance(s1, MmapStage1)
              and s1.device_stream, "segments: not in device-streaming mode")
        streamed, host = [], []
        s1._dispatch_group = (lambda *a, _f=s1._dispatch_group:
                              streamed.append(1) or _f(*a))
        s1._search_one = (lambda *a, _f=s1._search_one, **k:
                          host.append(1) or _f(*a, **k))
        preps_m = [p for p in map(m.prepare_stage1, texts) if p is not None]
        check(len(preps_m) == len(preps), "segments: other Stage-1 queries")
        s1_streamed = s1.search_batch(preps_m, 50)
        for a, b in zip(s1_streamed, s1_resident):
            check(np.array_equal(a[0].view(np.int32), b[0].view(np.int32))
                  and np.array_equal(a[1], b[1])
                  and np.array_equal(np.sort(a[2]), np.sort(b[2])),
                  "segments: streamed Stage 1 differs from resident")
        log(f"[segments] Stage 1 of {len(preps)} queries streamed from the "
            f"segment equals the resident Stage 1 bit for bit")

        _kernels.reset_launch_counts()
        n0 = len(streamed)
        t0 = time.perf_counter()
        res = eng.search_batch([it.Query(q, 10) for q in texts])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = dict(_kernels.launch_counts)
        check(len(streamed) > n0 and counts["stage1_scatter_lanes"] > 0,
              "segments: the batch did not stream through the lane kernel")
        found = check_results(res, N_DOCS, "segment batch")
        same = sum([r.document_id for r in a.records]
                   == [r.document_id for r in b.records]
                   for a, b in zip(res, resident))
        log(f"[segments] {BATCH} queries from the segment in "
            f"{wall * 1e3:.1f} ms wall, {len(streamed) - n0} streamed "
            f"groups, kernel launches {counts}; {found} with hits; ids "
            f"equal to phase 4's resident results on {same}/{len(res)}")
        check(found >= len(res) * 0.9,
              f"segments: only {found}/{len(res)} found anything")
        n1 = len(streamed)
        top = eng.search(it.Query("shawshenk", 10)).records
        check(host and len(streamed) == n1,
              "segments: the single query did not take the host route")
        check(top and top[0].document_id == 0,
              "segments: 'shawshenk' does not find doc 0 first")
        log("[segments] single 'shawshenk' on the host route -> doc 0 first")
    return counts


def facets_phase(torch, it, bench):
    """Batched facets on the card: a fielded corpus built with the port's
    classes, one batch with ``enable_facets`` under
    ``INFIDEX_TPU_DEVICE_FACETS=1``; every count matrix the device counter
    returns must equal ``facet_counts_batch_host`` on the same id lists,
    and the facets equal those of the host route."""
    import numpy as np

    from infidex_tpu_torch.ops import facets

    titles = bench.make_corpus(FACET_DOCS)
    queries = bench.make_queries(titles, BATCH)
    rng = random.Random(19)
    docs = []
    for i, title in enumerate(titles):
        f = it.DocumentFields()
        f.add_field("title", title, it.Weight.HIGH)
        f.add_field("genre", rng.choice(GENRES), indexable=False,
                    filterable=True, facetable=True)
        f.add_field("year", 1950 + rng.randrange(75), indexable=False,
                    filterable=True, facetable=True)
        docs.append(it.Document(i, f))
    eng = it.SearchEngine.create_default()
    t0 = time.perf_counter()
    eng.index_documents(docs)
    log(f"[facets] {FACET_DOCS} fielded docs (title; genre and year "
        f"facetable) indexed in {time.perf_counter() - t0:.1f} s")

    seen = []
    orig = facets.DeviceFacetCounter.counts

    def spy(self, name, codes, n_values, id_lists):
        out = orig(self, name, codes, n_values, id_lists)
        seen.append((name, codes, n_values, [np.array(a) for a in id_lists],
                     out, self._codes_dev[name].device))
        return out

    def batch(mode):
        qs = [it.Query(q, 10) for q in queries]
        for q in qs:
            q.enable_facets = True
        os.environ["INFIDEX_TPU_DEVICE_FACETS"] = mode
        try:
            t0 = time.perf_counter()
            res = eng.search_batch(qs)
            torch.cuda.synchronize()
            return res, time.perf_counter() - t0
        finally:
            del os.environ["INFIDEX_TPU_DEVICE_FACETS"]

    facets.DeviceFacetCounter.counts = spy
    try:
        res, wall = batch("1")
    finally:
        facets.DeviceFacetCounter.counts = orig
    check(seen, "facets: the device counter was never used")
    for name, codes, n_values, id_lists, out, dev in seen:
        check(dev.type == "cuda", f"facets: {name} codes not on the card")
        want = facets.facet_counts_batch_host(codes, n_values, id_lists)
        check(out.shape == want.shape and np.array_equal(out, want),
              f"facets: {name} counts differ from the host's")
    host, host_wall = batch("0")
    check([r.facets for r in res] == [r.facets for r in host],
          "facets: the device route's facets differ from the host route's")
    n_ids = sum(a.size for a in seen[0][3])
    with_facets = sum(bool(r.facets) for r in res)
    log(f"[facets] {BATCH} queries with enable_facets in {wall * 1e3:.1f} "
        f"ms wall (device counts; host route {host_wall * 1e3:.1f} ms): "
        f"{len(seen)} device count matrices ({', '.join(f'{n} {v} values' for n, _, v, *_ in seen)}) "
        f"over {n_ids} result ids, each equal to facet_counts_batch_host; "
        f"{with_facets} queries with facets, equal to the host route's")


def loaded_from(root: str):
    """Loaded modules, and native libraries, whose file lies under the
    JAX package's directory ``root``."""
    import infidex_tpu_torch.native as native

    bad = sorted(m for m, mod in list(sys.modules.items())
                 if os.path.abspath(getattr(mod, "__file__", None) or "")
                 .startswith(root))
    with open("/proc/self/maps") as maps:
        libs = {line.split()[-1] for line in maps if ".so" in line}
    libs.add(os.path.abspath(native._SO))
    return bad + sorted(f for f in libs if f.startswith(root))


T_START = time.perf_counter()


def timed(name: str, fn, *args):
    """Run one phase and print its seconds."""
    t0 = time.perf_counter()
    out = fn(*args)
    log(f"[phase {name}] {time.perf_counter() - t0:.1f} s")
    return out


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

    k = timed("2 kernel", kernel_phase, torch, eng, queries, _kernels, lanes)
    timed("3 cross-device", cross_device_phase, it, runtime, bench)
    counts, resident = timed("4 main", main_phase, torch, it, eng, queries,
                             _kernels)
    if args.recall:
        timed("5 recall", recall_phase, it, eng, queries, bench)
    timed("6 single queries", single_query_phase, it, eng, queries)
    big, big_titles, vocab, fk, vocab_counts = timed(
        "7 large vocabulary", big_vocab_phase, torch, it, bench, _kernels)
    timed("8 writes", writes_phase, torch, it, bench, big, big_titles, vocab)
    del big
    timed("8 append parity", append_parity_phase, it, runtime, bench)
    seg_counts = timed("9 segments", segments_phase, torch, it, eng,
                       queries, resident, _kernels, root)
    del eng
    timed("10 facets", facets_phase, torch, it, bench)
    log(f"[end] kernel launches by path: main {counts}, large vocabulary "
        f"{vocab_counts}, segments {seg_counts}; total "
        f"{time.perf_counter() - T_START:.1f} s")
    check("jax" not in sys.modules and not any(
        m.startswith(("jax.", "jaxlib", "infidex_tpu.")) for m in sys.modules),
        "the port imported jax or the reference package")
    ref_files = loaded_from(os.path.join(root, "infidex_tpu") + os.sep)
    check(not ref_files, f"loaded from the JAX package's directory: "
          f"{ref_files}")

    # the main path served 4 batches (2 search_batch, 2 in search_many);
    # the large-vocabulary path 2
    print(json.dumps({"kernels": [{
        "name": "stage1_scatter_lanes", "route": "cuda",
        "source": "infidex_tpu_torch/csrc/stage1_lanes.cu",
        "replaces": "infidex_tpu/ops/stage1_lanes.py:184",
        "launches": counts["stage1_scatter_lanes"],
        "launches_per_batch": counts["stage1_scatter_lanes"] / 4,
        "max_abs_err": k["max_abs_err"], "ms": k["ms"],
        "plain_ms": k["plain_ms"], "bound_ms": k["bound_ms"],
        "bound_by": k["bound_by"], "library_ms": None,
        "scatter_only_ms": k["scatter_ms"]}, {
        "name": "fuzzy_match", "route": "cuda",
        "source": "infidex_tpu_torch/csrc/fuzzy_match.cu",
        "replaces": "infidex_tpu/ops/fuzzy.py:59",
        "launches": vocab_counts["fuzzy_match"],
        "launches_per_batch": vocab_counts["fuzzy_match"] / 2,
        "max_abs_err": fk["max_abs_err"], "ms": fk["ms"],
        "plain_ms": fk["plain_ms"], "bound_ms": fk["bound_ms"],
        "bound_by": fk["bound_by"], "library_ms": None}]}), flush=True)
    print(nvidia_smi_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
