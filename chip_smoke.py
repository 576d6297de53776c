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
     ``index_add_`` of the pre-expanded lanes ("scatter only"). Then one
     shard's doc window (the second of four) of the same group: kernel
     equal to plain, and equal to those columns of the full-window run.
     Then long titles (more than 16 words, words over 12 chars), which
     the bench corpus lacks: 200 of them served on the CPU and on the
     card (identical ids and scores), 20,000 on the card, whose coverage
     blocks are counted by shape (Q, L, D): the small, narrow and wide
     classes must all occur. Then the gather kernel (the block's rows of
     the query and doc tables), the pair kernel (word relations and edit
     distances in one packed word), the cascade kernel (the four
     matchers), the fake-LCS kernel and the fusion kernel (CoverageScorer,
     fusion signals, FusionScorer and the pack), each against its plain
     version on the first coverage block of every shape of a bench batch
     and of the long-title batches (the pair kernel per set of query
     tokens and for the block's two sets in one launch, as the main path
     calls it): every output equal (f32 bit for bit), two identical runs,
     one launch per call, the launch's blocks, threads a block (candidates
     a warp), registers and shared memory, as the profiler's trace
     recorded them, the kernel's device time
     (torch.profiler, one session per kernel and block) and its
     CUDA-event time per back-to-back call beside the bound and one run of
     the plain version in each of two turns. Then the four Stage-1
     epilogue kernels ("2 stage1 epilogue kernels": the fuzzy groups'
     presence bitset and df, the pass over [n_q, n_pad] that adds them and
     the live mask and takes the count row max, the exact stable top-k,
     the LIM rows), each against its plain version on the bench batch's
     first Stage-1 group (128 x 1,048,576; top-k at k 500 and 20,000),
     its first row and first 8 rows (a single query, a small group: the
     top-k and LIM kernels serve a row with a cluster of up to 16 blocks)
     and on a tie-heavy index (k 500 and 2,000): bit-equal, two identical
     runs, one launch per call, the device time (torch.profiler) beside
     the plain version's in turns, the bound, and the library call's time
     (``torch.topk`` over the int64 keys; the LIM's masked ``torch.topk``).
     Phase 7 does the same on its batch's first group, whose fuzzy groups
     come from the signature matcher.
  3. Cross-device phase: the 3000-doc engine test's corpus and 64 queries,
     indexed and served once on the CPU and once on the card; ids and
     scores must be identical. Single ``search`` calls are compared the
     same way; so are batches and single queries served by 4 shards on
     one device, and batches with device pool scoring
     (``POOL_DEVICE="1"``, every multi-term query on the tier path).
  4. Main path: ``search_batch`` on two batches of 128 bench queries and
     ``search_many`` over 256, with the kernels' launch counts reset just
     before and read just after; the lane kernel must have launched, the
     gather, pair, cascade, fake-LCS and fusion kernels once per coverage
     block (so on every other path that serves
     batches below: long titles, large vocabulary, segments, pool scoring
     and sharded, whose [3, C] layout has no fake-LCS), and the epilogue's
     pass, top-k and LIM kernels once per Stage-1 group (per shard on the
     sharded path, with two more top-k launches a group for the shards'
     merges), its fuzzy kernel once per group with fuzzy groups, and the
     top-k once more per pool-scored dispatch.
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
 11. Pool scoring (run after phase 6, on the 1M-doc index): phase 4's two
     batches served with ``POOL_DEVICE="1"`` (tier jobs counted; ids and
     scores equal to phase 4's; the pool kernel must have launched), then
     the kernel on real jobs (``prepare_stage1`` +
     ``TieredStage1.select_pool``, with ``TIER_LANE_BUDGET`` lowered
     inside the phase when the batches give fewer than 16): bit-equal to
     its plain version and to the native ``score_pool``, two identical
     runs, CUDA-event times beside the bound.
 12. Sharded serving: the same index served by a mesh of 4 shards on the
     one card, then by a one-shard mesh: two 128-query batches and 16
     single ``search`` calls each, identical between the meshes; one
     lane-kernel launch per shard per group, and two more top-k launches
     per group for the shards' score and LIM merges, which then equal the
     merges they replace on the first group's lists (top-k kernel device
     time beside ``torch.topk`` and the bound).
 13. The single-query device Stage 1 (run after phase 6, on the 1M-doc
     bench index): ``DeviceIndex.search`` over 64 bench queries at top
     500, each typo query's fuzzy groups materialised as extra postings
     (tests/test_search_batch.py's recipe over the terms' device ranges),
     with the kernels' counts reset just before and read just after: one
     lane launch a query with lanes, one extras launch (``stage1_extras``)
     a query with extras, one epilogue pass and one top-k launch each, and
     nothing else; host p50/p95 of a search and the device ms of one by
     kernel. Ids equal to ``search_batch``'s on the same preps, scores
     within rtol 1e-6 and bit-equal where a doc takes at most one extra.
     The extras kernel against its plain version on the largest extras
     set (its query's real row) and on 200,000 synthetic extras over
     60,000 docs: bit-equal, two identical runs, device ms beside the
     plain version's in turns, the bound and one ``index_add_``. The same
     searches on 4 shards of the card (``ShardedDeviceIndex.search``):
     bit-equal to the one-card route. A 20,000-doc corpus searched on the
     CPU and on the card: bit-equal.

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
#: shards of the sharded phases (on one card), single queries of phase 12
SHARDS, SHARD_SINGLES = 4, 16
#: pool jobs the pool-kernel check wants at least
POOL_JOBS_MIN = 16
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


def cuda_ms(torch, fn, reps: int, warm: bool = True) -> float:
    """Mean device milliseconds of ``fn`` over ``reps`` back-to-back runs
    (CUDA events; one warm-up run first unless ``warm`` is false: the
    caller has run ``fn`` already)."""
    if warm:
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


def device_ms_each(torch, fns, kernel: str, reps: int,
                   launches: list = None):
    """Mean device milliseconds of the kernel whose name contains
    ``kernel``, for each function of ``fns`` in turn, from torch.profiler
    sessions of its own: the kernel alone, where ``cuda_ms`` (events around
    back-to-back calls) also holds the wrapper's host time whenever that is
    the longer. Each function (run once before, and held by its caller to
    one launch a call) is run ``reps`` times a session, between two small
    torch kernels, so that neither end of the session's records is the
    kernel's. A session may drop records (on an H100 three sessions in a
    row have each kept 19 of 20, and three others none), never add one:
    sessions are taken until they have kept ``reps`` records together, at
    most sixteen, and the time is the mean over the kept records; a
    function whose sessions keep fewer, or a session that keeps more
    records than it made calls, fails the phase. With a list for
    ``launches``, each function's launch as the profiler's trace recorded
    it (grid, block, registers a thread, shared memory bytes; one for all
    its launches in all its sessions) is appended there."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    pad = torch.zeros(1, device="cuda")
    out = []
    for fn in fns:
        kept, seen, sessions = [], set(), 0
        while len(kept) < reps and sessions < 16:
            sessions += 1
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                pad.add_(1)
                for _ in range(reps):
                    fn()
                pad.add_(1)
                torch.cuda.synchronize()
            events = [e.time_range.elapsed_us() for e in prof.events()
                      if e.device_type == DeviceType.CUDA
                      and kernel in e.name]
            check(len(events) <= reps,
                  f"the profiler saw {len(events)} launches of {kernel} in "
                  f"a session of {reps} calls (block {len(out) + 1} of "
                  f"{len(fns)})")
            kept.extend(events)
            if launches is not None and events:
                seen |= traced_launches(prof, kernel)
        check(len(kept) >= reps,
              f"the profiler kept {len(kept)} of the {sessions * reps} "
              f"launches of {kernel} in {sessions} sessions (block "
              f"{len(out) + 1} of {len(fns)})")
        if sessions > 1:
            log(f"[profiler] {kernel}, block {len(out) + 1} of {len(fns)}: "
                f"{len(kept)} of {sessions * reps} launches kept in "
                f"{sessions} sessions")
        if launches is not None:
            check(len(seen) == 1, f"the launches of {kernel} in one block "
                  f"differ or have no trace record: {sorted(seen)}")
            launches.append(json.loads(seen.pop()))
        out.append(sum(kept) / len(kept) / 1e3)
    return out


def device_total_ms(torch, fn, reps: int):
    """(mean device ms, mean kernels) of all the kernels one call of ``fn``
    (run before) launches, from a torch.profiler session of ``reps``
    calls."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    events = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    return (sum(e.time_range.elapsed_us() for e in events) / reps / 1e3,
            len(events) / reps)


def traced_launches(prof, kernel: str) -> set:
    """The launches of the kernel whose name contains ``kernel`` in a
    finished torch.profiler session, from its trace's kernel records: the
    distinct (grid, block, registers a thread, shared memory bytes static
    and dynamic) as JSON strings."""
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            trace = json.load(f)
    out = set()
    for e in trace["traceEvents"]:
        if e.get("cat") == "kernel" and kernel in e.get("name", ""):
            launch = {k: e["args"].get(k) for k in (
                "grid", "block", "registers per thread", "shared memory")}
            check(all(launch[k] is not None for k in launch),
                  f"the profiler's trace has no launch geometry for "
                  f"{kernel}: {launch}")
            out.add(json.dumps(launch))
    return out


def geometry(launch: dict, n_c: int = 0) -> str:
    """A traced launch (``traced_launches``) in words; with n_c, the
    candidates a warp of a kernel over n_c candidates."""
    grid, threads = launch["grid"], launch["block"][0]
    blocks = grid[0] * grid[1] * grid[2]
    per_warp = (f"{n_c / (blocks * -(-threads // 32)):.3f} candidates a "
                f"warp, " if n_c else "")
    return (f"{list(grid)} blocks of {threads} threads, {per_warp}"
            f"{launch['registers per thread']} registers a thread, "
            f"{launch['shared memory']} B of shared memory a block, by the "
            f"profiler's trace")


#: the card's published peaks (NVIDIA H100 SXM data sheet, dense, at its
#: 700 W limit): HBM bytes/s, f32 outside the tensor cores, int8 tensor ops
HBM_BYTES_S = 3.35e12
F32_PEAK = 67e12
INT8_PEAK = 1979e12
#: int32 outside the tensor cores: an SM has half as many int32 lanes as
#: f32 lanes, and the f32 figure counts a fused multiply-add as two
INT32_PEAK = F32_PEAK / 4
#: integer operations the pair kernel's bound counts: per live cell for
#: the five rescues and for the relation bits read from the position
#: masks; per doc char of a live cell, besides one compare per query char,
#: for the position masks and the "contains" automaton, and with distances
#: for one step of the bit-parallel Levenshtein. The band count, kept
#: beside it: per band cell of a sweep step (compare, two adds, three mins,
#: the validity select, the clamp) in place of the bit-parallel step
EDIT_OPS_FIXED, PAIR_OPS_FIXED = 120, 80
PAIR_OPS_DOC_CHAR, LEV_OPS_DOC_CHAR, EDIT_OPS_BAND = 4, 15, 8
#: integer operations the cascade's bound counts per real (query token, doc
#: token) pair: each of the matchers' passes loads the pair's word, tests
#: its bits and compares two lengths
CASCADE_OPS_PAIR = 32
#: the long-title corpora: a small one served on both devices, a larger
#: one on the card
LONG_CROSS_DOCS, LONG_CROSS_QUERIES = 200, 8
LONG_DOCS = 20_000


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
    from infidex_tpu_torch.index.device import (prepare_batch_arrays,
                                                split_batch_by_lanes)

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

    # one shard's doc window of the same group: keys query * width +
    # (doc - doc_lo), lanes of other shards' docs skipped
    width = dev_index.n_pad // SHARDS
    doc_lo, doc_hi = width, 2 * width
    prep = prepare_batch_arrays(dev_index.built, preps[lo:hi])
    n_t = sum(len(q[0]) for q in preps[lo:hi])
    wchunks = lanes.build_query_chunks(*(a[:n_t] for a in prep[1:5]),
                                       hi - lo, width, docs.device)

    def run_window(fn, table):
        s = torch.zeros((hi - lo) * width, dtype=torch.float32,
                        device=docs.device)
        c = torch.zeros_like(s)
        fn(s, c, table, docs, cfac, doc_lo, doc_hi)
        return s, c

    n0 = _kernels.launch_counts["stage1_scatter_lanes"]
    wk = run_window(lanes.scatter_lanes, wchunks)
    wp = run_window(lanes.scatter_lanes_plain, wchunks.ranked())
    torch.cuda.synchronize()
    check(_kernels.launch_counts["stage1_scatter_lanes"] - n0 == 1,
          "kernel phase: not one launch per shard window")
    cols = [t.view(hi - lo, dev_index.n_pad)[:, doc_lo:doc_hi].contiguous()
            for t in k1]
    for name, a, b, c in (("scores", wk[0], wp[0], cols[0]),
                          ("cnt", wk[1], wp[1], cols[1])):
        check(torch.equal(bits(a), bits(b)),
              f"kernel phase: windowed {name} differ from the plain version")
        check(torch.equal(bits(a.view(hi - lo, width)), bits(c)),
              f"kernel phase: windowed {name} differ from the full run's "
              f"columns")
    wms = cuda_ms(torch, lambda: lanes.scatter_lanes(
        wk[0], wk[1], wchunks, docs, cfac, doc_lo, doc_hi), reps=10)
    log(f"[kernel] shard window [{doc_lo}, {doc_hi}) of the same group "
        f"({int((wp[1] > 0).sum())} cells): kernel bit-equal to the plain "
        f"version and to those columns of the full-window run; "
        f"{wms:.4f} ms")
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, lanes=n_lanes,
                bound_ms=bound[0], bound_by=bound[1], scatter_ms=scatter_ms)


class BlockSpy:
    """While active, records what the coverage program hands its kernels'
    dispatchers: per shape (Q, L, D) the arguments of the first block's
    gather, of its pair-block call, split as the pair kernel's calls for
    one set of query tokens (``pairs``: the Q tokens, with distances;
    ``fpairs``: the fusion signals' tokens, relations only, keyed by their
    own count), of its cascade, fake-LCS and fusion calls, and how many
    blocks ran per shape."""

    def __init__(self, ck):
        self.ck = ck
        self.pairs, self.fpairs, self.cascade, self.blocks = {}, {}, {}, {}
        self.pair_blocks = {}
        self.lcs, self.fusion, self.gather = {}, {}, {}
        self._block = threading.local()    # the shape of the block running

    def __enter__(self):
        ck = self.ck
        self._orig = (ck.gather_block, ck.coverage_pair_block,
                      ck.coverage_cascade, ck.coverage_lcs, ck.coverage_fusion)
        (orig_gather, orig_pairs, orig_cascade, orig_lcs,
         orig_fusion) = self._orig

        def gather_spy(*args):
            self.gather.setdefault((args[1][0].shape[1], args[4], args[5]),
                                   args)
            return orig_gather(*args)

        def pairs_spy(q_set, fq_set, *doc):
            shape = (q_set[0].shape[0], q_set[0].shape[1], doc[0].shape[1])
            self.pair_blocks.setdefault(shape, (q_set, fq_set) + doc)
            self.pairs.setdefault(shape, tuple(q_set) + doc)
            self.fpairs.setdefault((fq_set[0].shape[0],) + shape[1:],
                                   tuple(fq_set) + doc)
            return orig_pairs(q_set, fq_set, *doc)

        def cascade_spy(*args):
            shape = (args[0].shape[0], args[8].shape[1], args[0].shape[1])
            self._block.shape = shape
            self.cascade.setdefault(shape, args)
            self.blocks[shape] = self.blocks.get(shape, 0) + 1
            return orig_cascade(*args)

        def lcs_spy(*args):
            self.lcs.setdefault(self._block.shape, args)
            return orig_lcs(*args)

        def fusion_spy(*args, packed_lcs):
            shape = (args[1].shape[0], args[3][0].shape[0], args[1].shape[1])
            self.fusion.setdefault(shape, args + (packed_lcs,))
            return orig_fusion(*args, packed_lcs=packed_lcs)

        (ck.gather_block, ck.coverage_pair_block, ck.coverage_cascade,
         ck.coverage_lcs, ck.coverage_fusion) = (
            gather_spy, pairs_spy, cascade_spy, lcs_spy, fusion_spy)
        return self

    def __exit__(self, *exc):
        (self.ck.gather_block, self.ck.coverage_pair_block,
         self.ck.coverage_cascade, self.ck.coverage_lcs,
         self.ck.coverage_fusion) = self._orig


class BlockCount:
    """While active, counts the coverage program's row blocks (calls of
    ``_coverage_block``)."""

    def __init__(self, ck):
        self.ck, self.n = ck, 0

    def __enter__(self):
        self._orig = self.ck._coverage_block

        def count(*args, **kw):
            self.n += 1
            return self._orig(*args, **kw)

        self.ck._coverage_block = count
        return self

    def __exit__(self, *exc):
        self.ck._coverage_block = self._orig


def check_per_block(counts, n_blocks: int, what: str, lcs: bool = True):
    """One gather, pair, cascade and fusion launch per coverage block, and
    one fake-LCS launch where the layout has it (the sharded [3, C] layout
    has none)."""
    check(n_blocks > 0 and counts["coverage_gather"]
          == counts["coverage_pairs"] == counts["coverage_cascade"]
          == counts["coverage_fusion"] == n_blocks
          and counts["coverage_lcs"] == (n_blocks if lcs else 0),
          f"{what}: {counts} for {n_blocks} coverage blocks")


def first_block_args(torch, it, eng, queries):
    """The kernels' arguments in the first coverage block of each shape
    that one 128-query batch of ``eng`` runs."""
    from infidex_tpu_torch.ops import coverage_kernel as ck

    with BlockSpy(ck) as spy:
        eng.search_batch([it.Query(q, 10) for q in queries[:BATCH]])
        torch.cuda.synchronize()
    check(spy.cascade, "the batch ran no coverage block")
    return spy


def long_title_corpus(bench, n_docs: int, n_queries: int, seed: int = 77):
    """Titles that the bench corpus lacks: a fifth with 2-8 words, a third
    with 9-16, the rest with 17-40, over a 4,000-word list of 2-22 chars
    (bench.py's syllables), so that candidates fall into the small, narrow
    and wide shape classes. Returns the titles and two query lists taken
    from them, of 1-4 and of 5-8 words (the two widths of the query-token
    axis), some words with a typo, some last words cut to a prefix."""
    rng = random.Random(seed)
    vocab, seen = [], set()
    while len(vocab) < 4000:
        k = rng.choice((1, 2, 2, 3, 3, 4, 5, 6, 7))
        w = "".join(rng.choice(bench._SYLLABLES) for _ in range(k))[:22]
        if len(w) >= 2 and w not in seen:
            seen.add(w)
            vocab.append(w)
    titles = []
    for _ in range(n_docs):
        r = rng.random()
        n = (rng.randint(2, 8) if r < 0.2 else rng.randint(9, 16) if r < 0.55
             else rng.randint(17, 40))
        titles.append(" ".join(rng.choice(vocab) for _ in range(n)).title())
    queries = ([], [])
    for i in range(2 * n_queries):
        words = rng.choice(titles).lower().split()
        k = rng.choice((1, 2, 3, 4) if i % 2 == 0 else (5, 6, 8))
        start = rng.randrange(max(1, len(words) - k + 1))
        pick = [bench.typo(w, rng) if len(w) > 3 and rng.random() < 0.4 else w
                for w in words[start:start + k]]
        if rng.random() < 0.3:
            pick[-1] = pick[-1][:max(2, len(pick[-1]) - 2)]
        queries[i % 2].append(" ".join(pick))
    return titles, queries[0], queries[1]


def long_titles_phase(torch, it, runtime, bench, _kernels):
    """Narrow and wide coverage blocks through the engine: a small
    long-title corpus served on the CPU and on the card (identical ids and
    scores required), then a larger one on the card, whose blocks are
    counted by shape and whose first block of each shape gives the kernel
    phases their arguments."""
    from infidex_tpu_torch.ops import coverage_kernel as ck

    from infidex_tpu_torch.scoring import pipeline

    titles, short_q, long_q = long_title_corpus(bench, LONG_CROSS_DOCS,
                                                LONG_CROSS_QUERIES)
    out, shapes = {}, {}
    # a batch with this few candidates would run as one block of the widest
    # class present; without that floor it splits by class as a large one
    # does, and the plain versions stay affordable on the CPU
    chunk_min = pipeline.DEVICE_COVERAGE_CHUNK_MIN
    pipeline.DEVICE_COVERAGE_CHUNK_MIN = 256
    try:
        for dev in ("cpu", "cuda"):
            runtime.set_device(dev)
            eng = build_engine(it, titles)
            with BlockSpy(ck) as spy:
                t0 = time.perf_counter()
                out[dev] = flatten(
                    run_batches(it, eng, short_q, len(short_q))
                    + run_batches(it, eng, long_q, len(long_q)))
                wall = time.perf_counter() - t0
            shapes[dev] = dict(spy.blocks)
            log(f"[long titles] {LONG_CROSS_DOCS} docs, {len(short_q)} + "
                f"{len(long_q)} queries on {dev}: {wall:.1f} s; coverage "
                f"blocks by (Q, L, D): {sorted(spy.blocks.items())}")
    finally:
        pipeline.DEVICE_COVERAGE_CHUNK_MIN = chunk_min
        runtime.set_device("cuda")
    check(len(shapes["cuda"]) == 6,
          "long titles: the small corpus does not reach all six shapes")
    bad = [q for q, x, y in zip(short_q + long_q, out["cpu"], out["cuda"])
           if x != y]
    check(not bad, f"long titles: CPU and CUDA differ on {len(bad)} queries, "
          f"e.g. {bad[:3]}")
    check(shapes["cpu"] == shapes["cuda"],
          "long titles: other coverage blocks on the CPU than on the card")
    check(sum(bool(r) for r in out["cuda"]) >= 0.9 * len(out["cuda"]),
          "long titles: queries without hits")
    log(f"[long titles] CPU and CUDA identical (ids and f32 scores) on all "
        f"{len(out['cuda'])} queries")

    titles, short_q, long_q = long_title_corpus(bench, LONG_DOCS, BATCH,
                                                seed=78)
    t0 = time.perf_counter()
    eng = build_engine(it, titles)
    build_s = time.perf_counter() - t0
    _kernels.reset_launch_counts()
    with BlockSpy(ck) as spy, Stage1Count() as epi:
        walls, results = [], []
        for qs in (short_q, long_q):
            t0 = time.perf_counter()
            results += eng.search_batch([it.Query(q, 10) for q in qs])
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
    counts = dict(_kernels.launch_counts)
    n_blocks = sum(spy.blocks.values())
    found = check_results(results, LONG_DOCS, "long-title batch")
    log(f"[long titles] {LONG_DOCS} docs indexed in {build_s:.1f} s; two "
        f"batches of {BATCH} (1-4 and 5-8 query words) in "
        f"{[round(w * 1e3, 1) for w in walls]} ms wall; {found}/"
        f"{len(results)} with hits; {n_blocks} coverage blocks by (Q, L, D): "
        f"{sorted(spy.blocks.items())}; kernel launches {counts}")
    check(found >= len(results) * 0.9, "long titles: queries without hits")
    for d in (8, 16, 64):
        check(any(shape[2] == d for shape in spy.blocks),
              f"long titles: no coverage block of {d} doc tokens")
    check_per_block(counts, n_blocks, "long titles")
    epi.check(counts, "long titles")
    return spy, counts


def pair_bound(q_sets, doc, distances):
    """(bytes, integer operations, live cells, the band count's
    operations) the pair words of these inputs need: query token sets
    ``q_sets`` (each chars, reversed chars, lengths) over the doc rows
    ``doc`` (chars, reversed chars, lengths, validity), ``distances`` a
    flag per set. Bytes: the length tensors and the validity in full, of
    every word its chars plain and reversed (a word's length says that the
    rest of its row is zeros, so an empty or absent word costs no chars;
    the doc rows once), and one int32 per cell written. Operations: a cell
    with two non-empty words compares each of its doc word's stored chars
    with its query word's (min(q_len, L) each) and runs PAIR_OPS_DOC_CHAR
    more a doc char (masks, "contains"), LEV_OPS_DOC_CHAR with distances,
    compares the reversed words over the shorter (min(q_len, d_len, L)),
    then the relation bits (PAIR_OPS_FIXED) and the rescues
    (EDIT_OPS_FIXED). The band count (the one-thread-a-cell kernel's
    algorithm): masks and relations, the "contains" automaton over the doc
    word where that is at least as long (a compare per query char and
    three more per doc char) and a band of 7 over the doc word and one of
    5 over its prefix of q_len + 1 chars (EDIT_OPS_BAND each)."""
    _, _, lens, valid = doc
    n_l, n_d, n_c = doc[0].shape
    dl = lens[None].long()
    dn = dl.clamp(max=n_l)
    nbytes = 4 * (lens.numel() + 2 * int(dn.sum())) + valid.numel()
    ops = ops_band = n_live = 0
    for (_, _, qlens2), dist in zip(q_sets, distances):
        ql = qlens2[:, None, :].long()
        qn = ql.clamp(max=n_l)
        nbytes += 4 * (qlens2.numel() + 2 * int(qn.sum())
                       + qlens2.shape[0] * n_d * n_c)
        live = (ql > 0) & (dl > 0)
        n = int(live.sum())
        n_live += n
        per_char = qn + PAIR_OPS_DOC_CHAR + (LEV_OPS_DOC_CHAR if dist else 0)
        ops += n * (PAIR_OPS_FIXED + (EDIT_OPS_FIXED if dist else 0)) \
            + int((live * (dn * per_char + qn.minimum(dn))).sum())
        ops_band += n * PAIR_OPS_FIXED \
            + int((dn * (ql + 3) * (live & (ql <= dn))).sum())
        if dist:
            steps = 7 * dn + 5 * dn.minimum(ql + 1)
            ops_band += int((steps * live).sum()) * EDIT_OPS_BAND \
                + n * EDIT_OPS_FIXED
    return nbytes, ops, n_live, ops_band


def in_turns(torch, plain_fn, kernel_fn, reps: int):
    """(kernel ms, plain ms, the four turns' times): plain, kernel,
    kernel, plain. Both functions have run before; a plain turn is one run
    (thousands of launches each), a kernel turn ``reps`` runs."""
    times = {"plain": [], "cuda": []}
    for route in ("plain", "cuda", "cuda", "plain"):
        times[route].append(
            cuda_ms(torch, plain_fn, reps=1, warm=False) if route == "plain"
            else cuda_ms(torch, kernel_fn, reps=reps))
    return sum(times["cuda"]) / 2, sum(times["plain"]) / 2, times


def kernel_blocks(bench_spy, long_spy, which: str):
    """(label, origin, shape, args) of every block the two spies hold for
    ``which`` ("gather", "pairs", "fpairs", "cascade", "lcs" or "fusion"):
    the bench batch's, then the long-title batches'."""
    out = []
    for origin, spy in (("bench", bench_spy), ("long titles", long_spy)):
        for shape, args in sorted(getattr(spy, which).items()):
            out.append((f"{origin} {'x'.join(map(str, shape))}", origin,
                        shape, args))
    return out


def pair_phase(torch, bench_spy, long_spy, _kernels):
    """The pair kernel against its plain version on real coverage blocks:
    the first block of every shape of a bench batch and of the long-title
    batches, per set of query tokens (with distances: the coverage query
    tokens; without: the fusion query tokens) and for both sets in one
    launch, as the main path calls it ("block")."""
    from infidex_tpu_torch.ops import coverage_kernel as ck

    runs = []
    for which in ("pairs", "fpairs", "pair_blocks"):
        for label, origin, shape, args in kernel_blocks(bench_spy, long_spy,
                                                        which):
            if which == "pair_blocks":
                q_set, fq_set, *doc = args

                def kernel_fn(args=args):
                    return ck.coverage_pair_block(*args)

                def plain_fn(args=args):
                    return ck.coverage_pair_block_plain(*args)

                sets, dists, kind = (q_set, fq_set), (True, False), "block"
            else:
                distances = which == "pairs"
                doc = list(args[3:])

                def kernel_fn(args=args, distances=distances):
                    return ck.coverage_pairs(*args, distances=distances)

                def plain_fn(args=args, distances=distances):
                    return ck.coverage_pairs_plain(*args, distances)

                sets, dists = (args[:3],), (distances,)
                kind = "distances" if distances else "relations"
            plain = plain_fn()
            n0 = _kernels.launch_counts["coverage_pairs"]
            k1, k2 = kernel_fn(), kernel_fn()
            torch.cuda.synchronize()
            check(_kernels.launch_counts["coverage_pairs"] - n0 == 2,
                  "pair kernel phase: not one launch per call")
            outs = [(k1, k2, plain)] if kind != "block" else list(
                zip(k1, k2, plain))
            for a, b, want in outs:
                check(a.dtype == torch.int32 and a.shape == want.shape
                      and torch.equal(a, want),
                      f"pair kernel ({label}, {kind}): differs from the "
                      f"plain version")
                check(torch.equal(a, b),
                      f"pair kernel ({label}, {kind}): two runs differ")
            err = max(int((a - want).abs().max()) for a, _, want in outs)
            words = [a for a, _, _ in outs]
            del plain, k2, outs
            ms, plain_ms, times = in_turns(torch, plain_fn, kernel_fn,
                                           reps=20)
            runs.append((label, origin, shape, sets, doc, dists, kind,
                         kernel_fn, words, err, ms, plain_ms, times))
    launches = []
    dev = device_ms_each(torch, [r[7] for r in runs],
                         "coverage_pairs_kernel", reps=20, launches=launches)
    out = {}
    for (label, origin, shape, sets, doc, dists, kind, _, words, err, ms,
         plain_ms, times), dev_ms, launch in zip(runs, dev, launches):
        nbytes, ops, live, ops_band = pair_bound(sets, doc, dists)
        bound = bound_ms(nbytes, ops, INT32_PEAK)
        bound_band = bound_ms(nbytes, ops_band, INT32_PEAK)
        n_l, n_d, n_c = doc[0].shape
        cells = sum(w.numel() for w in words)
        related = sum(int(((w & 63) != 0).sum()) for w in words)
        near = sum(int((((w >> 16) & 7) <= 1).sum())
                   for w, dist in zip(words, dists) if dist)
        log(f"[kernel] pair words, {label}, {kind} ("
            f"{' + '.join(str(q[2].shape[0]) for q in sets)} query tokens, "
            f"L {n_l}, D {n_d}, C {n_c}: {cells} cells, {live} with two "
            f"non-empty words, {related} with a relation, {near} within "
            f"distance 1): bit-equal to the plain version, deterministic; "
            f"kernel {dev_ms:.4f} ms on the device (profiler; "
            f"{geometry(launch)}), {ms:.4f} ms a call back to back "
            f"(events: {times['cuda']}), plain {plain_ms:.4f} ms "
            f"({times['plain']}); bound {bound[0]:.4f} ms by {bound[1]} "
            f"({nbytes} B, {ops} integer operations), "
            f"{bound[0] / dev_ms:.1%} of the device time; the band count "
            f"{ops_band} operations: {bound_band[0]:.4f} ms, "
            f"{bound_band[0] / dev_ms:.1%}")
        check(live > 0 and related > 0 and (near > 0 or not any(dists)),
              f"pair kernel ({label}): the block exercises nothing")
        out[f"{label} {kind}"] = dict(
            max_abs_err=err, ms=ms, device_ms=dev_ms, plain_ms=plain_ms,
            bound_ms=bound[0], bound_by=bound[1], bound_bytes=nbytes,
            bound_ops=ops, bound_ms_band_count=bound_band[0],
            bound_ops_band_count=ops_band, origin=origin, shape=list(shape),
            candidates=n_c, cells=cells, live=live, launch=launch)
    return out


def gather_bound(args, got):
    """(bytes, bytes by input) the gather of these inputs must move: every
    output written once (``got``, the plain version's fields; first_char is
    a view of chars_t), and each input row it needs read once: the two ids
    of each candidate, the rows of each distinct query (Q and FQ slots of
    chars plain and reversed, lengths, the sorted order, the count), of
    each distinct doc (D codes, offsets and adjacency flags, the token
    count and text length), and the L chars (plain and reversed) and the
    length of each distinct word that a valid token names."""
    tables, queries, text_ids, qsel, n_l, n_d = args
    n_q, n_fq = queries[0].shape[1], queries[7].shape[1]
    n_c = text_ids.numel()
    words = got.codes[got.all_valid].unique().numel()
    reads = dict(
        ids=16 * n_c,
        queries=qsel.unique().numel() * 4 * (
            2 * n_q * n_l + 2 * n_q + 1 + 2 * n_fq * n_l + n_fq),
        docs=text_ids.unique().numel() * (9 * n_d + 8),
        words=words * 4 * (2 * n_l + 1))
    writes = sum(t.numel() * t.element_size() for t in got[:-1])
    return sum(reads.values()) + writes, dict(reads, outputs=writes)


def gather_phase(torch, bench_spy, long_spy, _kernels):
    """The gather kernel against the eager gather (its plain version) on
    the first coverage block of every shape of a bench batch and of the
    long-title batches: every field equal, dtype, shape and contiguity
    too."""
    from infidex_tpu_torch.ops import coverage_kernel as ck

    runs = []
    for label, origin, shape, args in kernel_blocks(bench_spy, long_spy,
                                                    "gather"):
        def kernel_fn(args=args):
            return ck.gather_block(*args)

        def plain_fn(args=args):
            return ck.gather_block_plain(*args)

        want = plain_fn()
        n0 = _kernels.launch_counts["coverage_gather"]
        k1, k2 = kernel_fn(), kernel_fn()
        torch.cuda.synchronize()
        check(_kernels.launch_counts["coverage_gather"] - n0 == 2,
              "gather kernel phase: not one launch per call")
        err = 0
        for name, a, b, c in zip(ck.GatheredBlock._fields, k1, k2, want):
            check(a.dtype == c.dtype and a.shape == c.shape
                  and a.is_contiguous() == c.is_contiguous()
                  and torch.equal(a, c),
                  f"gather kernel ({label}): {name} differs from the plain "
                  f"version")
            check(torch.equal(a, b),
                  f"gather kernel ({label}): two runs differ in {name}")
            if a.numel():
                err = max(err, int((a.long() - c.long()).abs().max()))
        ms, plain_ms, times = in_turns(torch, plain_fn, kernel_fn, reps=20)
        runs.append((label, origin, shape, args, kernel_fn, want, err, ms,
                     plain_ms, times))
    launches = []
    dev = device_ms_each(torch, [r[4] for r in runs],
                         "coverage_gather_kernel", reps=20,
                         launches=launches)
    out = {}
    for (label, origin, shape, args, _, want, err, ms, plain_ms,
         times), dev_ms, launch in zip(runs, dev, launches):
        nbytes, by_input = gather_bound(args, want)
        bound = bound_ms(nbytes, 0, INT32_PEAK)
        n_c = args[2].numel()
        log(f"[kernel] gather, {label} (Q, L, D {shape}, C {n_c}; "
            f"{int(want.all_valid.sum())} valid tokens; launched as "
            f"{geometry(launch)}): every field equal to the plain version, "
            f"deterministic; kernel {dev_ms:.4f} ms on the device "
            f"(profiler), {ms:.4f} ms a call back to back (events: "
            f"{times['cuda']}), eager gather {plain_ms:.4f} ms "
            f"({times['plain']}); bound {bound[0]:.4f} ms by {bound[1]} "
            f"({nbytes} B), {bound[0] / dev_ms:.1%} of the device time; "
            f"bound bytes by input {by_input}")
        check(int(want.all_valid.sum()) > 0,
              f"gather kernel ({label}): no valid token")
        out[label] = dict(max_abs_err=float(err), ms=ms, device_ms=dev_ms,
                          plain_ms=plain_ms, bound_ms=bound[0],
                          bound_by=bound[1], bound_bytes=nbytes,
                          bound_bytes_by_input=by_input, origin=origin,
                          shape=list(shape), candidates=n_c)
    return out


def cascade_bound(args):
    """(bytes, integer operations, needed pairs) the cascade of these
    inputs needs. Bytes: of each candidate the pair words of its real
    (query token, doc token) pairs, four ints per real doc token (length,
    offset, code, first char), three per real query token (length, sorted
    index, first char), its two counts; and every output written once
    (11 B per query-token slot, 8 B per candidate). Operations:
    CASCADE_OPS_PAIR per real pair (each of the matchers reads a pair's
    word and tests a few bits)."""
    pairs, tok_count, qcount = args[0], args[5], args[9]
    n_q, n_d, n_c = pairs.shape
    n_tok = tok_count.long().clamp(0, n_d)
    n_qt = qcount.long().clamp(0, n_q)
    n_pairs = int((n_tok * n_qt).sum())
    nbytes = 4 * (n_pairs + 4 * int(n_tok.sum()) + 3 * int(n_qt.sum())
                  + 2 * n_c) + 11 * n_q * n_c + 8 * n_c
    return nbytes, n_pairs * CASCADE_OPS_PAIR, n_pairs


def cascade_phase(torch, bench_spy, long_spy, _kernels):
    """The cascade kernel against its plain version on the same real
    coverage blocks."""
    from infidex_tpu_torch.ops import coverage_kernel as ck

    names = ("term_matched", "term_has_whole", "term_has_joined",
             "term_has_prefix", "term_first_pos", "word_hits", "cov_count")
    runs = []
    for label, origin, shape, args in kernel_blocks(bench_spy, long_spy,
                                                    "cascade"):
        def kernel_fn(args=args):
            return ck.coverage_cascade(*args)

        def plain_fn(args=args):
            return ck.coverage_cascade_plain(*args)

        plain = plain_fn()
        n0 = _kernels.launch_counts["coverage_cascade"]
        k1, k2 = kernel_fn(), kernel_fn()
        torch.cuda.synchronize()
        check(_kernels.launch_counts["coverage_cascade"] - n0 == 2,
              "cascade kernel phase: not one launch per call")
        err = 0.0
        for what, a, b, c in zip(names, k1, k2, plain):
            if what == "term_matched":       # f32: compared by its bits
                a, b, c = (t.view(torch.int32) for t in (a, b, c))
            elif what == "cov_count":        # the plain sum is int64
                c = c.to(a.dtype)
            check(a.dtype == c.dtype and a.shape == c.shape
                  and torch.equal(a, c),
                  f"cascade kernel ({label}): {what} differs from the plain "
                  f"version")
            check(torch.equal(a, b),
                  f"cascade kernel ({label}): two runs differ in {what}")
            err = max(err, float((a.double() - c.double()).abs().max()))
        ms, plain_ms, times = in_turns(torch, plain_fn, kernel_fn, reps=20)
        runs.append((label, origin, shape, args, kernel_fn, k1, err, ms,
                     plain_ms, times))
    launches = []
    dev = device_ms_each(torch, [r[4] for r in runs],
                         "coverage_cascade_kernel", reps=20,
                         launches=launches)
    out = {}
    for (label, origin, shape, args, _, k1, err, ms, plain_ms,
         times), dev_ms, launch in zip(runs, dev, launches):
        nbytes, ops, n_pairs = cascade_bound(args)
        bound = bound_ms(nbytes, ops, INT32_PEAK)
        n_q, n_l, n_d = shape
        n_c = args[0].shape[2]
        tm, whole, joined, prefix, _, hits, _ = k1
        log(f"[kernel] cascade, {label} (Q {n_q}, D {n_d}, C {n_c}; "
            f"{n_pairs} real pairs; {int(hits.sum())} word hits, "
            f"{int(whole.sum())} whole, {int(joined.sum())} joined, "
            f"{int((prefix & ~whole & ~joined).sum())} prefix, "
            f"{int(((tm > 0) & ~whole & ~joined & ~prefix).sum())} other "
            f"terms; launched as {geometry(launch, n_c)}): every output "
            f"equal to the plain version "
            f"(term_matched bit for bit), deterministic; kernel "
            f"{dev_ms:.4f} ms on the device (profiler), {ms:.4f} ms a call "
            f"back to back (events: {times['cuda']}), plain {plain_ms:.4f} "
            f"ms ({times['plain']}); bound {bound[0]:.4f} ms by {bound[1]} "
            f"({nbytes} B, {ops} integer operations), "
            f"{bound[0] / dev_ms:.1%} of the device time")
        check(int(hits.sum()) > 0, f"cascade kernel ({label}): no word hit")
        out[label] = dict(max_abs_err=err, ms=ms, device_ms=dev_ms,
                          plain_ms=plain_ms, bound_ms=bound[0],
                          bound_by=bound[1], bound_bytes=nbytes,
                          bound_ops=ops, origin=origin,
                          shape=list(shape), candidates=n_c,
                          real_pairs=n_pairs)
    return out


def lcs_bound(args):
    """(bytes, integer operations, eligible candidates, bytes by input)
    the fake-LCS of these inputs needs, each input read once. Bytes: per candidate its doc
    id and query index (int64), its doc's flag, its text length where it is
    eligible and its host value where not, and its result; per query row
    that a candidate with an eligible doc selects its flag, and per row of
    an eligible candidate its length and tolerance; per doc and per query
    row the chars that the compares of its eligible candidates reach: each
    offset's compare up to its first mismatch, the offsets up to the first
    containment, and the common prefix up to the char that ends it where
    there is none. Operations: one per char compared."""
    import numpy as np
    from numpy.lib.stride_tricks import sliding_window_view

    (text_chars, lcs_ok, q_text, q_text_len, _, q_ok, text_ids, qsel,
     text_len, _) = (a.cpu() for a in args)
    ids, sel = text_ids.long().numpy(), qsel.long().numpy()
    doc_ok = lcs_ok.numpy()[ids]
    eligible = doc_ok & q_ok.numpy()[sel]
    t_cap, qt_cap = text_chars.shape[1], q_text.shape[1]
    tl, ql = text_len.numpy(), q_text_len.numpy()[sel]
    rows, qrows = text_chars.numpy(), q_text.numpy()
    ops = 0
    text_read, query_read = {}, {}        # doc -> chars, query row -> chars
    for c in eligible.nonzero()[0]:
        d, b, t, q = int(ids[c]), int(sel[c]), int(tl[c]), int(ql[c])
        if t <= 0 or q <= 0:
            continue
        nq = min(q, qt_cap)
        o_end = min(t_cap, t - q + 1)     # offsets a containment may start at
        query = qrows[b, :nq]
        t_chars = q_chars = 0
        hit = False
        if o_end > 0:
            padded = np.concatenate([rows[d], np.zeros(nq, rows.dtype)])
            eq = sliding_window_view(padded, nq)[:o_end] == query
            whole = eq.all(1)
            if whole.any():
                hit = True
                eq = eq[:int(whole.argmax()) + 1]
            n_read = np.where(eq.all(1), nq, eq.argmin(1) + 1)
            ops += int(n_read.sum())
            t_chars = int((np.arange(len(n_read)) + n_read).max())
            q_chars = int(n_read.max())
        if not hit:
            n = min(qt_cap, q, t)
            neq = rows[d, :n] != query[:n]
            pre_read = int(neq.argmax()) + 1 if neq.any() else n
            ops += pre_read
            t_chars, q_chars = max(t_chars, pre_read), max(q_chars, pre_read)
        text_read[d] = max(text_read.get(d, 0), min(t_chars, t_cap))
        query_read[b] = max(query_read.get(b, 0), q_chars)
    by_input = {
        "per candidate": len(ids) * (8 + 8 + 1 + 4 + 4),
        "query rows": len(np.unique(sel[doc_ok]))
        + 8 * len(np.unique(sel[eligible])),
        "text chars": 4 * sum(text_read.values()),
        "query chars": 4 * sum(query_read.values())}
    return sum(by_input.values()), ops, int(eligible.sum()), by_input


#: operations the fusion kernel's bound counts per query slot of a real
#: query token (the scorer's f32 arithmetic, its flags and the dominance
#: pass) and per relation word read (a bit test and a branch); and one per
#: char compared
FUSION_OPS_SLOT, FUSION_OPS_WORD = 40, 2


def _upto_first(hit, mask, dim):
    """The elements of ``mask`` up to and including the first one along
    ``dim`` where ``hit`` holds: what a loop that stops at its first hit
    reads."""
    h = (hit & mask).int()
    return mask & (h.cumsum(dim) - h == 0)


def _first_false(eq, dim, none):
    """Index of the first false along ``dim``, ``none`` where all hold."""
    ne = ~eq
    return ne.int().argmax(dim).where(ne.any(dim), none)


def fusion_reads(args):
    """Bytes of each input that the scorer + fusion program of these
    inputs reads, each element once: what csrc/coverage_fusion_cell.cuh's
    loops reach before they stop on this data (the loops of the signals
    stop at their first hit), and of the scorer's inputs what the function
    needs (a query slot's state only for a real query token). Returns
    (dict of bytes by input, char compares, real query slots, relation
    words read)."""
    import torch

    (state, pairs, fq_pairs, doc, queries, qsel, lcs, _, config,
     packed) = args
    tm, hw, _, _, _, _, _ = (x.cpu() for x in state)
    w = fq_pairs.cpu()                                   # [FQ, D, C]
    p0 = pairs[0].cpu()
    chars, rev, lens, adj, valid, tok, _ = (x.cpu() for x in doc)
    (q_lens, q_idf, _, q_count, fq_chars, fq_rev, fq_lens, fq_count,
     last_alpha, _) = (x.cpu() for x in queries)
    sel = qsel.cpu().long()
    n_l, n_d, n_c = chars.shape
    n_q, n_fq = tm.shape[0], w.shape[0]
    d_i, f_i = torch.arange(n_d)[:, None], torch.arange(n_fq)[:, None]
    EQ, DSWQ, QSWD, DCONTQ = 1, 2, 32, 16
    bits = lambda b: (w & b) != 0

    # ---- CoverageScorer: a real token's slot, and the per-query rows
    qc = q_count[sel]
    ht = (torch.arange(n_q)[:, None] < qc[None]) & (q_lens[sel].T > 0)
    ci = torch.where(ht, torch.clamp_max(
        tm / torch.clamp_min(q_lens[sel].T.float(), 1.0), 1.0), 0.0)
    matched = (ht & (ci > 0)).sum(0)
    partial = (matched > 0) & (matched < qc)
    out = {"state": int((10 * ht + (ht & ~hw)).sum()),
           "scalars": n_c * (8 + 4 * 4) + 4 * int(partial.sum())
           + (4 * n_c if config.cover_whole_query or packed else 0),
           "result": 4 * n_c * (2 if packed else 3)}

    # ---- the fusion signals, loop by loop
    fqn = fq_count[sel]
    have = (fqn > 0) & (tok > 0)
    tokm = (d_i < tok.clamp(0, n_d)[None]) & have[None]          # [D, C]
    rowm = (f_i < fqn.clamp(0, n_fq)[None]) & have[None]         # [FQ, C]
    fql = fq_lens[sel].T                                        # [FQ, C]
    fqc = fq_chars[sel].permute(1, 2, 0)                        # [FQ, L, C]
    q0, q0_rev = fqc[0], fq_rev[sel].permute(1, 2, 0)[0]        # [L, C]
    last = fqn - 1
    last_ok = have & (last < n_fq)
    last_c = last.clamp(0, n_fq - 1)
    is_last = (f_i == last[None]) & last_ok[None]                # [FQ, C]
    last_len = torch.where(last_ok, fql.gather(0, last_c[None])[0], 0)
    single, multi = have & (fqn == 1), have & (fqn >= 2)
    read_w = torch.zeros(w.shape, dtype=torch.bool)
    read_valid = torch.zeros((n_d, n_c), dtype=torch.bool)
    read_lens = torch.zeros_like(read_valid)
    read_adj = torch.zeros_like(read_valid)
    chars_ext = torch.zeros((n_d, n_c), dtype=torch.long)       # chars read
    q0_ext = torch.zeros(n_c, dtype=torch.long)   # row 0 query chars read
    compares = 0

    # 1. prefix-last: one token, its row up to a doc word it starts; else
    # each row before the last up to an equal word while every earlier row
    # had one, and the last row up to a doc word it starts
    read_w[0] |= _upto_first(bits(DSWQ)[0], tokm & single[None], 0)
    before = (f_i < torch.minimum(fqn - 1, torch.tensor(n_fq))[None]) \
        & multi[None]
    row_eq = (bits(EQ) & tokm[None]).any(1) | ~before
    prior = torch.cat([torch.ones((1, n_c), dtype=torch.int32),
                       row_eq.int().cumprod(0)[:-1]]).bool()
    read_w |= _upto_first(bits(EQ), tokm[None] & (before & prior)[:, None],
                          1)
    read_w |= _upto_first(bits(DSWQ), tokm[None] & (is_last & multi[None])
                          [:, None], 1)
    # 2. perfect doc: tokens up to the first valid one no row explains,
    # each valid one's rows up to the first that does
    expl = bits(DSWQ | QSWD)
    explained = (expl & rowm[:, None]).any(0)
    seen = _upto_first(valid & ~explained, tokm, 0)
    read_valid |= seen
    read_w |= _upto_first(expl, rowm[:, None] & (seen & valid)[None], 0)
    # 3. stem evidence (two or more tokens): every word of the rows of long
    # enough tokens; validity and length up to each row's first evidence
    ms = config.min_word_size
    stem_rows = rowm & multi[None] & (fql >= ms)
    read_w |= stem_rows[:, None] & tokm[None]
    ev = (valid & (lens >= ms))[None] & (bits(QSWD) | (((w >> 8) & 31) >= ms))
    ev_seen = _upto_first(ev, stem_rows[:, None] & tokm[None], 1).any(0)
    read_valid |= ev_seen
    read_lens |= ev_seen & valid
    # 4. anchor stem: tokens up to the first whose first three chars are
    # the first token's, chars up to the first mismatch
    anchor = have & (fql[0] >= 3)
    read_lens[0] |= anchor
    same3 = chars[:3] == q0[:3][:, None]                         # [3, D, C]
    long3 = valid & (lens >= 3)
    a_seen = _upto_first(long3 & same3.all(0),
                         tokm & (anchor & (lens[0] >= 3))[None], 0)
    read_valid |= a_seen
    read_lens |= a_seen & valid
    a_ext = torch.where(a_seen & long3,
                        torch.clamp_max(_first_false(same3, 0, 3) + 1, 3), 0)
    chars_ext = torch.maximum(chars_ext, a_ext)
    q0_ext = torch.maximum(q0_ext, a_ext.amax(0))
    compares += int(a_ext.sum())
    # 5. trailing density: every word of the last row, the lengths where
    # the doc word does not start with it
    trail = tokm & (multi & (last_len >= 1) & (last_len <= 2))[None]
    read_w |= is_last[:, None] & trail[None]
    read_valid |= trail
    w_last = w.gather(0, last_c[None, None].expand(1, n_d, n_c))[0]
    read_lens |= trail & valid & ((w_last & DSWQ) == 0)
    # 6. single-term similarity: the slide over the query's shifts, each
    # compare up to its first mismatch, until neither result can change;
    # the distance where no shift holds the doc word; the two segments
    q_len = fql[0]
    sim = tokm & (single & (q_len >= 3))[None]
    read_valid |= sim
    read_lens |= sim
    live = sim & valid & (lens >= 2)
    found = torch.full((n_d, n_c), -1)
    best_k = torch.zeros((n_d, n_c), dtype=torch.long)
    stopped = ~live
    q0_slide = torch.zeros((n_d, n_c), dtype=torch.long)
    for s in range(n_l):
        k = (q_len - s)[None]
        stopped |= (((found >= 0) | (s + lens > q_len[None]))
                    & ((best_k > 0) | (k < 2)))
        go = ~stopped
        shifted = torch.zeros_like(q0)
        shifted[:n_l - s] = q0[s:]
        m = _first_false(shifted[:, None] == chars, 0, n_l)
        n_read = torch.where(go, torch.clamp_max(m, n_l - 1) + 1, 0)
        compares += int(n_read.sum())
        chars_ext = torch.maximum(chars_ext, n_read)
        q0_slide = torch.maximum(
            q0_slide, torch.where(go, torch.clamp_max(s + n_read, n_l), 0))
        found = torch.where(go & (found < 0) & (m >= lens.clamp_max(n_l))
                            & (s + lens <= q_len[None]), s, found)
        best_k = torch.where(go & (best_k == 0) & (k >= 2)
                             & (k <= torch.minimum(q_len[None], lens))
                             & (m >= k), k, best_k)
    q0_ext = torch.maximum(q0_ext, q0_slide.amax(0))
    read_p0 = live & (found < 0)
    seg = torch.clamp_max(q_len // 2, 6)
    two = sim & valid & (lens >= 3) & (q_len >= 6)[None]
    m3 = torch.minimum(torch.minimum(seg[None], lens), torch.tensor(n_l))
    pre = torch.where(two, torch.minimum(
        _first_false(q0[:, None] == chars, 0, n_l) + 1, m3), 0)
    suf = torch.where(two, torch.minimum(
        _first_false(q0_rev[:, None] == rev, 0, n_l) + 1, m3), 0)
    compares += int(pre.sum() + suf.sum())
    chars_ext = torch.maximum(chars_ext, pre)
    q0_ext = torch.maximum(q0_ext, pre.amax(0))
    q0_rev_ext = suf.amax(0)
    # 7. single-char boost: rows before the last in turn, each from the
    # doc token the previous one matched up to a word containing it; then
    # the next token's validity, first char, adjacency and length
    boost = multi & (last_len == 1) & last_alpha[sel]
    alive, d_at = boost.clone(), torch.zeros(n_c, dtype=torch.long)
    cont = bits(DCONTQ)
    for i in range(n_fq - 1):
        go = alive & (i < fqn - 1)
        span = tokm & (d_i >= d_at[None]) & go[None]
        read_w[i] |= _upto_first(cont[i], span, 0)
        hit = cont[i] & span
        alive = torch.where(go, hit.any(0), alive)
        d_at = torch.where(go & hit.any(0), hit.int().argmax(0), d_at)
    nxt = d_at + 1
    ok = alive & (nxt < n_d)
    nxt_c = nxt.clamp_max(n_d - 1)[None]
    at_nxt = (d_i == nxt[None]) & ok[None]
    read_valid |= at_nxt
    ok &= valid.gather(0, nxt_c)[0]
    chars_ext = torch.where((d_i == nxt[None]) & ok[None],
                            torch.clamp_min(chars_ext, 1), chars_ext)
    boost_q = ok.clone()                  # the last token's char is read
    ok &= chars[0].gather(0, nxt_c)[0] == fqc.gather(
        0, last_c[None, None].expand(1, n_l, n_c))[0, 0]
    read_adj |= (d_i == d_at[None]) & ok[None]
    ok &= adj.gather(0, d_at[None])[0]
    read_lens |= (d_i == nxt[None]) & ok[None]

    out.update(fq_pairs=4 * int(read_w.sum()), pairs=4 * int(read_p0.sum()),
               lens=4 * int(read_lens.sum()), valid=int(read_valid.sum()),
               adj_ws=int(read_adj.sum()), chars=4 * int(chars_ext.sum()),
               chars_rev=4 * int(suf.sum()))

    # ---- the per-query tables, each row a candidate selects once
    rows = torch.unique(sel)
    qcr = q_count[rows]
    htr = (torch.arange(n_q)[None] < qcr[:, None]) & (q_lens[rows] > 0)
    last_q = (qcr - 1).clamp(0, n_q - 1)
    n_idf = htr.sum(1) + ~htr.gather(1, last_q[:, None])[:, 0]
    fqr = fq_count[rows]
    multi_r = torch.where(fqr > 0, fqr, qcr) >= 2
    n_widf = torch.where(multi_r & (qcr >= 2), htr.sum(1), 0)
    n_b = q_count.shape[0]

    def per_row(vals, mask):
        """The largest of ``vals`` over each row's candidates where
        ``mask``, summed over the rows."""
        v = torch.where(mask, vals, 0).long()
        return int(torch.zeros(n_b, dtype=torch.long).scatter_reduce(
            0, sel, v, "amax").sum())

    out.update(
        query_rows=4 * int((qcr.clamp(0, n_q) + n_idf + n_widf).sum())
        + 12 * len(rows) + 4 * per_row(fqn.clamp(0, n_fq), have)
        + per_row(torch.ones(n_c), multi & (last_len == 1)),
        fq_chars=4 * (per_row(q0_ext, have) + per_row(boost_q, boost_q)),
        fq_chars_rev=4 * per_row(q0_rev_ext, have))
    return out, compares, int(ht.sum()), int(read_w.sum())


def fusion_bound(args):
    """(bytes, operations, real fusion pairs, bytes by input) the scorer +
    fusion program of these inputs needs: the bytes of ``fusion_reads``; FUSION_OPS_SLOT a
    real query slot, FUSION_OPS_WORD a relation word read and one a char
    compared. Real fusion pairs: (fusion token, doc token) pairs of real
    tokens, what the block gives the signals to do."""
    reads, compares, slots, words = fusion_reads(args)
    fq_count, tok = args[4][7].cpu()[args[5].cpu().long()], args[3][5].cpu()
    n_fq, n_d = args[2].shape[0], args[2].shape[1]
    n_pairs = int((fq_count.clamp(0, n_fq) * tok.clamp(0, n_d)).sum())
    ops = FUSION_OPS_SLOT * slots + FUSION_OPS_WORD * words + compares
    return sum(reads.values()), ops, n_pairs, reads


def fusion_phase(torch, bench_spy, long_spy, _kernels):
    """The fake-LCS and fusion kernels against their plain versions on the
    same real coverage blocks."""
    from infidex_tpu_torch.ops import coverage_kernel as ck

    out = {}
    for name, which, plain, bound_of, kernel in (
            ("coverage_lcs", "lcs", ck.coverage_lcs_plain, lcs_bound,
             "coverage_lcs_kernel"),
            ("coverage_fusion", "fusion", ck.coverage_fusion_plain,
             fusion_bound, "coverage_fusion_kernel")):
        runs = []
        dispatch = getattr(ck, name)
        for label, origin, shape, args in kernel_blocks(bench_spy, long_spy,
                                                        which):
            def kernel_fn(args=args, dispatch=dispatch):
                return dispatch(*args)

            def plain_fn(args=args, plain=plain):
                return plain(*args)

            want = plain_fn()
            n0 = _kernels.launch_counts[name]
            k1, k2 = kernel_fn(), kernel_fn()
            torch.cuda.synchronize()
            check(_kernels.launch_counts[name] - n0 == 2,
                  f"{name} phase: not one launch per call")
            check(k1.dtype == want.dtype == torch.float32
                  and k1.shape == want.shape
                  and torch.equal(k1.view(torch.int32),
                                  want.view(torch.int32)),
                  f"{name} ({label}): differs from the plain version")
            check(torch.equal(k1.view(torch.int32), k2.view(torch.int32)),
                  f"{name} ({label}): two runs differ")
            err = float((k1.double() - want.double()).abs().max())
            ms, plain_ms, times = in_turns(torch, plain_fn, kernel_fn,
                                           reps=20)
            runs.append((label, origin, shape, args, kernel_fn, k1, err, ms,
                         plain_ms, times))
        launches = []
        dev = device_ms_each(torch, [r[4] for r in runs], kernel, reps=20,
                             launches=launches)
        out[name] = {}
        for (label, origin, shape, args, _, k1, err, ms, plain_ms,
             times), dev_ms, launch in zip(runs, dev, launches):
            nbytes, ops, work, by_input = bound_of(args)
            bound = bound_ms(nbytes, ops, INT32_PEAK)
            n_c = k1.shape[-1]
            if name == "coverage_lcs":
                what = (f"{work} eligible candidates, "
                        f"{int((k1 > 0).sum())} with an LCS")
            else:
                what = (f"{work} real (fusion token, doc token) pairs, "
                        f"{int((k1[0] >= 1).sum())} with precedence bits")
            log(f"[kernel] {name}, {label} (Q, L, D {shape}, C {n_c}; "
                f"{what}; launched as {geometry(launch, n_c)}): bit-equal "
                f"to the plain version, "
                f"deterministic; "
                f"kernel {dev_ms:.4f} ms on the device (profiler), "
                f"{ms:.4f} ms a call back to back (events: {times['cuda']}),"
                f" plain {plain_ms:.4f} ms ({times['plain']}); bound "
                f"{bound[0]:.4f} ms by {bound[1]} ({nbytes} B, {ops} integer"
                f" operations), {bound[0] / dev_ms:.1%} of the device time; "
                f"bound bytes by input {by_input}")
            check(work > 0, f"{name} ({label}): the block exercises nothing")
            out[name][label] = dict(
                max_abs_err=err, ms=ms, device_ms=dev_ms, plain_ms=plain_ms,
                bound_ms=bound[0], bound_by=bound[1], bound_bytes=nbytes,
                bound_bytes_by_input=by_input, bound_ops=ops, origin=origin,
                shape=list(shape), candidates=n_c)
    return out


class Stage1Count:
    """While active, counts the Stage-1 groups that reach the epilogue: a
    resident or streamed group (``DeviceIndex._dispatch_group``) once, a
    sharded one (``ShardedDeviceIndex._search_group``) once per shard;
    those of them whose queries have fuzzy groups; and the pool-scored
    dispatches (``pool_score``), whose top-k is the epilogue's kernel too."""

    def __enter__(self):
        import numpy as np

        from infidex_tpu_torch.index import device
        from infidex_tpu_torch.parallel import sharding

        self.groups = self.fuzzy = self.pools = self.merges = 0
        self._orig = (device.DeviceIndex._dispatch_group,
                      sharding.ShardedDeviceIndex._search_group,
                      device.pool_score)
        dispatch, search, pool = self._orig

        def has_fz(queries):
            return any(np.asarray(g).size for q in queries
                       for g in (q[2] or ()))

        def group(index, queries, *a, **kw):
            self.groups += 1
            self.fuzzy += has_fz(queries)
            return dispatch(index, queries, *a, **kw)

        def shard_group(index, queries, *a, **kw):
            self.groups += len(index.mesh)
            self.fuzzy += len(index.mesh) * has_fz(queries)
            self.merges += 2        # the shards' score and LIM merges
            return search(index, queries, *a, **kw)

        def pooled(*a, **kw):
            self.pools += 1
            return pool(*a, **kw)

        device.DeviceIndex._dispatch_group = group
        sharding.ShardedDeviceIndex._search_group = shard_group
        device.pool_score = pooled
        return self

    def __exit__(self, *exc):
        from infidex_tpu_torch.index import device
        from infidex_tpu_torch.parallel import sharding

        (device.DeviceIndex._dispatch_group,
         sharding.ShardedDeviceIndex._search_group,
         device.pool_score) = self._orig

    def check(self, counts, what: str) -> None:
        """One epilogue, top-k and LIM launch per group (and shard), one
        fuzzy launch per group with fuzzy groups, one more top-k per pool
        dispatch, and two more (the score and LIM merges) per sharded
        group."""
        check(self.groups > 0 and counts["stage1_epilogue"]
              == counts["stage1_lim"] == self.groups
              and counts["stage1_topk"]
              == self.groups + self.pools + self.merges
              and counts["stage1_fuzzy"] == self.fuzzy,
              f"{what}: epilogue launches {counts} for {self.groups} "
              f"Stage-1 groups ({self.fuzzy} with fuzzy groups), "
              f"{self.pools} pool dispatches and {self.merges} shard "
              f"merges")
        log(f"[{what}] Stage-1 epilogue: {self.groups} groups "
            f"({self.fuzzy} with fuzzy groups), {self.pools} pool "
            f"dispatches, {self.merges} shard merges: fuzzy "
            f"{counts['stage1_fuzzy']}, pass "
            f"{counts['stage1_epilogue']}, top-k {counts['stage1_topk']}, "
            f"LIM {counts['stage1_lim']} launches")


#: the JAX program each epilogue kernel replaces (file:line)
EPILOGUE_REPLACES = {
    "stage1_fuzzy": "infidex_tpu/index/device.py:415",
    "stage1_epilogue": "infidex_tpu/index/device.py:466",
    "stage1_topk": "infidex_tpu/index/device.py:150",
    "stage1_lim": "infidex_tpu/index/device.py:202"}
#: kernel names in the profiler's records
EPILOGUE_NAMES = {"stage1_fuzzy": "stage1_fuzzy_",
                  "stage1_epilogue": "stage1_epilogue_kernel",
                  "stage1_topk": "stage1_topk_kernel",
                  "stage1_lim": "stage1_lim_kernel"}
#: epilogue kernels timed with every kernel their wrapper's call launches
#: (at least how many): the fuzzy kernel's bound counts the bitset
#: written, and the wrapper's zeroing fill writes it before the kernel ORs
#: into it
WHOLE_CALL = {"stage1_fuzzy": 2}


def kernel_ms(torch, fn, sub: str, reps: int):
    """Device ms of one call of ``fn`` (run before) from a torch.profiler
    session of ``reps`` calls: each kernel whose name contains ``sub``, its
    mean over the records the session kept, summed over the names. A
    session may drop records (on an H100 one kept 119 of 140, another none
    of ten): one that kept fewer than half a name's launches is taken
    again, up to three sessions, and then the time is the CUDA events'
    (which hold the wrapper's host time too). Returns (ms, records by name,
    "profiler" or "events")."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        by = {}
        for e in prof.events():
            if e.device_type == DeviceType.CUDA and sub in e.name:
                by.setdefault(e.name, []).append(e.time_range.elapsed_us())
        kept = {name: len(v) for name, v in by.items()}
        if by and all(2 * n >= reps for n in kept.values()):
            return (sum(sum(v) / len(v) for v in by.values()) / 1e3, kept,
                    "profiler")
    return cuda_ms(torch, fn, reps, warm=False), kept, "events"


def call_ms(torch, fn, n_kernels: int, reps: int):
    """Device ms of every kernel one call of ``fn`` (run before) launches,
    at least ``n_kernels`` distinct kernels, from a torch.profiler session
    of ``reps`` calls: each kernel's mean over the records the session
    kept, summed. As in ``kernel_ms``, a session that kept fewer kernels,
    or fewer than half the launches of one, is taken again, up to three
    sessions, and then the time is the CUDA events'. Returns (ms, records
    by kernel name, "profiler" or "events")."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        by = {}
        for e in prof.events():
            if e.device_type == DeviceType.CUDA:
                by.setdefault(e.name, []).append(e.time_range.elapsed_us())
        kept = {name[:48]: len(v) for name, v in by.items()}
        if len(by) >= n_kernels and all(2 * len(v) >= reps
                                        for v in by.values()):
            return (sum(sum(v) / len(v) for v in by.values()) / 1e3, kept,
                    "profiler")
    return cuda_ms(torch, fn, reps, warm=False), kept, "events"


def tie_corpus(n: int = 3000, seed: int = 5):
    """tests/test_lim_class.py's tie-heavy titles: two words over ten
    syllables, so that thousands of docs score alike."""
    rng = random.Random(seed)
    syll = ["ba", "ce", "do", "fa", "gi", "ha", "ji", "ka", "lo", "me"]
    return [f"Yorin{rng.choice(syll)} {rng.choice(syll).title()}zen"
            for _ in range(n)]


def stage1_group(torch, dev_index, preps):
    """The first Stage-1 group of ``preps`` as ``_dispatch_group`` builds it
    before the epilogue: the scattered score and count matrices (the lane
    kernel), the fuzzy tables (None without fuzzy groups) and their
    count."""
    from infidex_tpu_torch.index import device as D
    from infidex_tpu_torch.ops import stage1_lanes as lanes

    lo, hi = D.split_batch_by_lanes(dev_index.built, preps)[0]
    qs = preps[lo:hi]
    prep = D.prepare_batch_arrays(dev_index.built, qs)
    fz_starts, fz_lens, fz_group, grp_query, _, n_grp = prep[6:]
    n_q, n_pad = len(qs), dev_index.n_pad
    scores = torch.zeros(n_q * n_pad, dtype=torch.float32,
                         device=dev_index.device)
    cnt = torch.zeros_like(scores)
    lanes.scatter_lanes(scores, cnt, dev_index._chunks(qs, prep),
                        dev_index.postings_docs, dev_index.cfac, 0, n_pad)
    fz = (D.fuzzy_groups(fz_starts, fz_lens, fz_group, grp_query, n_q,
                         dev_index.device) if n_grp else None)
    return scores.view(n_q, n_pad), cnt.view(n_q, n_pad), fz, n_grp


def unpack_bits(torch, bits, width: int):
    """A presence bitset (int32 [n_grp, words]) as bool [n_grp, width], and
    whether any bit past the width is set."""
    shift = torch.arange(32, device=bits.device, dtype=torch.int32)
    flat = ((bits[:, :, None] >> shift) & 1).reshape(bits.shape[0], -1)
    return flat[:, :width].bool(), bool(flat[:, width:].any())


def epilogue_check(torch, _kernels, dev_index, preps, ks, label: str,
                   sub_rows=()):
    """The four epilogue kernels against their plain versions on the first
    Stage-1 group of ``preps``: presence bits and df, the pass's scores,
    counts and row maxima, the top-k at each depth of ``ks`` and the LIM
    rows at the first, each bit-equal and alike in two runs; then each
    kernel's device time (torch.profiler; the fuzzy kernel's with its
    wrapper's zeroing fill, which writes the bitset its bound counts, and
    alone) beside its plain version's
    (events), in turns, its bound from this group's data, and the library
    call's time where one computes the same (``torch.topk`` over the int64
    keys; the LIM's masked ``torch.topk``). The same for the group's first
    n rows, for each n of ``sub_rows`` (a single query, a small group).
    Returns the measurements by kernel (the top-k's by depth under "by_k",
    the first rows' under "by_rows")."""
    from infidex_tpu_torch.index import device as D

    scores, cnt, fz, n_grp = stage1_group(torch, dev_index, preps)
    n_q, n_pad = scores.shape
    ks = [min(k, n_pad) for k in ks]
    live = dev_index.live_mask
    dev = scores.device
    f32 = torch.float32
    out, runs = {}, {}

    def equal(a, b):
        if a.dtype == f32:
            return a.shape == b.shape and torch.equal(
                a.contiguous().view(torch.int32),
                b.contiguous().view(torch.int32))
        return torch.equal(a, b)

    # 1. the fuzzy groups' presence and df
    bits = dense = fidf = q_off = q_grp = None
    if n_grp:
        fargs = (dev_index.postings_docs, fz.d_starts, fz.d_group, fz.d_cum,
                 fz.n_lanes, n_grp, 0, n_pad)

        def fuzzy_plain():
            p = D.fuzzy_presence_plain(dev_index.postings_docs, fz.starts,
                                       fz.lens, fz.group, n_grp, 0, n_pad)
            return p, p.sum(dim=1).to(torch.int32)

        dense, df_p = fuzzy_plain()
        n0 = _kernels.launch_counts["stage1_fuzzy"]
        bits, df = _kernels.stage1_fuzzy(*fargs)
        bits2, df2 = _kernels.stage1_fuzzy(*fargs)
        torch.cuda.synchronize()
        check(_kernels.launch_counts["stage1_fuzzy"] - n0 == 2,
              "fuzzy kernel: not one launch per call")
        inside, past = unpack_bits(torch, bits, n_pad)
        check(torch.equal(inside, dense > 0) and not past
              and torch.equal(df, df_p),
              f"fuzzy kernel ({label}): presence or df differ from the "
              f"plain version")
        check(torch.equal(bits, bits2) and torch.equal(df, df2),
              f"fuzzy kernel ({label}): two runs differ")
        del inside, bits2, df2
        fidf = D.fuzzy_idf(df, torch.tensor(float(dev_index.num_docs),
                                            dtype=f32, device=dev),
                           torch.tensor(1_250_000.0, dtype=f32, device=dev))
        q_off, q_grp = fz.d_qoff, fz.d_qgrp
        # postings read, the term tables, the bitset and df written (the
        # wrapper's zeroing fill writes them, timed with the kernel)
        nbytes = (4 * fz.n_lanes + 12 * fz.starts.size
                  + 4 * bits.numel() + 4 * n_grp)
        runs["stage1_fuzzy"] = (lambda: _kernels.stage1_fuzzy(*fargs),
                                fuzzy_plain, None, nbytes,
                                f"{n_grp} groups of {fz.starts.size} terms, "
                                f"{fz.n_lanes} postings, df sum "
                                f"{int(df.sum())}")
        out["stage1_fuzzy"] = dict(max_abs_err=int(
            (df - df_p).abs().max()))

    # 2. the pass
    def pass_plain():
        return D.stage1_epilogue_plain(
            scores.clone(), cnt.clone(), live, dense, fidf,
            dev_index.doc_fac, fz.grp_query if n_grp else None)

    s_p, c_p, m_p, fz_any = pass_plain()
    n0 = _kernels.launch_counts["stage1_epilogue"]
    got = []
    for _ in range(2):
        s_k, c_k = scores.clone(), cnt.clone()
        m_k = _kernels.stage1_epilogue(s_k, c_k, live, bits, fidf,
                                       dev_index.doc_fac, q_off, q_grp)
        got.append((s_k, c_k, m_k))
    torch.cuda.synchronize()
    check(_kernels.launch_counts["stage1_epilogue"] - n0 == 2,
          "epilogue kernel: not one launch per call")
    for name, a, b, c in zip(("scores", "cnt", "row max"), got[0],
                             (s_p, c_p, m_p), got[1]):
        check(equal(a, b), f"epilogue kernel ({label}): {name} differ from "
              f"the plain version")
        check(equal(a, c), f"epilogue kernel ({label}): two runs differ")
    s_k, c_k, m_k = got[0]
    del got
    tmp_s, tmp_c = scores.clone(), cnt.clone()
    # scores and counts read, scores written (and counts, with fuzzy
    # groups), the live mask read, the row maxima written; with fuzzy
    # groups the doc factors, the bitset, fidf and the group tables read
    nbytes = n_q * n_pad * (16 if n_grp else 12) + 4 * n_pad + 4 * n_q
    if n_grp:
        nbytes += 4 * n_pad + 4 * bits.numel() + 4 * n_grp \
            + 4 * (n_q + 1 + n_grp)
    runs["stage1_epilogue"] = (
        lambda: _kernels.stage1_epilogue(tmp_s, tmp_c, live, bits, fidf,
                                         dev_index.doc_fac, q_off, q_grp),
        pass_plain, None, nbytes,
        f"{n_q} x {n_pad}, {n_grp} fuzzy groups, "
        f"{int((m_p > 0).sum())} rows with a positive row max")
    out["stage1_epilogue"] = dict(max_abs_err=float(
        (s_k - s_p).abs().max()))

    # 3. the top-k at every depth
    keys = D.order_keys(s_p, torch.arange(n_pad, device=dev)[None, :])
    by_k = {}
    for k in ks:
        want = D.stable_top_k_plain(s_p, k)
        n0 = _kernels.launch_counts["stage1_topk"]
        k1, k2 = _kernels.stage1_topk(s_k, k), _kernels.stage1_topk(s_k, k)
        torch.cuda.synchronize()
        check(_kernels.launch_counts["stage1_topk"] - n0 == 2,
              "top-k kernel: not one launch per call")
        check(torch.equal(k1[1], want[1]) and equal(k1[0], want[0]),
              f"top-k kernel ({label}, k {k}): differs from the plain "
              f"version")
        check(torch.equal(k1[1], k2[1]) and equal(k1[0], k2[0]),
              f"top-k kernel ({label}, k {k}): two runs differ")
        kth = want[0][:, k - 1:k]
        ties = int((s_p == kth).sum() - (want[0] == kth).sum())
        # the row read once, ids and scores written
        runs[f"stage1_topk {k}"] = (
            lambda k=k: _kernels.stage1_topk(s_k, k),
            lambda k=k: D.stable_top_k_plain(s_p, k),
            lambda k=k: torch.topk(keys, k, dim=1, largest=True,
                                   sorted=True),
            4 * n_q * n_pad + 8 * n_q * k,
            f"k {k}, {n_q} rows of {n_pad}; {ties} ids of the boundary "
            f"classes left out")
        by_k[k] = dict(max_abs_err=int((k1[1] - want[1]).abs().max()))
        del want, k1, k2

    # 4. the LIM rows at the first depth
    k = ks[0]
    k2, window = min(D.LIM_K, k), min(D.LIM_WINDOW, n_pad)
    pad = max(D._LIM_PAD, n_pad)
    want = D.lim_rows_plain(c_p, live, m_p, fz_any, k, k2, window, 0, pad)
    lim_args = (c_k, live, m_k, bits, fidf, q_off, q_grp, k, k2, window, 0,
                pad)
    n0 = _kernels.launch_counts["stage1_lim"]
    l1, l2 = _kernels.stage1_lim(*lim_args), _kernels.stage1_lim(*lim_args)
    torch.cuda.synchronize()
    check(_kernels.launch_counts["stage1_lim"] - n0 == 2,
          "LIM kernel: not one launch per call")
    check(torch.equal(l1, want), f"LIM kernel ({label}): differs from the "
          f"plain version")
    check(torch.equal(l1, l2), f"LIM kernel ({label}): two runs differ")
    members = (want[:, :k2] < n_pad).sum(dim=1)
    # each row's counts up to its k2-th member (or the window), the live
    # mask as far as the longest row, the rows written, the thresholds;
    # with fuzzy groups the presence words of each row's groups that far
    stop = torch.where(members >= k2, want[:, k2 - 1].long() + 1,
                       torch.full_like(members, window).long())
    nbytes = 4 * int(stop.sum()) + 4 * int(stop.max()) + 4 * n_q * k \
        + 4 * n_q
    if n_grp:
        per_q = torch.bincount(torch.from_numpy(fz.grp_query).long(),
                               minlength=n_q).to(dev)
        nbytes += 4 * int((per_q * ((stop + 31) // 32)).sum())
    mask = (c_p * live[None, :] >= m_p[:, None]) & (m_p[:, None] > 0)
    if fz_any is not None:
        mask = mask | (fz_any & (live[None, :] > 0))
    iota = torch.arange(n_pad, device=dev, dtype=torch.int64)
    lkey = torch.where(mask & (iota < window)[None, :], iota[None, :], pad)
    del mask
    runs["stage1_lim"] = (
        lambda: _kernels.stage1_lim(*lim_args),
        lambda: D.lim_rows_plain(c_p, live, m_p, fz_any, k, k2, window, 0,
                                 pad),
        lambda: torch.topk(lkey, k2, dim=1, largest=False, sorted=True),
        nbytes, f"k {k}, k2 {k2}, {int(members.sum())} ids in "
        f"{n_q} rows, {int((members < k2).sum())} rows with fewer than k2")
    out["stage1_lim"] = dict(max_abs_err=int((l1 - want).abs().max()))

    # 5. the group's first rows: a single query, a small group
    by_rows = {"stage1_topk": {}, "stage1_lim": {}}
    for n in sub_rows:
        s_n, c_n, m_n = (t[:n].contiguous() for t in (s_k, c_k, m_k))
        for kk in ks:
            want = D.stable_top_k_plain(s_p[:n], kk)
            got = _kernels.stage1_topk(s_n, kk)
            torch.cuda.synchronize()
            check(torch.equal(got[1], want[1]) and equal(got[0], want[0]),
                  f"top-k kernel ({label}, {n} rows, k {kk}): differs from "
                  f"the plain version")
            by_rows["stage1_topk"][f"{n} rows, k {kk}"] = dict(
                max_abs_err=int((got[1] - want[1]).abs().max()))
            runs[f"stage1_topk {kk} rows {n}"] = (
                lambda kk=kk, s_n=s_n: _kernels.stage1_topk(s_n, kk),
                lambda kk=kk, n=n: D.stable_top_k_plain(s_p[:n], kk),
                lambda kk=kk, n=n: torch.topk(keys[:n], kk, dim=1,
                                              largest=True, sorted=True),
                4 * n * n_pad + 8 * n * kk,
                f"k {kk}, {n} rows of {n_pad}, "
                f"{_kernels.topk_slices(n, n_pad, dev)} blocks a row")
        fz_n = None if fz_any is None else fz_any[:n]
        q_off_n = None if q_off is None else q_off[:n + 1].contiguous()
        want = D.lim_rows_plain(c_p[:n], live, m_p[:n], fz_n, k, k2, window,
                                0, pad)
        n_args = (c_n, live, m_n, bits, fidf, q_off_n, q_grp, k, k2, window,
                  0, pad)
        got = _kernels.stage1_lim(*n_args)
        torch.cuda.synchronize()
        check(torch.equal(got, want), f"LIM kernel ({label}, {n} rows): "
              f"differs from the plain version")
        by_rows["stage1_lim"][f"{n} rows"] = dict(
            max_abs_err=int((got - want).abs().max()))
        nbytes = 4 * int(stop[:n].sum()) + 4 * int(stop[:n].max()) \
            + 4 * n * k + 4 * n
        if n_grp:
            nbytes += 4 * int((per_q[:n] * ((stop[:n] + 31) // 32)).sum())
        runs[f"stage1_lim rows {n}"] = (
            lambda n_args=n_args: _kernels.stage1_lim(*n_args),
            lambda n=n, fz_n=fz_n: D.lim_rows_plain(
                c_p[:n], live, m_p[:n], fz_n, k, k2, window, 0, pad),
            lambda n=n: torch.topk(lkey[:n], k2, dim=1, largest=False,
                                   sorted=True),
            nbytes, f"k {k}, k2 {k2}, {n} rows, "
            f"{_kernels.lim_slices(n, window, dev)} blocks a row")

    # times: the kernel on the device (a profiler session each turn; with
    # the rest of its wrapper's call where WHOLE_CALL names it, and alone
    # beside that), the plain version and the library call by events, in
    # turns
    for name, (kernel_fn, plain_fn, lib_fn, nbytes, what) in runs.items():
        base = name.split()[0]
        kernel_fn()
        plain_fn()
        dev_ms, plain_t, kept, alone = [], [], [], []
        for route in ("plain", "cuda", "cuda", "plain"):
            if route == "plain":
                plain_t.append(cuda_ms(torch, plain_fn, reps=1, warm=False))
                continue
            if base in WHOLE_CALL:
                ms, rec, src = call_ms(torch, kernel_fn, WHOLE_CALL[base], 5)
                alone.append(kernel_ms(torch, kernel_fn,
                                       EPILOGUE_NAMES[base], 5)[0])
            else:
                ms, rec, src = kernel_ms(torch, kernel_fn,
                                         EPILOGUE_NAMES[base], 5)
            dev_ms.append(ms)
            kept.append(rec if src == "profiler" else f"events, {rec}")
        ms, plain_ms = sum(dev_ms) / 2, sum(plain_t) / 2
        lib_ms = cuda_ms(torch, lib_fn, reps=3) if lib_fn else None
        bound = bound_ms(nbytes, 0, F32_PEAK)
        row = dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                   bound_ms=bound[0], bound_by=bound[1], bound_bytes=nbytes,
                   turns=dev_ms, plain_turns=plain_t)
        if alone:
            row.update(kernel_alone_ms=sum(alone) / 2, alone_turns=alone)
        parts = name.split()
        if "rows" in parts:
            sub = f"{parts[-1]} rows" + (f", k {parts[1]}"
                                         if base == "stage1_topk" else "")
            by_rows[base][sub].update(row)
        elif base == "stage1_topk":
            by_k[int(name.split()[1])].update(row)
        else:
            out[base].update(row)
        lib = f", library {lib_ms:.4f} ms" if lib_fn else ""
        whole = (f" with the rest of its wrapper's call (alone "
                 f"{row['kernel_alone_ms']:.4f} ms: {alone})"
                 if alone else "")
        log(f"[epilogue] {label}: {name} ({what}): bit-equal to the plain "
            f"version, deterministic; kernel {ms:.4f} ms on the device"
            f"{whole} "
            f"({dev_ms}; records kept of 5 calls: {kept}), plain "
            f"{plain_ms:.4f} ms ({plain_t}){lib}; bound "
            f"{bound[0]:.4f} ms by {bound[1]} ({nbytes} B), "
            f"{bound[0] / ms:.1%} of the device time")
    out["stage1_topk"] = dict(by_k[ks[0]], by_k=by_k,
                              by_rows=by_rows["stage1_topk"])
    out["stage1_lim"]["by_rows"] = by_rows["stage1_lim"]
    return out


def epilogue_phase(torch, it, eng, queries, _kernels):
    """The four epilogue kernels against their plain versions on the bench
    batch's first Stage-1 group (k 500 and 20,000) and on the tie-heavy
    corpus (k 500 and 2,000); phase 7 adds the large-vocabulary group."""
    m = eng.vector_model
    preps = [p for p in map(m.prepare_stage1, queries[:BATCH])
             if p is not None]
    bench = epilogue_check(torch, _kernels, m.device, preps, (500, 20_000),
                           "bench group", sub_rows=(1, 8))
    tm = build_engine(it, tie_corpus()).vector_model
    tpreps = [tm.prepare_stage1(q) for q in
              ("yorin", "yorinba cezen", "yorinka", "dozen yorin")]
    ties = epilogue_check(torch, _kernels, tm.device, tpreps, (500, 2000),
                          "tie-heavy index")
    return dict(bench=bench, ties=ties)


def cross_device_phase(it, runtime, bench, _kernels):
    """The same small corpus served on the CPU and on the card: resident
    batches and single queries, the same under 4 shards on the one
    device, and batches with device pool scoring."""
    from infidex_tpu_torch.index import candidates
    from infidex_tpu_torch.parallel.sharding import make_mesh

    titles = bench.make_corpus(CROSS_DOCS)
    queries = bench.make_queries(titles, CROSS_QUERIES)

    def serve(eng, single=True):
        return (flatten(run_batches(it, eng, queries, CROSS_BATCH)),
                flatten([eng.search(it.Query(q, 10)) for q in queries])
                if single else None)

    out = {}
    pool_launches = 0
    for dev in ("cpu", "cuda"):
        runtime.set_device(dev)
        eng = build_engine(it, titles)
        check(eng.vector_model.device.device.type == dev,
              f"cross-device: index not on {dev}")
        out["resident", dev] = serve(eng)
        eng.enable_sharded_serving(mesh=make_mesh(devices=[dev] * SHARDS))
        check(len(eng.vector_model.sharded.mesh) == SHARDS,
              "cross-device: not sharded")
        out["sharded", dev] = serve(eng)
        eng.disable_sharded_serving()
        budget = candidates.TIER_LANE_BUDGET
        candidates.TIER_LANE_BUDGET = 1
        eng.vector_model.POOL_DEVICE = "1"
        n0 = _kernels.launch_counts["pool_score"]
        try:
            out["pool", dev] = serve(eng, single=False)
        finally:
            candidates.TIER_LANE_BUDGET = budget
            del eng.vector_model.POOL_DEVICE
        if dev == "cuda":
            pool_launches = _kernels.launch_counts["pool_score"] - n0
    runtime.set_device("cuda")
    check(pool_launches > 0, "cross-device: the pool kernel never launched")
    for mode in ("resident", "sharded", "pool"):
        for what, a, b in (("search_batch", out[mode, "cpu"][0],
                            out[mode, "cuda"][0]),
                           ("search", out[mode, "cpu"][1],
                            out[mode, "cuda"][1])):
            if a is None:
                continue
            bad = [q for q, x, y in zip(queries, a, b) if x != y]
            check(not bad, f"cross-device {mode} {what}: {len(bad)} queries "
                  f"differ, e.g. {bad[:3]}")
    n_found = sum(bool(r) for r in out["resident", "cuda"][0])
    same = sum(a == b for a, b in zip(out["resident", "cuda"][0],
                                      out["sharded", "cuda"][0]))
    log(f"[cross] {CROSS_DOCS} docs, {len(queries)} queries: CPU and CUDA "
        f"identical (ids and f32 scores) in search_batch and in single "
        f"search, resident and with {SHARDS} shards on one device, and in "
        f"search_batch with device pool scoring ({pool_launches} pool "
        f"kernel launches on the card); {n_found} queries with hits; "
        f"sharded lists equal to resident on {same}/{len(queries)}")


def main_phase(torch, it, eng, queries, _kernels):
    """The slice's main path at 1M docs; returns the launch counts and the
    two batches' results."""
    from infidex_tpu_torch.ops import coverage_kernel as ck

    batches = [queries[i:i + BATCH] for i in (0, BATCH)]
    eng.serving_split(reset=True)
    pipe = eng._pipeline
    fallback0 = pipe.coverage_host_fallback_count
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _kernels.reset_launch_counts()
    walls, results = [], []
    with BlockCount(ck) as blocks, Stage1Count() as epi:
        for b in batches:
            t0 = time.perf_counter()
            results.append(eng.search_batch([it.Query(q, 10) for q in b]))
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
        t0 = time.perf_counter()
        many = eng.search_many(
            [it.Query(q, 10) for q in queries[:2 * BATCH]], batch_size=BATCH)
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
    log(f"[main] {blocks.n} coverage blocks in the 4 batches, "
        f"{counts['coverage_gather']} gather-kernel, "
        f"{counts['coverage_pairs']} pair-kernel, "
        f"{counts['coverage_cascade']} cascade-kernel, "
        f"{counts['coverage_lcs']} fake-LCS-kernel and "
        f"{counts['coverage_fusion']} fusion-kernel launches")
    check_per_block(counts, blocks.n, "main path")
    epi.check(counts, "main")
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
    return counts, results


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


#: the single-query device phase: queries, top-k, and the CPU-vs-CUDA
#: corpus
DEVICE_SINGLES, DEVICE_SINGLE_K, DEVICE_SINGLE_CROSS_DOCS = 64, 500, 20_000
#: the synthetic extras of the extras-kernel check: docs of a row, their
#: distinct docs
EXTRAS_SYNTH, EXTRAS_SYNTH_DOCS = 200_000, 60_000


def device_extras(torch, m, groups):
    """A query's fuzzy groups as explicit extra postings (docs int32, idfs
    f32), as tests/test_search_batch.py:105-118 makes them: each group's
    union of posting docs where 0 < size <= the stop limit, at its union's
    idf. Over the terms' device ranges (champion-clipped above
    DEVICE_TERM_CAP postings) and with the batch route's idf
    (``fuzzy_idf``), the union and idf ``search_batch`` scores; (None,
    None) without any."""
    import numpy as np

    from infidex_tpu_torch.index import device as D

    built = m.built
    docs, idfs = [], []
    for grp in groups:
        parts = [built.ext_docs[s:s + n] for s, n in (
            D.term_device_range(built, int(t)) for t in np.asarray(grp))]
        union = (np.unique(np.concatenate(parts)) if parts
                 else np.zeros(0, np.int32))
        if 0 < union.size <= m.stop_term_limit:
            fidf = D.fuzzy_idf(
                torch.tensor([union.size], dtype=torch.int32),
                torch.tensor(float(np.float32(m.documents.count))),
                torch.tensor(float(np.float32(m.stop_term_limit))))
            docs.append(union.astype(np.int32))
            idfs.append(np.full(union.size, float(fidf[0]), np.float32))
    if not docs:
        return None, None
    return np.concatenate(docs), np.concatenate(idfs)


def device_by_kernel(torch, fn, reps: int) -> dict:
    """Mean device ms a call of ``fn`` (run before) by kernel name (its
    first 40 chars), from a torch.profiler session of ``reps`` calls
    (records a session dropped count as missing, not as zero)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    by = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            by.setdefault(e.name[:40], []).append(e.time_range.elapsed_us())
    return {name: sum(v) / len(v) / 1e3 for name, v in by.items()}


def extras_check(torch, _kernels, dev_index, row, docs, idf, label: str):
    """The extras kernel against its plain version on the score row
    ``row`` (CUDA, f32 [n_pad]) and the extras (docs, idf): bit-equal,
    two identical runs; the kernel's device time (torch.profiler) beside
    the plain version's (events) in turns, the bound from these extras,
    and ``index_add_``'s time (all the extras' contributions in one call,
    the library's scatter; float atomics, so not bit-equal)."""
    import numpy as np

    from infidex_tpu_torch.index import device as D

    doc_fac = dev_index.doc_fac
    docs64 = docs.astype(np.int64)
    plain = row.cpu()
    D.stage1_extras_plain(plain, docs64, idf, doc_fac.cpu())
    t = D.extras_table(docs64, idf, row.device)
    runs = []
    for _ in range(2):
        got = row.clone()
        _kernels.stage1_extras(got, t.docs, t.off, t.idf, doc_fac)
        torch.cuda.synchronize()
        runs.append(got.cpu())
    check(torch.equal(runs[0].view(torch.int32), runs[1].view(torch.int32)),
          f"extras kernel ({label}): two runs differ")
    check(torch.equal(runs[0].view(torch.int32), plain.view(torch.int32)),
          f"extras kernel ({label}): differs from the plain version")
    err = float((runs[0] - plain).abs().max())
    scratch = row.clone()
    d_dev = torch.from_numpy(docs64).to(row.device)
    src = torch.from_numpy(idf).to(row.device) * doc_fac[d_dev]

    def kernel():
        _kernels.stage1_extras(scratch, t.docs, t.off, t.idf, doc_fac)

    def plain_fn():
        D.stage1_extras_plain(scratch, docs64, idf, doc_fac)

    def library():
        scratch.index_add_(0, d_dev, src)

    kernel()
    plain_fn()
    ms, kept, origin = kernel_ms(torch, kernel, "stage1_extras", 20)
    plain_ms = in_turns(torch, plain_fn, kernel, 5)[1]
    library_ms = cuda_ms(torch, library, 20)
    n_e, n_u = int(docs.size), int(t.docs.numel())
    ranks = int(np.bincount(docs64).max())
    # each input read once, the output written once: the extras' docs and
    # idfs, each distinct doc's factor, its cell read and written
    nbytes = 8 * n_e + 12 * n_u
    bound = bound_ms(nbytes, 2 * n_e, F32_PEAK)
    log(f"[device single] extras kernel ({label}): {n_e} extras on {n_u} "
        f"distinct docs (up to {ranks} a doc), bit-equal to the plain "
        f"version, two runs identical; device {ms:.4f} ms ({origin}, "
        f"records {kept}), plain {plain_ms:.4f} ms ({ranks} index_add_ "
        f"passes), index_add_ of all extras in one call {library_ms:.4f} "
        f"ms; bound {bound[0]:.5f} ms by {bound[1]} ({nbytes} B), "
        f"{bound[0] / ms:.1%} of the device time")
    return dict(max_abs_err=err, ms=ms, origin=origin, plain_ms=plain_ms,
                library_ms=library_ms, bound_ms=bound[0], bound_by=bound[1],
                bound_bytes=nbytes, extras=n_e, distinct_docs=n_u,
                most_a_doc=ranks)


def device_single_phase(torch, it, runtime, bench, eng, queries, _kernels):
    """``DeviceIndex.search`` (the single-query device Stage 1) on the 1M
    bench index: DEVICE_SINGLES bench queries, typo queries with their
    fuzzy groups as extra postings, with the kernels' counts reset just
    before and read just after (one lane launch a query with lanes, one
    extras launch a query with extras, one epilogue pass and one top-k
    each); ids exact and scores within rtol 1e-6 against ``search_batch``
    on the same preps (bit-equal where a doc takes at most one extra); the
    extras kernel against its plain version; the same searches on 4
    shards of the card against the one-card route (bit-equal); and a
    DEVICE_SINGLE_CROSS_DOCS-doc corpus on the CPU and on the card
    (bit-equal)."""
    import numpy as np

    from infidex_tpu_torch.index import device as D
    from infidex_tpu_torch.parallel.sharding import (ShardedDeviceIndex,
                                                     make_mesh)

    m = eng.vector_model
    di = m.device
    asked = [(q, m.prepare_stage1(q)) for q in queries[:DEVICE_SINGLES]]
    texts = [q for q, p in asked if p is not None]
    preps = [p for _, p in asked if p is not None]
    extras = [device_extras(torch, m, p[2]) for p in preps]
    n_extras = sum(e[0] is not None for e in extras)
    check(n_extras > 0, "device single: no query brought extra postings")
    with_lanes = sum(int(D.single_query_chunks(
        di.built, t, i, di.n_pad, "cpu").off.numel() > 0)
        for t, i, _ in preps)
    K = DEVICE_SINGLE_K
    di.search(*preps[0][:2], K, *extras[0])     # warm

    torch.cuda.synchronize()
    _kernels.reset_launch_counts()
    walls, singles = [], []
    for (t, i, _), (ed, ei) in zip(preps, extras):
        t0 = time.perf_counter()
        singles.append(di.search(t, i, K, ed, ei))
        walls.append(time.perf_counter() - t0)
    counts = dict(_kernels.launch_counts)
    n = len(preps)
    want = dict.fromkeys(counts, 0)
    want.update(stage1_scatter_lanes=with_lanes, stage1_extras=n_extras,
                stage1_epilogue=n, stage1_topk=n)
    check(counts == want, f"device single: launches {counts}, expected "
          f"{want} for {n} searches")
    p50, p95 = percentiles_ms(walls)
    log(f"[device single] {n} searches (top {K}) on {N_DOCS} docs, {n_extras}"
        f" with extras ({sum(e[0].size for e in extras if e[0] is not None)}"
        f" extra postings): host p50 {p50:.3f} ms, p95 {p95:.3f} ms; "
        f"launches {counts}")

    # against search_batch on the same preps
    batch = di.search_batch(preps, K, total_docs=m.documents.count,
                            stop_term_limit=m.stop_term_limit)
    n_bits = n_multi = 0
    for q, ((s_s, s_i), (b_s, b_i, _), (ed, _)) in enumerate(
            zip(singles, batch, extras)):
        check(np.array_equal(s_i, b_i), f"device single: query {q} "
              f"({texts[q]!r}): ids differ from search_batch")
        check(np.all(np.abs(s_s - b_s) <= 1e-6 * np.abs(b_s)),
              f"device single: query {q}: scores beyond rtol 1e-6")
        times = (np.bincount(ed, minlength=di.n_pad)[s_i] if ed is not None
                 else np.zeros(s_i.size, np.int64))
        once = times <= 1
        check(np.array_equal(s_s[once].view(np.int32),
                             b_s[once].view(np.int32)),
              f"device single: query {q}: a doc with at most one extra "
              f"differs from search_batch")
        n_bits += int(np.sum(s_s.view(np.int32) == b_s.view(np.int32)))
        n_multi += int((~once).sum())
    found = sum(int((s > 0).any()) for s, _ in singles)
    check(found >= 0.9 * n, f"device single: only {found}/{n} found anything")
    log(f"[device single] ids equal to search_batch's on all {n} queries "
        f"(top {K}); scores within rtol 1e-6, {n_bits}/{n * K} bit-equal "
        f"({n_multi} entries are docs with several extras); {found}/{n} "
        f"with hits")

    # device ms of one search by kernel: the query with the most extras
    big = max(range(n), key=lambda j: extras[j][0].size
              if extras[j][0] is not None else -1)
    by_kernel = device_by_kernel(
        torch, lambda: di.search(*preps[big][:2], K, *extras[big]), 10)
    log(f"[device single] device ms of one search ({texts[big]!r}, "
        f"{extras[big][0].size} extras), by kernel: "
        f"{ {k: round(v, 4) for k, v in by_kernel.items()} }, total "
        f"{sum(by_kernel.values()):.4f} ms")

    # the extras kernel against its plain version: the phase's largest
    # extras set on its query's real row (after the lanes), and a synthetic
    # set with many extras a doc on a random row
    row = torch.zeros(di.n_pad, dtype=torch.float32, device=di.device)
    cnt = torch.zeros_like(row)
    from infidex_tpu_torch.ops import stage1_lanes as lanes
    lanes.scatter_lanes(row, cnt, D.single_query_chunks(
        di.built, *preps[big][:2], di.n_pad, di.device), di.postings_docs,
        di.cfac, 0, di.n_pad)
    real = extras_check(torch, _kernels, di, row, *extras[big],
                        "largest set")
    rng = np.random.default_rng(13)
    pool = rng.choice(N_DOCS, EXTRAS_SYNTH_DOCS, replace=False)
    s_docs = rng.choice(pool, EXTRAS_SYNTH).astype(np.int32)
    s_idf = (rng.random(EXTRAS_SYNTH) * 10.0
             ** rng.integers(-3, 3, EXTRAS_SYNTH)).astype(np.float32)
    synth_row = torch.from_numpy(
        (rng.random(di.n_pad) * 8).astype(np.float32)).to(di.device)
    synth = extras_check(torch, _kernels, di, synth_row, s_docs, s_idf,
                         "synthetic")

    # 4 shards of the one card against the one-card route (no extras)
    sdi = ShardedDeviceIndex(di.built, make_mesh(devices=["cuda:0"] * SHARDS))
    _kernels.reset_launch_counts()
    swalls, bad = [], []
    for q, (t, i, _) in enumerate(preps):
        t0 = time.perf_counter()
        got = sdi.search(t, i, K)
        swalls.append(time.perf_counter() - t0)
        one = di.search(t, i, K)
        if not (np.array_equal(got[1], one[1])
                and np.array_equal(got[0].view(np.int32),
                                   one[0].view(np.int32))):
            bad.append(texts[q])
    scounts = dict(_kernels.launch_counts)
    check(not bad, f"device single: {SHARDS} shards differ from one card on "
          f"{len(bad)} queries, e.g. {bad[:3]}")
    check(scounts["stage1_topk"] == (SHARDS + 2) * n
          and scounts["stage1_epilogue"] == (SHARDS + 1) * n,
          f"device single: sharded launches {scounts}")
    sp50, sp95 = percentiles_ms(swalls)
    log(f"[device single] {SHARDS} shards on one card: all {n} searches "
        f"bit-equal to the one-card route; host p50 {sp50:.3f} ms, p95 "
        f"{sp95:.3f} ms")
    del sdi

    # the CPU route against the card's on a smaller corpus
    titles = bench.make_corpus(DEVICE_SINGLE_CROSS_DOCS)
    cq = bench.make_queries(titles, DEVICE_SINGLES)
    out = {}
    for dev in ("cpu", "cuda"):
        runtime.set_device(dev)
        ceng = build_engine(it, titles)
        cm = ceng.vector_model
        check(cm.device.device.type == dev,
              f"device single: index not on {dev}")
        res = []
        for q in cq:
            p = cm.prepare_stage1(q)
            if p is not None:
                res.append(cm.device.search(p[0], p[1], K,
                                            *device_extras(torch, cm, p[2])))
        out[dev] = res
        del ceng, cm
    runtime.set_device("cuda")
    check(len(out["cpu"]) == len(out["cuda"]) > 0,
          "device single: the CPU and CUDA runs served other queries")
    diff = [q for q, a, b in zip(cq, out["cpu"], out["cuda"])
            if not (np.array_equal(a[1], b[1])
                    and np.array_equal(a[0].view(np.int32),
                                       b[0].view(np.int32)))]
    check(not diff, f"device single: CPU and CUDA differ on {len(diff)} "
          f"queries, e.g. {diff[:3]}")
    log(f"[device single] {DEVICE_SINGLE_CROSS_DOCS} docs, "
        f"{len(out['cpu'])} searches: CPU and CUDA identical (ids and f32 "
        f"scores)")
    return counts, dict(real, by_input={"largest set": real,
                                        "synthetic": synth},
                        search_p50_ms=p50, search_p95_ms=p95,
                        sharded_p50_ms=sp50, sharded_p95_ms=sp95,
                        search_device_ms_by_kernel=by_kernel)


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
    from infidex_tpu_torch.ops import coverage_kernel as ck
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

    # the epilogue kernels on the batch's first Stage-1 group, whose fuzzy
    # groups the signature matcher found
    preps = [p for p in map(m.prepare_stage1, queries[:BATCH])
             if p is not None]
    check(any(len(g) for p in preps for g in (p[2] or ())),
          "large vocabulary: the batch has no fuzzy groups")
    ek = epilogue_check(torch, _kernels, m.device, preps, (500,),
                        "large-vocabulary group")

    _kernels.reset_launch_counts()
    walls, results = [], []
    with BlockCount(ck) as blocks, Stage1Count() as epi:
        for i in (0, BATCH):
            t0 = time.perf_counter()
            results += eng.search_batch([it.Query(q, 10)
                                         for q in queries[i:i + BATCH]])
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
        counts = dict(_kernels.launch_counts)
    log(f"[vocab] two search_batch of {BATCH}: "
        f"{[round(w * 1e3, 1) for w in walls]} ms wall; {blocks.n} coverage "
        f"blocks; kernel launches {counts}")
    check_per_block(counts, blocks.n, "large vocabulary")
    epi.check(counts, "large vocabulary")
    check(counts["stage1_fuzzy"] > 0, "large vocabulary: no Stage-1 group "
          "with fuzzy groups")
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
                                    bound_by=bound[1]), counts, ek


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
    from infidex_tpu_torch.ops import coverage_kernel as ck

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
        with BlockCount(ck) as blocks, Stage1Count() as epi:
            res = eng.search_batch([it.Query(q, 10) for q in texts])
            torch.cuda.synchronize()
            counts = dict(_kernels.launch_counts)
        wall = time.perf_counter() - t0
        check(len(streamed) > n0 and counts["stage1_scatter_lanes"] > 0,
              "segments: the batch did not stream through the lane kernel")
        check_per_block(counts, blocks.n, "segments")
        epi.check(counts, "segments")
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


def serve_pool_batches(torch, it, eng, queries, _kernels):
    """Two 128-query batches with ``POOL_DEVICE="1"``, the kernels' counts
    reset just before and read just after. Returns the jobs the card
    scored ((pool, term ids, idfs) each), their top-k, the results, the
    walls and the counts."""
    from infidex_tpu_torch.ops import coverage_kernel as ck

    m = eng.vector_model
    dev_index = m.device
    gate, captured = [], []
    orig_gate, orig_dispatch = m._tier_gate, dev_index.pool_score_dispatch

    def gate_spy(prep):
        out = orig_gate(prep)
        gate.append(bool(out))
        return out

    def dispatch_spy(jobs, top_k):
        captured.append((list(jobs), top_k))
        return orig_dispatch(jobs, top_k)

    m._tier_gate, dev_index.pool_score_dispatch = gate_spy, dispatch_spy
    m.POOL_DEVICE = "1"
    walls, results = [], []
    try:
        torch.cuda.synchronize()
        _kernels.reset_launch_counts()
        with BlockCount(ck) as blocks, Stage1Count() as epi:
            for i in (0, BATCH):
                t0 = time.perf_counter()
                results.append(eng.search_batch(
                    [it.Query(q, 10) for q in queries[i:i + BATCH]]))
                torch.cuda.synchronize()
                walls.append(time.perf_counter() - t0)
            counts = dict(_kernels.launch_counts)
    finally:
        del m._tier_gate, dev_index.pool_score_dispatch, m.POOL_DEVICE
    check_per_block(counts, blocks.n, "pool scoring")
    epi.check(counts, "pool scoring")
    check(epi.pools > 0, "pool scoring: no pool dispatch")
    jobs = [j for js, _ in captured for j in js]
    log(f"[pool] two batches with POOL_DEVICE=\"1\": {sum(gate)} tier "
        f"jobs, {len(jobs)} pools scored on the card in {len(captured)} "
        f"dispatches; {[round(w * 1e3, 1) for w in walls]} ms wall; kernel "
        f"launches {counts}")
    check(counts["pool_score"] > 0, "pool scoring: the kernel never launched")
    return jobs, captured[0][1], results, counts


def pool_phase(torch, it, eng, queries, resident, _kernels):
    """Device pool scoring on the 1M-doc index: phase 4's batches with
    ``POOL_DEVICE="1"``, then the kernel on real jobs against its plain
    version and the native host scorer."""
    import numpy as np

    from infidex_tpu_torch.index import candidates
    from infidex_tpu_torch.ops import pool_score as ps

    m = eng.vector_model
    dev_index = m.device
    jobs, top_k, results, counts = serve_pool_batches(torch, it, eng, queries,
                                                      _kernels)
    bad = [q for q, a, b in zip(queries, flatten(results[0] + results[1]),
                                flatten(resident[0] + resident[1]))
           if a != b]
    check(not bad, f"pool scoring: {len(bad)} queries differ from phase 4's,"
          f" e.g. {bad[:3]}")
    log(f"[pool] ids and scores equal to phase 4's on all {2 * BATCH} "
        f"queries")

    saved = budget = candidates.TIER_LANE_BUDGET
    if len(jobs) < POOL_JOBS_MIN:
        # the reference test's way to put every multi-term query on the
        # tier path (tests/test_pool_device.py:102), inside this phase only
        candidates.TIER_LANE_BUDGET = budget = 1
        try:
            tiered = m._tiered_for()
            jobs = []
            for q in queries[:2 * BATCH]:
                prep = m.prepare_stage1(q)
                if prep is None or not tiered.applicable(prep[0], prep[2]):
                    continue
                sel = tiered.select_pool(prep[0], prep[1], top_k)
                if sel is not None:
                    jobs.append((sel[0], prep[0], prep[1]))
        finally:
            candidates.TIER_LANE_BUDGET = saved
    check(len(jobs) >= 1, "pool scoring: no jobs")
    args = dev_index.pool_args(jobs)
    n_jobs, p_pad = args[0].shape
    t_pad = args[2].shape[1]
    plain = ps.pool_score_plain(*args)
    n0 = _kernels.launch_counts["pool_score"]
    k1, k2 = ps.pool_score(*args), ps.pool_score(*args)
    torch.cuda.synchronize()
    check(_kernels.launch_counts["pool_score"] - n0 == 2,
          "pool kernel: not one launch per call")

    def bits(t):
        return t.view(torch.int32)

    check(torch.equal(bits(k1), bits(plain)),
          "pool kernel differs from its plain version")
    check(torch.equal(bits(k1), bits(k2)), "pool kernel: two runs differ")
    err = float((k1 - plain).abs().max())
    got = k1.cpu().numpy()
    offsets, docs_h = m.built.term_offsets, m.built.postings_docs
    probes = found = 0
    for b, (pool, t_ids, t_idfs) in enumerate(jobs):
        pool = np.asarray(pool, np.int64)
        want = candidates.score_pool(m.built, t_ids, t_idfs, pool)
        check(np.array_equal(got[b, :pool.size].view(np.int32),
                             want.view(np.int32)),
              f"pool kernel differs from the native score_pool (job {b})")
        for tid in np.asarray(t_ids, np.int64):
            s, e = int(offsets[tid]), int(offsets[tid + 1])
            if e > s:
                probes += pool.size
                found += int(np.isin(pool, docs_h[s:e]).sum())
    times = {"plain": [], "cuda": []}
    for route in ("plain", "cuda", "cuda", "plain"):
        fn = ps.pool_score_plain if route == "plain" else ps.pool_score
        times[route].append(cuda_ms(torch, lambda: fn(*args), reps=10))
    ms, plain_ms = sum(times["cuda"]) / 2, sum(times["plain"]) / 2
    # bound: each slot's id, flag and score (9 B), each valid slot's doc
    # length, the term tables (12 B a job-term), one posting doc read per
    # (valid slot, term) probe and the weight of each match; operations:
    # 21 compares per probe (the reference's search depth) and 8 f32
    # operations per match
    n_valid = int(args[1].sum())
    nbytes = 9 * n_jobs * p_pad + 4 * n_valid + 12 * n_jobs * t_pad \
        + 4 * probes + found
    bound = bound_ms(nbytes, 21 * probes + 8 * found, F32_PEAK)
    weights = args[6]
    log(f"[pool] kernel on {len(jobs)} jobs (TIER_LANE_BUDGET {budget}; "
        f"[{n_jobs}, {p_pad}] slots, {n_valid} valid, {t_pad} term slots, "
        f"{probes} probes, {found} matches): bit-equal to the plain version "
        f"and to the native score_pool, deterministic; kernel {ms:.4f} ms "
        f"({times['cuda']}), plain {plain_ms:.4f} ms ({times['plain']}); "
        f"bound {bound[0]:.4f} ms by {bound[1]} ({nbytes} B), "
        f"{bound[0] / ms:.1%} of it; posting weights uploaded at the first "
        f"dispatch: {weights.numel() * weights.element_size()} B")
    return counts, dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                        bound_ms=bound[0], bound_by=bound[1])


def shard_merge_check(torch, _kernels, inputs):
    """The shards' score and LIM merges (``parallel/sharding.py``
    ``_stable_merge``, ``_lim_merge``: the top-k kernel over the gathered
    rows) on the first sharded group's inputs: equal to the merges they
    replace (one ``torch.topk`` over packed (score, id) keys; the lowest
    ids by ``torch.topk``), the top-k kernel's device time, its bound and
    the time of that ``torch.topk``; and, from profiler sessions of their
    own, the device time of every kernel one merge launches and of every
    kernel the ``torch.topk`` call launches, side by side."""
    from infidex_tpu_torch.index import device as D
    from infidex_tpu_torch.parallel import sharding

    (all_s, all_i, k), (lows, k2, pad) = inputs["score"], inputs["lim"]
    got_s, got_i = sharding._stable_merge(all_s, all_i, k)
    keys = D.order_keys(all_s, all_i)
    pos = torch.topk(keys, k, dim=1, largest=True, sorted=True).indices
    check(torch.equal(got_i, torch.gather(all_i, 1, pos))
          and torch.equal(got_s.view(torch.int32),
                          torch.gather(all_s, 1, pos).view(torch.int32)),
          "shard score merge: differs from the packed-key top-k")
    got = sharding._lim_merge(lows, k2, pad)
    check(torch.equal(got, torch.topk(lows, k2, dim=1, largest=False,
                                      sorted=True).values),
          "shard LIM merge: differs from the lowest ids")
    n_q, width = all_s.shape
    out = {}
    for name, fn, lib_fn, nbytes in (
            ("score", lambda: sharding._stable_merge(all_s, all_i, k),
             lambda: torch.topk(keys, k, dim=1, largest=True, sorted=True),
             4 * n_q * width + 8 * n_q * k),
            ("lim", lambda: sharding._lim_merge(lows, k2, pad),
             lambda: torch.topk(lows, k2, dim=1, largest=False, sorted=True),
             4 * n_q * lows.shape[1] + 8 * n_q * k2)):
        fn()
        ms, kept, src = kernel_ms(torch, fn, "stage1_topk_kernel", 20)
        lib_ms = cuda_ms(torch, lib_fn, reps=3)
        merge_dev, merge_kernels = device_total_ms(torch, fn, 20)
        lib_dev, lib_kernels = device_total_ms(torch, lib_fn, 20)
        bound = bound_ms(nbytes, 0, F32_PEAK)
        out[name] = dict(ms=ms, library_ms=lib_ms, bound_ms=bound[0],
                         bound_by=bound[1], bound_bytes=nbytes,
                         rows=n_q, width=width, timing=src,
                         merge_device_ms=merge_dev,
                         merge_kernels=merge_kernels,
                         library_device_ms=lib_dev,
                         library_kernels=lib_kernels)
        log(f"[sharded] {name} merge ({n_q} rows of {width}): equal to the "
            f"merge it replaces; top-k kernel {ms:.4f} ms on the device "
            f"({kept}, by {src}), torch.topk {lib_ms:.4f} ms (events); "
            f"profiler, all kernels a call: the merge {merge_dev:.4f} ms "
            f"in {merge_kernels:.1f} kernels, torch.topk {lib_dev:.4f} ms "
            f"in {lib_kernels:.1f}; bound {bound[0]:.4f} ms by {bound[1]} "
            f"({nbytes} B)")
    return out


def sharded_phase(torch, it, eng, queries, resident, _kernels):
    """The 1M-doc index served by SHARDS shards on the one card, then by a
    one-shard mesh: identical results, one lane launch per shard and
    group; then the shards' merges on the first group's inputs."""
    from infidex_tpu_torch.ops import coverage_kernel as ck
    from infidex_tpu_torch.parallel import sharding
    from infidex_tpu_torch.parallel.sharding import make_mesh

    m = eng.vector_model
    singles = queries[:SHARD_SINGLES]
    runs = {}
    for n_sh in (SHARDS, 1):
        t0 = time.perf_counter()
        eng.enable_sharded_serving(mesh=make_mesh(devices=["cuda:0"] * n_sh))
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        sdi = m.sharded
        check(len(sdi.mesh) == n_sh and len(sdi._replicas) == 1,
              "sharded: wrong mesh")
        epi = Stage1Count().__enter__()
        groups = []
        sdi._search_group = (lambda *a, _f=sdi._search_group:
                             groups.append(1) or _f(*a))
        merge_in, merges = {}, (sharding._stable_merge, sharding._lim_merge)

        def spy(name, f):
            def take(*a):
                merge_in.setdefault(name, tuple(
                    t.clone() if torch.is_tensor(t) else t for t in a))
                return f(*a)
            return take

        sharding._stable_merge = spy("score", merges[0])
        sharding._lim_merge = spy("lim", merges[1])
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _kernels.reset_launch_counts()
        walls, batches = [], []
        with BlockCount(ck) as blocks:
            for i in (0, BATCH):
                t0 = time.perf_counter()
                batches += eng.search_batch([it.Query(q, 10)
                                             for q in queries[i:i + BATCH]])
                torch.cuda.synchronize()
                walls.append(time.perf_counter() - t0)
            counts = dict(_kernels.launch_counts)
        epi.__exit__()
        del sdi._search_group
        sharding._stable_merge, sharding._lim_merge = merges
        n_groups = len(groups)
        check_per_block(counts, blocks.n, f"sharded ({n_sh} shards)",
                        lcs=False)
        epi.check(counts, f"sharded ({n_sh} shards)")
        swalls, single = [], []
        for q in singles:
            t0 = time.perf_counter()
            single.append(eng.search(it.Query(q, 10)))
            torch.cuda.synchronize()
            swalls.append(time.perf_counter() - t0)
        peak = torch.cuda.max_memory_allocated()
        runs[n_sh] = (flatten(batches), flatten(single))
        p50, p95 = percentiles_ms(swalls)
        per_group = counts["stage1_scatter_lanes"] / max(n_groups, 1)
        log(f"[sharded] {n_sh} shard(s) on one card (n_pad {sdi.n_pad}, "
            f"shard {sdi.shard_size} docs; built in {build_s:.1f} s): two "
            f"search_batch of {BATCH} in {[round(w * 1e3, 1) for w in walls]}"
            f" ms wall; {len(single)} single search p50 {p50:.1f} ms, p95 "
            f"{p95:.1f} ms; {n_groups} Stage-1 groups in the batches, lane "
            f"kernel launches {counts['stage1_scatter_lanes']} "
            f"({per_group:g} per group); peak device memory {peak} B "
            f"({peak / 2**30:.2f} GiB)")
        check(n_groups > 0 and counts["stage1_scatter_lanes"]
              == n_sh * n_groups,
              f"sharded: {counts['stage1_scatter_lanes']} lane launches for "
              f"{n_groups} groups of {n_sh} shards")
        if n_sh == SHARDS:
            sharded_counts = counts
            merge_times = shard_merge_check(torch, _kernels, merge_in)
            found = check_results(batches, N_DOCS, "sharded batch")
            check(found >= len(batches) * 0.9,
                  f"sharded: only {found}/{len(batches)} found anything")
    eng.disable_sharded_serving()
    check(m.sharded is None, "sharded: still sharded")
    for what, i in (("search_batch", 0), ("search", 1)):
        bad = [q for q, a, b in zip(queries, runs[SHARDS][i], runs[1][i])
               if a != b]
        check(not bad, f"sharded {what}: {SHARDS} shards differ from one on "
              f"{len(bad)} queries, e.g. {bad[:3]}")
    same = sum(a == b for a, b in zip(runs[SHARDS][0],
                                      flatten(resident[0] + resident[1])))
    log(f"[sharded] {SHARDS} shards identical to a one-shard mesh on "
        f"{2 * BATCH} batch queries and {len(singles)} single queries; "
        f"lists equal to phase 4's resident lists on {same}/{2 * BATCH} "
        f"(the sharded route has no host Stage 1, pre-filter or device "
        f"LCS)")
    return sharded_counts, merge_times


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


def epilogue_entry(name, counts, paths, per_batch, ek2) -> dict:
    """The ``kernels`` line's entry of an epilogue kernel: its main-path
    launches, and the numbers of the first input of phase 2 that ran it
    (the bench group; the large-vocabulary group where the bench group has
    no fuzzy groups), with every input's under "by_input"."""
    label, row = next((lb, runs[name]) for lb, runs in ek2.items()
                      if name in runs)
    return {"name": name, "route": "cuda",
            "source": f"infidex_tpu_torch/csrc/{name}.cu",
            "replaces": EPILOGUE_REPLACES[name],
            "launches": counts[name], "launches_per_batch": counts[name] / 4,
            "launches_by_path": paths(name),
            "launches_per_batch_by_path": per_batch(name),
            "max_abs_err": row["max_abs_err"], "ms": row["ms"],
            "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"], "library_ms": row["library_ms"],
            "input": label,
            "by_input": {lb: runs[name] for lb, runs in ek2.items()
                         if name in runs}}


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

    # the script drives the repository it lies in: alone, it stops here
    root = os.path.dirname(os.path.abspath(__file__))
    missing = [name for name in ("bench.py", "infidex_tpu_torch")
               if not os.path.exists(os.path.join(root, name))]
    if missing:
        print(f"chip_smoke: {' and '.join(missing)} not found beside "
              f"{os.path.abspath(__file__)}; run it from the root of the "
              f"repository", file=sys.stderr)
        return 2

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this check needs one "
              "CUDA card", file=sys.stderr)
        return 2
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
    build_report = _kernels.ptxas_report
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
    bench_spy = first_block_args(torch, it, eng, queries)
    long_spy, long_counts = timed("2 long titles", long_titles_phase, torch,
                                  it, runtime, bench, _kernels)
    gk2 = timed("2 gather kernel", gather_phase, torch, bench_spy, long_spy,
                _kernels)
    pk2 = timed("2 pair kernel", pair_phase, torch, bench_spy, long_spy,
                _kernels)
    ck2 = timed("2 cascade kernel", cascade_phase, torch, bench_spy, long_spy,
                _kernels)
    fk2 = timed("2 fusion kernel", fusion_phase, torch, bench_spy, long_spy,
                _kernels)
    ek2 = timed("2 stage1 epilogue kernels", epilogue_phase, torch, it, eng,
                queries, _kernels)
    del bench_spy, long_spy
    timed("3 cross-device", cross_device_phase, it, runtime, bench, _kernels)
    counts, resident = timed("4 main", main_phase, torch, it, eng, queries,
                             _kernels)
    if args.recall:
        timed("5 recall", recall_phase, it, eng, queries, bench)
    timed("6 single queries", single_query_phase, it, eng, queries)
    single_counts, xk = timed("13 device single queries",
                              device_single_phase, torch, it, runtime, bench,
                              eng, queries, _kernels)
    pool_counts, pk = timed("11 pool scoring", pool_phase, torch, it, eng,
                            queries, resident, _kernels)
    shard_counts, shard_merges = timed("12 sharded", sharded_phase, torch,
                                       it, eng, queries, resident, _kernels)
    big, big_titles, vocab, fk, vocab_counts, ek2["large vocabulary"] = timed(
        "7 large vocabulary", big_vocab_phase, torch, it, bench, _kernels)
    timed("8 writes", writes_phase, torch, it, bench, big, big_titles, vocab)
    del big
    timed("8 append parity", append_parity_phase, it, runtime, bench)
    seg_counts = timed("9 segments", segments_phase, torch, it, eng,
                       queries, resident[0], _kernels, root)
    del eng
    timed("10 facets", facets_phase, torch, it, bench)
    by_path = {"main": counts, "large vocabulary": vocab_counts,
               "segments": seg_counts, "pool scoring": pool_counts,
               "sharded": shard_counts, "long titles": long_counts}
    log(f"[end] kernel launches by path: {by_path}; total "
        f"{time.perf_counter() - T_START:.1f} s")
    check("jax" not in sys.modules and not any(
        m.startswith(("jax.", "jaxlib", "infidex_tpu.")) for m in sys.modules),
        "the port imported jax or the reference package")
    ref_files = loaded_from(os.path.join(root, "infidex_tpu") + os.sep)
    check(not ref_files, f"loaded from the JAX package's directory: "
          f"{ref_files}")

    # the main path served 4 batches (2 search_batch, 2 in search_many);
    # the large-vocabulary, pool-scoring and sharded paths 2 each, the
    # segments path 1
    batches = {"main": 4, "large vocabulary": 2, "segments": 1,
               "pool scoring": 2, "sharded": 2, "long titles": 2}

    def paths(name):
        return {p: c[name] for p, c in by_path.items()}

    def per_batch(name):
        return {p: c[name] / batches[p] for p, c in by_path.items()}

    main_cascade = next(k for k, v in ck2.items() if v["origin"] == "bench")
    main_pairs = main_cascade + " block"

    kernels = [{
        "name": "stage1_scatter_lanes", "route": "cuda",
        "source": "infidex_tpu_torch/csrc/stage1_lanes.cu",
        "replaces": "infidex_tpu/ops/stage1_lanes.py:184",
        "launches": counts["stage1_scatter_lanes"],
        "launches_per_batch": counts["stage1_scatter_lanes"] / 4,
        "launches_by_path": paths("stage1_scatter_lanes"),
        "launches_per_batch_by_path": per_batch("stage1_scatter_lanes"),
        "max_abs_err": k["max_abs_err"], "ms": k["ms"],
        "plain_ms": k["plain_ms"], "bound_ms": k["bound_ms"],
        "bound_by": k["bound_by"], "library_ms": None,
        "scatter_only_ms": k["scatter_ms"]}, {
        "name": "fuzzy_match", "route": "cuda",
        "source": "infidex_tpu_torch/csrc/fuzzy_match.cu",
        "replaces": "infidex_tpu/ops/fuzzy.py:60",
        "launches": vocab_counts["fuzzy_match"],
        "launches_per_batch": vocab_counts["fuzzy_match"] / 2,
        "launches_by_path": paths("fuzzy_match"),
        "max_abs_err": fk["max_abs_err"], "ms": fk["ms"],
        "plain_ms": fk["plain_ms"], "bound_ms": fk["bound_ms"],
        "bound_by": fk["bound_by"], "library_ms": None}, {
        "name": "pool_score", "route": "cuda",
        "source": "infidex_tpu_torch/csrc/pool_score.cu",
        "replaces": "infidex_tpu/index/device.py:699",
        "launches": pool_counts["pool_score"],
        "launches_per_batch": pool_counts["pool_score"] / 2,
        "launches_by_path": paths("pool_score"),
        "max_abs_err": pk["max_abs_err"], "ms": pk["ms"],
        "plain_ms": pk["plain_ms"], "bound_ms": pk["bound_ms"],
        "bound_by": pk["bound_by"], "library_ms": None}, {
        # the numbers of the bench batch's first block (the small class,
        # the one the main path's blocks are); every block of the kernel
        # phase under "by_block"
        "name": "coverage_gather", "route": "cuda",
        "source": "infidex_tpu_torch/csrc/coverage_gather.cu",
        "replaces": "infidex_tpu/ops/coverage_kernel.py:581",
        "launches": counts["coverage_gather"],
        "launches_per_batch": counts["coverage_gather"] / 4,
        "launches_by_path": paths("coverage_gather"),
        "launches_per_batch_by_path": per_batch("coverage_gather"),
        "max_abs_err": gk2[main_cascade]["max_abs_err"],
        "ms": gk2[main_cascade]["ms"],
        "device_ms": gk2[main_cascade]["device_ms"],
        "plain_ms": gk2[main_cascade]["plain_ms"],
        "bound_ms": gk2[main_cascade]["bound_ms"],
        "bound_by": gk2[main_cascade]["bound_by"], "library_ms": None,
        "by_block": gk2}, {
        # as above: the block's one launch for both sets of query tokens,
        # as the main path calls it; its traced launch, and the registers
        # and spills of each build that ptxas reported
        "name": "coverage_pairs", "route": "cuda",
        "source": "infidex_tpu_torch/csrc/coverage_pairs.cu",
        "replaces": "infidex_tpu/ops/coverage_kernel.py:466",
        "launches": counts["coverage_pairs"],
        "launches_per_batch": counts["coverage_pairs"] / 4,
        "launches_by_path": paths("coverage_pairs"),
        "launches_per_batch_by_path": per_batch("coverage_pairs"),
        "max_abs_err": pk2[main_pairs]["max_abs_err"],
        "ms": pk2[main_pairs]["ms"],
        "device_ms": pk2[main_pairs]["device_ms"],
        "plain_ms": pk2[main_pairs]["plain_ms"],
        "bound_ms": pk2[main_pairs]["bound_ms"],
        "bound_by": pk2[main_pairs]["bound_by"], "library_ms": None,
        "launch": pk2[main_pairs]["launch"],
        "ptxas": _kernels.ptxas_resources(build_report,
                                          "coverage_pairs_kernel"),
        "by_block": pk2}, {
        "name": "coverage_cascade", "route": "cuda",
        "source": "infidex_tpu_torch/csrc/coverage_cascade.cu",
        "replaces": "infidex_tpu/ops/coverage_kernel.py:689",
        "launches": counts["coverage_cascade"],
        "launches_per_batch": counts["coverage_cascade"] / 4,
        "launches_by_path": paths("coverage_cascade"),
        "launches_per_batch_by_path": per_batch("coverage_cascade"),
        "max_abs_err": ck2[main_cascade]["max_abs_err"],
        "ms": ck2[main_cascade]["ms"],
        "device_ms": ck2[main_cascade]["device_ms"],
        "plain_ms": ck2[main_cascade]["plain_ms"],
        "bound_ms": ck2[main_cascade]["bound_ms"],
        "bound_by": ck2[main_cascade]["bound_by"], "library_ms": None,
        "by_block": ck2}] + [{
        "name": name, "route": "cuda",
        "source": f"infidex_tpu_torch/csrc/{name}.cu",
        "replaces": f"infidex_tpu/ops/coverage_kernel.py:{line}",
        "launches": counts[name], "launches_per_batch": counts[name] / 4,
        "launches_by_path": paths(name),
        "launches_per_batch_by_path": per_batch(name),
        "max_abs_err": fk2[name][main_cascade]["max_abs_err"],
        "ms": fk2[name][main_cascade]["ms"],
        "device_ms": fk2[name][main_cascade]["device_ms"],
        "plain_ms": fk2[name][main_cascade]["plain_ms"],
        "bound_ms": fk2[name][main_cascade]["bound_ms"],
        "bound_by": fk2[name][main_cascade]["bound_by"], "library_ms": None,
        "by_block": fk2[name]}
        for name, line in (("coverage_lcs", 1038),
                           ("coverage_fusion", 1079))] + [
        epilogue_entry(name, counts, paths, per_batch, ek2)
        for name in EPILOGUE_REPLACES]
    kernels.append({
        # the single-query device path's launches (phase 13); the numbers
        # of its largest extras set, both inputs under "by_input"
        "name": "stage1_extras", "route": "cuda",
        "source": "infidex_tpu_torch/csrc/stage1_extras.cu",
        "replaces": "infidex_tpu/index/device.py:302",
        "launches": single_counts["stage1_extras"],
        "launches_single_path": single_counts,
        "max_abs_err": xk["max_abs_err"], "ms": xk["ms"],
        "plain_ms": xk["plain_ms"], "bound_ms": xk["bound_ms"],
        "bound_by": xk["bound_by"], "library_ms": xk["library_ms"],
        **{key: xk[key] for key in (
            "origin", "by_input", "search_p50_ms", "search_p95_ms",
            "sharded_p50_ms", "sharded_p95_ms",
            "search_device_ms_by_kernel")}})
    # the top-k kernel also merges the shards' lists (phase 12)
    next(e for e in kernels if e["name"] == "stage1_topk")["shard_merges"] = \
        shard_merges
    print(json.dumps({"kernels": kernels}), flush=True)
    print(nvidia_smi_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
