"""The port's redesigned hand kernels against their earlier designs, in
one run.

    python3 scripts/kernel_ab.py [--old-csrc DIR] [--old-pool-csrc DIR]
                                 [--old-edit-csrc DIR] [--old-cov-csrc DIR]
                                 [--gather]
                                 [--out DIR] [--reps N]

``--old-csrc`` holds the earlier lane and match kernels
(``stage1_lanes.cu`` and ``fuzzy_match.cu`` with the C interfaces of
commit c7be62e: the lane kernel launched once per term rank over a
rank-major table, the match kernel one block per token row), e.g.
unpacked with ``git archive c7be62e infidex_tpu_torch/csrc``;
``--old-pool-csrc`` the earlier pool kernel (``pool_score.cu`` of commit
430610c: one thread per slot, 21 global probes per term; same C
interface as today's); ``--old-edit-csrc`` the earlier edit-distance
kernel (``edit_distances.cu`` and ``edit_distances_cell.cuh`` of commit
ce4e9c9: one thread per (query token, doc token, candidate), five int32
tensors out), e.g. ``git archive ce4e9c9 infidex_tpu_torch/csrc |
tar -x --strip-components=2 -C build/old_edit``; ``--old-cov-csrc`` the
earlier pair, fake-LCS, fusion and cascade kernels (``coverage_pairs.cu``,
``coverage_lcs.cu``, ``coverage_fusion.cu``, ``coverage_cascade.cu`` and
their cell headers; same C interfaces as today's): of commit 705596b, one
thread per candidate in the last three, e.g. ``git archive 705596b
infidex_tpu_torch/csrc | tar -x --strip-components=2 -C build/old_cov``,
of commit 22ca07e, where only the cascade was still one thread per
candidate, or of commit 051d756, the pair kernel of one thread a cell
(two launches a coverage block, band sweeps); a kernel whose sources
are the same in both directories is skipped. A copy of today's
``csrc/`` with one setting edited (e.g. the pair kernel's
``kBlocksPerSm``) times that variant against today's build.
``--gather`` times the gather kernel
(``csrc/coverage_gather.cu``) beside the eager gather it replaces. Only
the pairs whose directory or flag is given run. The
script builds the old sources with the same ``nvcc`` flags as the port's
library, then, on one card:

* lanes: the chunk table of the first 128-query group of bench.py's
  corpus at 1,000,000 docs (chip_smoke.py phase 2's input);
* match: the unknown tokens of the first 128-query batch of the
  large-vocabulary corpus (chip_smoke.py phase 7's input);
* pool: the pools the card scores when two 128-query batches of that
  corpus are served with ``POOL_DEVICE="1"`` (chip_smoke.py phase 11's
  input).

* edit: the first coverage block of every shape of the first 128-query
  batch of bench.py's corpus and of chip_smoke.py's long-title batches
  (phase 2's inputs): the earlier kernel's five distance tensors against
  the pair kernel's one packed word (``csrc/coverage_pairs.cu``), whose
  distance fields must equal them; the pair kernel does more (the six
  relations and the prefix length), so its relations-only build is timed
  beside it. Besides the times of calls in turns, each kernel's device
  time alone (torch.profiler).

* cov: the same blocks as edit, for the pair kernel (each set of query
  tokens alone, and a block's two sets: the earlier design's two launches
  beside today's one and today's two), the cascade, the fake-LCS and the
  fusion kernel (``csrc/coverage_pairs.cu``, ``csrc/coverage_cascade.cu``,
  ``csrc/coverage_lcs.cu``, ``csrc/coverage_fusion.cu``): the earlier
  design beside today's, both
  through the port's wrapper (``lib=``), each kernel's device time alone
  (torch.profiler) and its traced launch geometry, in turns as well, and
  the registers, spills and shared memory ``nvcc -Xptxas=-v`` reports for
  both designs' kernels (today's gather kernel's too).

* gather: the same blocks, the gather kernel beside the eager gather
  (``gather_block_plain`` on the card): equal fields, events in turns,
  and the device time of the eager gather's kernels summed beside the
  kernel's.

The pool part also reports how long the narrowed ranges of the run's
tiles are.

Each pair must give the same bits; then each is timed in turns (old,
new, new, old), ``--reps`` launches a turn, with CUDA events. Prints one
JSON object and writes it to ``--out``/kernel_ab.json.
"""

import argparse
import ctypes
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

BATCH = 128


def _nvcc_old(src_dir: str, names, out_dir: str, so_name: str,
              ptxas: list = None):
    """``names`` of ``src_dir`` built with the port's nvcc flags; with a
    list for ``ptxas``, ``-Xptxas=-v`` too, its report appended there."""
    from infidex_tpu_torch.ops import _kernels

    so = os.path.join(out_dir, so_name)
    os.makedirs(out_dir, exist_ok=True)
    verbose = ["-Xptxas=-v"] if ptxas is not None else []
    res = subprocess.run([_kernels._nvcc(), *verbose, *_kernels.NVCC_FLAGS,
                          "-o", so,
                          *(os.path.join(src_dir, f) for f in names)],
                         capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed:\n{res.stdout}\n{res.stderr}")
    if ptxas is not None:
        ptxas.append(res.stdout + res.stderr)
    return ctypes.CDLL(so)


COV_SOURCES = ("coverage_lcs.cu", "coverage_fusion.cu",
               "coverage_cascade.cu", "coverage_pairs.cu")
COV_KERNELS = ("coverage_lcs_kernel", "coverage_fusion_kernel",
               "coverage_cascade_kernel", "coverage_gather_kernel",
               "coverage_pairs_kernel")
#: the cell header of each kernel whose name is not the kernel's
CELL_HEADERS = {"coverage_pairs": "edit_distances_cell.cuh"}


def kernel_resources(report: str) -> dict:
    """Registers, spill bytes and static shared memory of each coverage
    kernel in an ``nvcc -Xptxas=-v`` report, by kernel (its template
    arguments, (L, D) or D or L, in the name)."""
    from infidex_tpu_torch.ops import _kernels

    return _kernels.ptxas_resources(report, *COV_KERNELS)


def build_old_cov(src_dir: str, out_dir: str):
    """The earlier fake-LCS, fusion and cascade kernels (today's C
    interfaces), and the ptxas resources of the old and new designs'
    kernels."""
    from infidex_tpu_torch.ops import _kernels

    reports = []
    lib = _kernels.bind(_nvcc_old(src_dir, COV_SOURCES, out_dir,
                                  "libinfidex_cov_old.so", reports))
    _nvcc_old(_kernels._CSRC, COV_SOURCES + ("coverage_gather.cu",), out_dir,
              "libinfidex_cov_new.so", reports)
    return lib, {"old": kernel_resources(reports[0]),
                 "new": kernel_resources(reports[1])}


def _bits(torch, out):
    """A kernel's result as a list of tensors, f32 by its bits."""
    outs = out if isinstance(out, tuple) else (out,)
    return [t.view(torch.int32) if t.dtype == torch.float32 else t
            for t in outs]


def changed(src_dir: str, name: str) -> bool:
    """Whether kernel ``name``'s source or cell header differs between
    ``src_dir`` and the port's csrc/."""
    from infidex_tpu_torch.ops import _kernels

    for f in (f"{name}.cu", CELL_HEADERS.get(name, f"{name}_cell.cuh")):
        with open(os.path.join(src_dir, f), "rb") as a, \
                open(os.path.join(_kernels._CSRC, f), "rb") as b:
            if a.read() != b.read():
                return True
    return False


def cov_ab(torch, cs, spies, lib, reps: int, src_dir: str) -> dict:
    """The earlier fake-LCS, fusion and cascade kernels beside today's on
    the first coverage block of every shape of a bench batch and of
    chip_smoke.py's long-title batches: equal bits, then events and device
    times (the kernel alone, torch.profiler), each in turns old, new, new,
    old. A kernel whose sources ``src_dir`` holds unchanged is not timed.
    ``spies``: ``block_spies``."""
    from infidex_tpu_torch.ops import _kernels

    bench_spy, long_spy = spies
    out = {}
    for name, which, kernel in (
            ("coverage_pairs", "pairs", "coverage_pairs_kernel"),
            ("coverage_pairs", "fpairs", "coverage_pairs_kernel"),
            ("coverage_cascade", "cascade", "coverage_cascade_kernel"),
            ("coverage_lcs", "lcs", "coverage_lcs_kernel"),
            ("coverage_fusion", "fusion", "coverage_fusion_kernel")):
        if not changed(src_dir, name):
            print(f"[cov] {name}: the same sources in both directories, "
                  f"not timed", flush=True)
            continue
        by_block = {}
        wrapper = getattr(_kernels, name)
        # the pair kernel's calls for one set of query tokens end in their
        # distances flag
        flag = ((which == "pairs",) if name == "coverage_pairs" else ())
        for label, _, shape, a in cs.kernel_blocks(bench_spy, long_spy,
                                                   which):
            a = tuple(a) + flag
            # all through the port's wrapper: the same checks on each side
            fns = {"old": lambda a=a: wrapper(*a, lib=lib),
                   "new": lambda a=a: wrapper(*a)}
            results = {k: _bits(torch, fn()) for k, fn in fns.items()}
            torch.cuda.synchronize()
            same = {k: all(torch.equal(x, y) for x, y in
                           zip(r, results["new"]))
                    for k, r in results.items()}
            times = in_turns(torch, cs, fns, reps)
            order = ["old", "new", "new", "old"]
            launches = []
            dev = cs.device_ms_each(torch, [fns[k] for k in order], kernel,
                                    reps, launches)
            device_ms, launch = {}, {}
            for k, ms, ln in zip(order, dev, launches):
                device_ms.setdefault(k, []).append(ms)
                launch[k] = ln
            n_c = int(results["new"][-1].shape[-1])
            by_block[label] = dict(
                shape=list(shape), candidates=n_c,
                bit_equal=all(same.values()), ms=times,
                device_ms=device_ms, launch=launch)
            print(f"[cov] {name}, {label} (C {n_c}): bit-equal {same}; "
                  f"device ms {device_ms}; events ms {times}; launch "
                  f"{launch}", flush=True)
        out[name if name != "coverage_pairs" else f"{name} {which}"] = \
            by_block
    if changed(src_dir, "coverage_pairs"):
        out["coverage_pair_block"] = pair_block_ab(torch, cs, spies, lib,
                                                   reps)
    return dict(bit_equal=all(b["bit_equal"] for v in out.values()
                              for b in v.values()), **out)


def pair_block_ab(torch, cs, spies, lib, reps: int) -> dict:
    """A coverage block's pair words as the main path asks for them (the
    Q tokens with distances, the fusion tokens without): the earlier
    design ("old": one launch where its library has the block entry, else
    its two launches), today's one launch for both ("new") and today's
    kernel called twice ("two"), on the first block of every shape: equal
    words, then the device time of all the kernels a call launches
    (torch.profiler) and events, in turns old, new, two, two, new,
    old."""
    from infidex_tpu_torch.ops import _kernels

    bench_spy, long_spy = spies
    out = {}
    for label, _, shape, a in cs.kernel_blocks(bench_spy, long_spy,
                                               "pair_blocks"):
        q_set, fq_set, *doc = a
        fns = {"old": (
                   (lambda a=a: _kernels.coverage_pair_block(*a, lib=lib))
                   if hasattr(lib, "coverage_pair_block") else
                   (lambda: (
                       _kernels.coverage_pairs(*q_set, *doc, True, lib=lib),
                       _kernels.coverage_pairs(*fq_set, *doc, False,
                                               lib=lib)))),
               "new": lambda a=a: _kernels.coverage_pair_block(*a),
               "two": lambda: (_kernels.coverage_pairs(*q_set, *doc, True),
                               _kernels.coverage_pairs(*fq_set, *doc,
                                                       False))}
        results = {k: fn() for k, fn in fns.items()}
        torch.cuda.synchronize()
        same = {k: all(torch.equal(x, y) for x, y in zip(r, results["new"]))
                for k, r in results.items()}
        order = ["old", "new", "two"]
        order += order[::-1]
        device, events = {}, {}
        for k in order:
            ms, n = cs.device_total_ms(torch, fns[k], reps)
            device.setdefault(k, []).append(ms)
            events.setdefault(k, []).append(cs.cuda_ms(torch, fns[k], reps))
        n_c = int(doc[0].shape[-1])
        out[label] = dict(shape=list(shape), candidates=n_c,
                          bit_equal=all(same.values()), device_ms=device,
                          ms=events)
        print(f"[pair block] {label} (C {n_c}): bit-equal {same}; device "
              f"ms {device}; events ms {events}", flush=True)
    return out


def block_spies(torch, cs, it, bench, runtime, eng, queries):
    """The first coverage block of every shape of a bench batch and of
    chip_smoke.py's long-title batches (two ``BlockSpy``s)."""
    from infidex_tpu_torch.ops import _kernels

    bench_spy = cs.first_block_args(torch, it, eng, queries)
    long_spy, _ = cs.long_titles_phase(torch, it, runtime, bench, _kernels)
    return bench_spy, long_spy


def gather_ab(torch, cs, spies, reps: int) -> dict:
    """The gather kernel beside the eager gather it replaces
    (``gather_block_plain`` on the card) on the first coverage block of
    every shape of a bench batch and of chip_smoke.py's long-title
    batches: equal fields, then events (eager, kernel, kernel, eager) and
    device times (the eager gather's kernels summed, the kernel alone,
    torch.profiler, in the same turns). ``spies``: ``block_spies``."""
    from infidex_tpu_torch.ops import coverage_kernel as ck

    bench_spy, long_spy = spies
    out = {}
    for label, _, shape, a in cs.kernel_blocks(bench_spy, long_spy,
                                               "gather"):
        fns = {"old": lambda a=a: ck.gather_block_plain(*a),
               "new": lambda a=a: ck.gather_block(*a)}
        want, got = fns["old"](), fns["new"]()
        torch.cuda.synchronize()
        same = all(x.dtype == y.dtype and torch.equal(x, y)
                   for x, y in zip(want, got))
        times = in_turns(torch, cs, fns, reps)
        device = {"old": [], "new": []}
        kernels_a_call = {}
        for k in ("old", "new", "new", "old"):
            ms, n = cs.device_total_ms(torch, fns[k], reps)
            device[k].append(ms)
            kernels_a_call[k] = n
        nbytes, _ = cs.gather_bound(a, want)
        out[label] = dict(shape=list(shape), candidates=int(a[2].numel()),
                          bit_equal=bool(same), ms=times, device_ms=device,
                          kernels_a_call=kernels_a_call,
                          bound_ms=nbytes / cs.HBM_BYTES_S * 1e3,
                          bound_bytes=nbytes)
        print(f"[gather] {label} (C {a[2].numel()}): equal {same}; device "
              f"ms eager {device['old']}, kernel {device['new']}; kernels a "
              f"call {kernels_a_call}; events ms {times}; bound "
              f"{nbytes / cs.HBM_BYTES_S * 1e3:.4f} ms ({nbytes} B)",
              flush=True)
    return dict(bit_equal=all(v["bit_equal"] for v in out.values()),
                by_block=out)


def build_old(src_dir: str, out_dir: str):
    """The earlier lane and match kernels, bound with their C
    interfaces."""
    lib = _nvcc_old(src_dir, ("stage1_lanes.cu", "fuzzy_match.cu"), out_dir,
                    "libinfidex_kernels_old.so")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.stage1_scatter_lanes.argtypes = [p, p, p, p, p, i, p, p, p, p, p]
    lib.stage1_scatter_lanes.restype = i
    lib.fuzzy_match.argtypes = [p, p, p, p, p, p, p, i, i, i, p, p]
    lib.fuzzy_match.restype = i
    return lib


def build_old_pool(src_dir: str, out_dir: str):
    """The earlier pool kernel (today's C interface)."""
    from infidex_tpu_torch.ops import _kernels

    return _kernels.bind(_nvcc_old(src_dir, ("pool_score.cu",), out_dir,
                                   "libinfidex_pool_old.so"))


def build_old_edit(src_dir: str, out_dir: str):
    """The earlier edit-distance kernel, bound with its C interface."""
    lib = _nvcc_old(src_dir, ("edit_distances.cu",), out_dir,
                    "libinfidex_edit_old.so")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.edit_distances.argtypes = [p, p, p, p, p, p, i, i, i, i, p, p, p, p,
                                   p, p]
    lib.edit_distances.restype = i
    return lib


def old_edit(torch, lib, qc3, qr3, qlens2, chars_t, chars_rev_t, lens):
    n_l, n_d, n_c = chars_t.shape
    n_q = qc3.shape[0]
    outs = tuple(torch.empty((n_q, n_d, n_c), dtype=torch.int32,
                             device=chars_t.device) for _ in range(5))
    rc = lib.edit_distances(
        qc3.data_ptr(), qr3.data_ptr(), qlens2.data_ptr(),
        chars_t.data_ptr(), chars_rev_t.data_ptr(), lens.data_ptr(), n_q,
        n_l, n_d, n_c, *(o.data_ptr() for o in outs),
        torch.cuda.current_stream().cuda_stream)
    assert rc == 0, rc
    return outs


def edit_ab(torch, cs, it, bench, runtime, eng, queries, lib,
            reps: int) -> dict:
    """The earlier edit kernel beside the pair kernel on real blocks: the
    first coverage block of every shape of a bench batch and of
    chip_smoke.py's long-title batches."""
    from infidex_tpu_torch.ops import _kernels
    from infidex_tpu_torch.ops import editdistance_multi as ed

    bench_spy = cs.first_block_args(torch, it, eng, queries)
    long_spy, _ = cs.long_titles_phase(torch, it, runtime, bench, _kernels)
    out = {}
    for label, _, shape, a in cs.kernel_blocks(bench_spy, long_spy, "pairs"):
        old = old_edit(torch, lib, *a[:6])
        new = ed.unpack_distances(_kernels.coverage_pairs(*a, True))
        torch.cuda.synchronize()
        same = all(torch.equal(x, y) for x, y in zip(old, new))
        times = in_turns(torch, cs, {
            "old": lambda: old_edit(torch, lib, *a[:6]),
            "new": lambda: _kernels.coverage_pairs(*a, True)}, reps)
        # events around back-to-back calls hold the wrappers' host time
        # where a kernel is shorter than that: the kernels alone, too
        device = {
            name: cs.device_ms_each(torch, [fn], kernel, reps)[0]
            for name, fn, kernel in (
                ("old", lambda: old_edit(torch, lib, *a[:6]),
                 "edit_distances_kernel"),
                ("new", lambda: _kernels.coverage_pairs(*a, True),
                 "coverage_pairs_kernel"),
                ("new_relations_only",
                 lambda: _kernels.coverage_pairs(*a, False),
                 "coverage_pairs_kernel"))}
        out[label] = dict(shape=list(shape), candidates=int(a[0].shape[2]),
                          bit_equal=bool(same), ms=times, device_ms=device)
    return dict(bit_equal=all(v["bit_equal"] for v in out.values()),
                by_block=out)


def old_lanes(torch, lib, scores, cnt, ranked, docs, cfac) -> None:
    """The earlier lane kernel: one launch per term rank."""
    stream = torch.cuda.current_stream().cuda_stream
    for lo, hi in zip(ranked.bounds, ranked.bounds[1:]):
        rc = lib.stage1_scatter_lanes(
            ranked.off.data_ptr() + 4 * lo, ranked.vstart.data_ptr() + 4 * lo,
            ranked.vend.data_ptr() + 4 * lo, ranked.idf.data_ptr() + 4 * lo,
            ranked.base.data_ptr() + 4 * lo, hi - lo, docs.data_ptr(),
            cfac.data_ptr(), scores.data_ptr(), cnt.data_ptr(), stream)
        assert rc == 0, rc


def old_match(torch, lib, sig, vpop, vlen, elig, qsig, qpop, qlen, cap):
    """The earlier match kernel: one block per token row."""
    out = torch.empty((qsig.shape[0], cap), dtype=torch.int32,
                      device=sig.device)
    rc = lib.fuzzy_match(sig.data_ptr(), vpop.data_ptr(), vlen.data_ptr(),
                         elig.data_ptr(), qsig.data_ptr(), qpop.data_ptr(),
                         qlen.data_ptr(), qsig.shape[0], sig.shape[0], cap,
                         out.data_ptr(), torch.cuda.current_stream()
                         .cuda_stream)
    assert rc == 0, rc
    return out


def in_turns(torch, cs, fns: dict, reps: int) -> dict:
    """ms of each callable, timed old, new, the others, the others in
    reverse, new, old."""
    rest = [k for k in fns if k not in ("old", "new")]
    times = {k: [] for k in fns}
    for name in ("old", "new", *rest, *reversed(rest), "new", "old"):
        times[name].append(cs.cuda_ms(torch, fns[name], reps=reps))
    return times


def bench_engine(cs, it, bench):
    """bench.py's corpus at 1,000,000 docs, indexed, and 256 queries."""
    titles = bench.make_corpus(cs.N_DOCS)
    queries = bench.make_queries(titles, 4 * BATCH)
    t0 = time.perf_counter()
    eng = cs.build_engine(it, titles)
    print(f"[bench corpus] {cs.N_DOCS} docs indexed in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    return eng, queries


def narrowed_ranges(built, jobs, tile: int = 256) -> dict:
    """How many postings of a term fall inside the doc span of a tile of
    ``tile`` consecutive pool slots, over every (tile, term) pair of
    ``jobs`` whose narrowed range is not empty."""
    import numpy as np

    lens = []
    for pool, term_ids, _ in jobs:
        pool = np.asarray(pool)
        firsts, lasts = pool[::tile], pool[np.minimum(
            np.arange(tile - 1, pool.size + tile - 1, tile), pool.size - 1)]
        for t in np.asarray(term_ids, np.int64):
            p = built.postings_docs[built.term_offsets[t]:
                                    built.term_offsets[t + 1]]
            lens.append(np.searchsorted(p, lasts, "right")
                        - np.searchsorted(p, firsts, "left"))
    m = np.concatenate(lens)
    m = m[m > 0]
    q = np.percentile(m, [50, 90, 99])
    return dict(tile=tile, pairs=int(m.size), postings=int(m.sum()),
                mean=float(m.mean()), p50=float(q[0]), p90=float(q[1]),
                p99=float(q[2]), max=int(m.max()),
                share_up_to={str(c): float((m <= c).mean())
                             for c in (256, 1024, 2048, 4096, 16384)})


def pool_ab(torch, cs, it, eng, queries, lib, reps: int) -> dict:
    from infidex_tpu_torch.ops import _kernels

    jobs, _, _, _ = cs.serve_pool_batches(torch, it, eng, queries, _kernels)
    args = eng.vector_model.device.pool_args(jobs)
    args = (*args[:-1], args[-1].reshape(1))
    # both through the port's wrapper: the same checks on either side
    fns = {"old": lambda: _kernels.pool_score(*args, lib=lib),
           "new": lambda: _kernels.pool_score(*args)}
    old, new = (fns[name]().view(torch.int32) for name in ("old", "new"))
    torch.cuda.synchronize()
    times = in_turns(torch, cs, fns, reps)
    return dict(jobs=len(jobs), slots=list(args[0].shape),
                valid=int(args[1].sum()), term_slots=int(args[2].shape[1]),
                bit_equal=bool(torch.equal(old, new)), ms=times,
                narrowed=narrowed_ranges(eng.vector_model.built, jobs))


def lanes_ab(torch, cs, eng, queries, lib, reps: int) -> dict:
    from infidex_tpu_torch.index.device import split_batch_by_lanes
    from infidex_tpu_torch.ops import stage1_lanes as lanes

    m = eng.vector_model
    preps = [m.prepare_stage1(q) for q in queries[:BATCH]]
    lo, hi = split_batch_by_lanes(m.device.built, preps)[0]
    chunks = m.device.stage1_chunks(preps[lo:hi])
    ranked = chunks.ranked()
    docs, cfac = m.device.postings_docs, m.device.cfac
    n = (hi - lo) * m.device.n_pad
    out = {}
    for name, fn in (("old", lambda s, c: old_lanes(torch, lib, s, c, ranked,
                                                    docs, cfac)),
                     ("new", lambda s, c: lanes.scatter_lanes(
                         s, c, chunks, docs, cfac))):
        s = torch.zeros(n, device=docs.device)
        c = torch.zeros(n, device=docs.device)
        fn(s, c)
        out[name] = (s.view(torch.int32), c)
    torch.cuda.synchronize()
    same = (torch.equal(out["old"][0], out["new"][0])
            and torch.equal(out["old"][1], out["new"][1]))
    s = torch.zeros(n, device=docs.device)
    c = torch.zeros(n, device=docs.device)
    times = in_turns(torch, cs, {
        "old": lambda: old_lanes(torch, lib, s, c, ranked, docs, cfac),
        "new": lambda: lanes.scatter_lanes(s, c, chunks, docs, cfac)}, reps)
    n_lanes = int((chunks.vend - chunks.vstart).sum())
    cells = int((out["new"][1] > 0).sum())
    return dict(queries=hi - lo, ranks=len(ranked.bounds) - 1,
                chunks=int(chunks.off.numel()), lanes=n_lanes, cells=cells,
                bit_equal=same, ms=times,
                launches={"old": len(ranked.bounds) - 1, "new": 1})


def match_ab(torch, cs, it, bench, lib, reps: int) -> dict:
    from infidex_tpu_torch.ops import _kernels

    titles, _ = cs.big_vocab_corpus(bench, cs.N_DOCS)
    queries = bench.make_queries(titles, BATCH)
    t0 = time.perf_counter()
    eng = cs.build_engine(it, titles)
    print(f"[match] large-vocabulary corpus indexed in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    m = eng.vector_model
    sig = m._ensure_sig_index()
    tokens = []
    m.prime_fuzzy_cache = tokens.extend
    try:
        eng._pipeline._prime_fuzzy_tokens(queries)
    finally:
        del m.prime_fuzzy_cache
    args = sig.match_args(tokens)
    new = _kernels.fuzzy_match(*args)
    old = old_match(torch, lib, *args)
    torch.cuda.synchronize()
    times = in_turns(torch, cs, {
        "old": lambda: old_match(torch, lib, *args),
        "new": lambda: _kernels.fuzzy_match(*args)}, reps)
    return dict(rows=int(args[4].shape[0]), slots=sig.v_pad, cap=args[7],
                ids_out=int((new < sig.v_pad).sum()),
                bit_equal=bool(torch.equal(old, new)), ms=times)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--old-csrc")
    ap.add_argument("--old-pool-csrc")
    ap.add_argument("--old-edit-csrc")
    ap.add_argument("--old-cov-csrc")
    ap.add_argument("--gather", action="store_true",
                    help="the gather kernel beside the eager gather")
    ap.add_argument("--out", default=os.path.join(ROOT, "build", "kernel_ab"))
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("kernel_ab: needs a CUDA card", file=sys.stderr)
        return 2
    import bench
    import chip_smoke as cs
    import infidex_tpu_torch as it
    from infidex_tpu_torch import runtime
    from infidex_tpu_torch.ops import _kernels

    runtime.set_device("cuda")
    card = cs.nvidia_smi_line()
    _kernels.build()
    if not (args.old_csrc or args.old_pool_csrc or args.old_edit_csrc
            or args.old_cov_csrc or args.gather):
        ap.error("give --old-csrc, --old-pool-csrc, --old-edit-csrc, "
                 "--old-cov-csrc or --gather")
    result = dict(card=card, torch=torch.__version__)
    eng, queries = bench_engine(cs, it, bench)
    if args.old_cov_csrc or args.gather:
        spies = block_spies(torch, cs, it, bench, runtime, eng, queries)
    if args.old_cov_csrc:
        lib, resources = build_old_cov(args.old_cov_csrc, args.out)
        print(f"[cov] ptxas: {json.dumps(resources)}", flush=True)
        result["cov"] = cov_ab(torch, cs, spies, lib, args.reps,
                               args.old_cov_csrc)
        result["cov"]["resources"] = resources
    if args.gather:
        result["gather"] = gather_ab(torch, cs, spies, args.reps)
    if args.old_edit_csrc:
        lib = build_old_edit(args.old_edit_csrc, args.out)
        result["edit"] = edit_ab(torch, cs, it, bench, runtime, eng, queries,
                                 lib, args.reps)
    if args.old_pool_csrc:
        lib = build_old_pool(args.old_pool_csrc, args.out)
        result["pool"] = pool_ab(torch, cs, it, eng, queries, lib, args.reps)
    if args.old_csrc:
        lib = build_old(args.old_csrc, args.out)
        result["lanes"] = lanes_ab(torch, cs, eng, queries, lib, args.reps)
        del eng
        result["match"] = match_ab(torch, cs, it, bench, lib, args.reps)
    line = json.dumps(result)
    with open(os.path.join(args.out, "kernel_ab.json"), "w") as f:
        f.write(line + "\n")
    print(line, flush=True)
    return 0 if all(v["bit_equal"] for v in result.values()
                    if isinstance(v, dict)) else 1


if __name__ == "__main__":
    sys.exit(main())
