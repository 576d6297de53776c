"""The Stage-1 epilogue's top-k and LIM kernels on a card: quick checks of
a design, and today's kernels beside an earlier design, in turns.

    python3 scripts/epilogue_probe.py [--bench] [--sweep] [--trace]
                                      [--old-csrc DIR]
                                      [--old-fuzzy-csrc DIR] [--vocab]
                                      [--out DIR]

Without flags: builds the kernels and times (torch.profiler, five calls)
the top-k at k 500 and 20,000 on 128 rows of 2^20 scores with 15,000
positives each (beside ``torch.topk`` over the int64 keys) and on all-zero
rows, and the LIM rows with a dense class, with a sparse one (100 members
a row) and with a sparse one and 64 fuzzy groups; each result is compared
with its plain version.

``--bench`` adds chip_smoke.py's phase-2 input: the first Stage-1 group of
a 128-query batch of bench.py's corpus at 1,000,000 docs (indexed here,
~1-2 minutes of host time), after the fuzzy kernel and the pass, as the
main path hands it to the top-k (k 500 and 20,000) and the LIM rows (k
500, k2 256); and its first 8 rows and its first row (a small group, a
single query).

``--sweep`` times today's kernels at every slice count (1-16 blocks a
row; the top-k also with runs of 16,384 keys in shared memory) on each
input, so that the wrapper's slice rule can be checked.

``--trace`` builds the top-k kernel again with ``-DSTAGE1_TRACE`` (a
clock stamp at each phase's end, thread 0 of each block) and reports, on
each input, each phase's microseconds (``phase_us``).

``--old-csrc DIR`` holds an earlier design's ``stage1_topk.cu`` and
``stage1_lim.cu`` with their headers and the C interfaces of commit
3fa51bb (one block of 1024 threads a row), e.g. ``git archive 3fa51bb
infidex_tpu_torch/csrc | tar -x --strip-components=2 -C build/old_epi``
(unpacked under ``build/`` before a chip call: the copy there has no
``.git``). The script builds them with the port's nvcc flags and, on each
input, requires the old and today's kernels to give the same bits as the
plain version, then times them in turns (old, new, new, old).

``--old-fuzzy-csrc DIR`` holds an earlier ``stage1_fuzzy.cu`` with its
headers and today's C interface (commit 051d756: a mark launch, then a
block a group popcounting its row). On the bench group (``--bench``), on
each of its four shard windows and, with ``--vocab``, on the first group
of a batch of chip_smoke.py's large-vocabulary corpus (1,000,000 titles,
indexed here), both kernels go through the port's wrapper (``lib=``):
their bitsets and df must equal each other and the plain version; then
each call's device time, the wrapper's zeroing fill included (all its
kernels, torch.profiler), and the fuzzy kernels' alone, in turns (old,
new, new, old).

Prints the card's name and power limit first, then a line a measurement;
writes every number to ``--out``/epilogue_probe.json.
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

OLD_SOURCES = ("stage1_topk.cu", "stage1_lim.cu")


def build_old(src_dir: str, out_dir: str):
    """The earlier top-k and LIM kernels, with their own C interfaces
    (commit 3fa51bb's argument lists)."""
    from infidex_tpu_torch.ops import _kernels

    so = os.path.join(out_dir, "libinfidex_epilogue_old.so")
    os.makedirs(out_dir, exist_ok=True)
    res = subprocess.run([_kernels._nvcc(), *_kernels.NVCC_FLAGS, "-o", so,
                          *(os.path.join(src_dir, f) for f in OLD_SOURCES)],
                         capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed:\n{res.stdout}\n{res.stderr}")
    lib = ctypes.CDLL(so)
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.stage1_topk.argtypes = [p, ll, i, i, i, p, ll, p, p, p]
    lib.stage1_lim.argtypes = [p, ll, i, p, p, p, ll, p, p, p, i, ll, i, i,
                               i, i, p, p]
    lib.stage1_topk.restype = lib.stage1_lim.restype = i
    return lib


def build_old_fuzzy(src_dir: str, out_dir: str):
    """An earlier fuzzy-presence kernel with today's C interface."""
    from infidex_tpu_torch.ops import _kernels

    so = os.path.join(out_dir, "libinfidex_fuzzy_old.so")
    os.makedirs(out_dir, exist_ok=True)
    res = subprocess.run([_kernels._nvcc(), *_kernels.NVCC_FLAGS, "-o", so,
                          os.path.join(src_dir, "stage1_fuzzy.cu")],
                         capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed:\n{res.stdout}\n{res.stderr}")
    return _kernels.bind(ctypes.CDLL(so))


def fuzzy_ab(torch, cs, D, _kernels, old, groups: dict, reps: int) -> dict:
    """The earlier fuzzy kernel (``old``) beside today's on each group of
    ``groups`` (label -> (device index, fuzzy tables, group count)) over
    its whole window and its four shard windows: equal bits and df, equal
    to the plain version; then device ms with the zeroing and of the
    kernels alone, in turns."""
    out = {}
    for label, (di, fz, n_grp) in groups.items():
        n_pad = di.n_pad
        edges = [n_pad * k // 4 for k in range(5)]
        for lo, hi in [(0, n_pad)] + list(zip(edges, edges[1:])):
            args = (di.postings_docs, fz.d_starts, fz.d_group, fz.d_cum,
                    fz.n_lanes, n_grp, lo, hi)
            fns = {"old": lambda a=args: _kernels.stage1_fuzzy(*a, lib=old),
                   "new": lambda a=args: _kernels.stage1_fuzzy(*a)}
            got = {k: fn() for k, fn in fns.items()}
            dense = D.fuzzy_presence_plain(di.postings_docs, fz.starts,
                                           fz.lens, fz.group, n_grp, lo, hi)
            inside, past = cs.unpack_bits(torch, got["new"][0], hi - lo)
            row = dict(
                window=[lo, hi], groups=n_grp, lanes=int(fz.n_lanes),
                old_equal=all(torch.equal(a, b) for a, b in
                              zip(got["old"], got["new"])),
                equal=bool(torch.equal(inside, dense > 0) and not past
                           and torch.equal(got["new"][1],
                                           dense.sum(dim=1).int())),
                df_sum=int(got["new"][1].sum()))
            del got, dense, inside
            with_zeroing = {"old": [], "new": []}
            kernel_alone = {"old": [], "new": []}
            for k in ("old", "new", "new", "old"):
                with_zeroing[k].append(cs.device_total_ms(torch, fns[k],
                                                           reps)[0])
                kernel_alone[k].append(cs.kernel_ms(torch, fns[k],
                                                    "stage1_fuzzy_", reps)[0])
            row.update(with_zeroing_ms=with_zeroing,
                       kernel_ms=kernel_alone)
            key = f"{label}, window [{lo}, {hi})"
            out[key] = row
            print(f"fuzzy: {key}: {json.dumps(row)}", flush=True)
    return dict(bit_equal=all(r["old_equal"] and r["equal"]
                              for r in out.values()), by_window=out)


def vocab_group(torch, cs):
    """The first Stage-1 group of a 128-query batch of chip_smoke.py's
    large-vocabulary corpus: (device index, fuzzy tables, group count)."""
    import bench
    import infidex_tpu_torch as it

    t0 = time.perf_counter()
    titles, _ = cs.big_vocab_corpus(bench, cs.N_DOCS)
    queries = bench.make_queries(titles, cs.BATCH)
    m = cs.build_engine(it, titles).vector_model
    print(f"large-vocabulary index of {cs.N_DOCS} docs in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    preps = [p for p in map(m.prepare_stage1, queries) if p is not None]
    _, _, fz, n_grp = cs.stage1_group(torch, m.device, preps)
    return m.device, fz, n_grp


def build_trace(out_dir: str):
    """Today's top-k kernel built with -DSTAGE1_TRACE: thread 0 of each
    block of the first 64 rows stamps the card's clock at the kernel's
    start, at each select round's end and after the S compaction, the B
    placement, the sort and the merge (``stage1_topk_trace``)."""
    from infidex_tpu_torch.ops import _kernels

    so = os.path.join(out_dir, "libinfidex_topk_trace.so")
    os.makedirs(out_dir, exist_ok=True)
    res = subprocess.run([_kernels._nvcc(), *_kernels.NVCC_FLAGS,
                          "-DSTAGE1_TRACE", "-o", so,
                          os.path.join(_kernels._CSRC, "stage1_topk.cu")],
                         capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed:\n{res.stdout}\n{res.stderr}")
    lib = _kernels.bind(ctypes.CDLL(so))
    lib.stage1_topk_trace.argtypes = [ctypes.c_void_p]
    lib.stage1_topk_trace.restype = ctypes.c_int
    return lib


#: the trace's stamps, in the order the kernel writes them
STAMPS = ("round 0", "round 1", "round 2", "S", "B", "sort", "merge",
          "start")


def phase_us(torch, lib, scores, k: int) -> dict:
    """Each phase's microseconds in the top-k of ``scores`` (its first 64
    rows): per phase, the median and the largest over rows of the slowest
    block's time from the phase before (a round not taken counts 0), and
    the first row's by block."""
    import numpy as np
    from infidex_tpu_torch.ops import _kernels

    buf = np.zeros(64 * 16 * 8, np.uint64)
    _kernels.stage1_topk(scores, k, lib=lib)
    torch.cuda.synchronize()
    buf[:] = 0
    _kernels.stage1_topk(scores, k, lib=lib)
    torch.cuda.synchronize()
    assert lib.stage1_topk_trace(buf.ctypes.data) == 0
    slices = _kernels.topk_slices(*scores.shape, scores.device)
    t = buf.reshape(64, 16, 8)[:min(64, scores.shape[0]), :slices]
    t = t.astype(np.int64)
    start = t[:, :, 7].min(axis=1)
    prev = np.maximum(start[:, None] + 0 * t[:, :, 0], t[:, :, 7])
    out = {}
    for i, name in enumerate(STAMPS[:7]):
        done = t[:, :, i]
        taken = done > 0
        d = np.where(taken, done - prev, 0) / 1e3
        prev = np.where(taken, done, prev)
        worst = d.max(axis=1)
        out[name] = dict(median=float(np.median(worst)),
                         max=float(worst.max()),
                         row0=[float(v) for v in d[0]])
    out["row span"] = dict(
        median=float(np.median((prev.max(axis=1) - start) / 1e3)),
        max=float(((prev.max(axis=1) - start) / 1e3).max()))
    return out


def old_topk(torch, lib, scores, k: int):
    """The earlier top-k (shared-memory sorts up to 16,384 keys, a global
    scratch row of the power of two at or above k beyond)."""
    n_rows, width = scores.shape
    dev = scores.device
    cols = 1
    while cols < k:
        cols <<= 1
    cols = cols if cols > 16384 else 0
    scratch = (torch.empty((n_rows, cols), dtype=torch.int64, device=dev)
               if cols else None)
    out_s = torch.empty((n_rows, k), dtype=torch.float32, device=dev)
    out_i = torch.empty((n_rows, k), dtype=torch.int32, device=dev)
    rc = lib.stage1_topk(scores.data_ptr(), width, n_rows, k, 16384,
                         scratch.data_ptr() if cols else None, cols,
                         out_s.data_ptr(), out_i.data_ptr(),
                         torch.cuda.current_stream().cuda_stream)
    assert rc == 0, rc
    return out_s, out_i


def old_lim(torch, lib, cnt, live, thresh, tables, k_out, k2, window, pad):
    """The earlier LIM kernel on the same arguments as
    ``_kernels.stage1_lim`` (``tables``: bits, fidf, q_off, q_grp or
    Nones)."""
    n_q, width = cnt.shape
    bits, fidf, q_off, q_grp = tables
    has_fz = int(bits is not None)
    ptr = [t.data_ptr() if t is not None else None for t in tables]
    out = torch.empty((n_q, k_out), dtype=torch.int32, device=cnt.device)
    rc = lib.stage1_lim(cnt.data_ptr(), width, n_q, live.data_ptr(),
                        thresh.data_ptr(), ptr[0],
                        bits.shape[1] if has_fz else 0, ptr[1], ptr[2],
                        ptr[3], has_fz, window, k2, k_out, 0, pad,
                        out.data_ptr(), torch.cuda.current_stream()
                        .cuda_stream)
    assert rc == 0, rc
    return out


def synthetic(torch, D):
    """128 rows of 2^20 scores with 15,000 positives each, their counts
    (2 where positive), a live mask of ones; the LIM inputs: a dense class,
    a sparse one, and the sparse one with 64 fuzzy groups."""
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    n_q, n = 128, 1 << 20
    s = torch.zeros(n_q, n, device=dev)
    idx = torch.randint(0, n, (n_q, 15000), device=dev, generator=g)
    s.scatter_(1, idx, torch.rand(n_q, 15000, device=dev, generator=g) * 10)
    c = (s > 0).float() * 2
    live = torch.ones(n, device=dev)
    sparse = c.clone()
    sel = torch.randint(0, n, (n_q, 100), device=dev, generator=g)
    sparse.scatter_(1, sel, torch.full((n_q, 100), 3.0, device=dev))
    top = (sparse * live).max(dim=1).values
    # 64 fuzzy groups of ~2,000 docs, two a query for the first 32 queries
    n_grp, words = 64, n // 32
    dense = torch.zeros(n_grp, n, device=dev)
    dense.scatter_(1, torch.randint(0, n, (n_grp, 2000), device=dev,
                                    generator=g), 1.0)
    w = (dense.view(n_grp, words, 32).long()
         << torch.arange(32, device=dev)).sum(dim=2)
    bits = torch.where(w >= (1 << 31), w - (1 << 32), w).to(torch.int32)
    fidf = torch.rand(n_grp, device=dev, generator=g) + 0.1
    gq = torch.arange(n_grp, device=dev) // 2
    q_off = torch.zeros(n_q + 1, dtype=torch.int32, device=dev)
    q_off[1:] = torch.bincount(gq, minlength=n_q).cumsum(0).int()
    q_grp = torch.arange(n_grp, dtype=torch.int32, device=dev)
    fz_any = torch.zeros(n_q, n, dtype=torch.bool, device=dev)
    fz_any.index_put_((gq,), dense > 0, accumulate=True)
    none = (None,) * 4
    return {
        "synthetic": dict(
            scores=s, ks=(500, 20000),
            lims={"dense class": (c, live, (c * live).max(dim=1).values,
                                  None, none),
                  "sparse class": (sparse, live, top, None, none),
                  "sparse class, fuzzy groups": (
                      sparse, live, top, fz_any,
                      (bits.contiguous(), fidf, q_off, q_grp))}),
        "synthetic zero rows": dict(scores=torch.zeros_like(s), ks=(500,),
                                    lims={})}


def bench_inputs(torch, D, _kernels):
    """chip_smoke.py's bench group after the fuzzy kernel and the pass, as
    ``_dispatch_group`` hands it on; its first 8 rows and its first row."""
    import bench
    import chip_smoke as cs
    import infidex_tpu_torch as it
    from infidex_tpu_torch import runtime

    runtime.set_device("cuda")
    t0 = time.perf_counter()
    titles = bench.make_corpus(cs.N_DOCS)
    queries = bench.make_queries(titles, cs.BATCH)
    eng = cs.build_engine(it, titles)
    print(f"bench index of {cs.N_DOCS} docs in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    m = eng.vector_model
    preps = [p for p in map(m.prepare_stage1, queries) if p is not None]
    di = m.device
    scores, cnt, fz, n_grp = cs.stage1_group(torch, di, preps)
    dev = scores.device
    presence = fidf = None
    if n_grp:
        presence, df = D.fuzzy_presence(di.postings_docs, fz, n_grp, 0,
                                        di.n_pad)
        fidf = D.fuzzy_idf(df, torch.tensor(float(di.num_docs), device=dev),
                           torch.tensor(1_250_000.0, device=dev))
    live = di.live_mask
    s, c, m_k, _ = D.stage1_epilogue(scores, cnt, live, fz, presence, fidf,
                                     di.doc_fac)
    _, _, m_p, fz_any = D.stage1_epilogue_plain(
        *cs_plain_inputs(torch, D, di, cs, preps), live,
        None if not n_grp else D.fuzzy_presence_plain(
            di.postings_docs, fz.starts, fz.lens, fz.group, n_grp, 0,
            di.n_pad), fidf, di.doc_fac, fz.grp_query if n_grp else None)
    assert torch.equal(m_k, m_p)
    tables = ((presence, fidf, fz.d_qoff, fz.d_qgrp) if n_grp
              else (None,) * 4)
    out = {"fuzzy": (di, fz, n_grp)} if n_grp else {}
    for n in (128, 8, 1):
        out[f"bench group, {n} rows"] = dict(
            scores=s[:n].contiguous(), ks=(500, 20000),
            lims={"class": (c[:n].contiguous(), live, m_k[:n].contiguous(),
                            None if fz_any is None else fz_any[:n],
                            tables if n == 128 or not n_grp else
                            (presence, fidf, fz.d_qoff[:n + 1].contiguous(),
                             fz.d_qgrp))})
    return out


def cs_plain_inputs(torch, D, di, cs, preps):
    """The bench group's scattered scores and counts again (the pass writes
    in place)."""
    scores, cnt, _, _ = cs.stage1_group(torch, di, preps)
    return scores, cnt


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--bench", action="store_true")
    ap.add_argument("--sweep", action="store_true")
    ap.add_argument("--old-csrc")
    ap.add_argument("--trace", action="store_true")
    ap.add_argument("--old-fuzzy-csrc")
    ap.add_argument("--vocab", action="store_true")
    ap.add_argument("--out", default=os.path.join(ROOT, "build",
                                                  "epilogue_probe"))
    args = ap.parse_args(argv)

    import torch

    import chip_smoke as cs
    from infidex_tpu_torch.index import device as D
    from infidex_tpu_torch.ops import _kernels

    if not torch.cuda.is_available():
        print("epilogue_probe: needs a CUDA card", file=sys.stderr)
        return 2
    card = cs.nvidia_smi_line()
    print(card, flush=True)
    _kernels.build()
    old = build_old(args.old_csrc, args.out) if args.old_csrc else None
    trace = build_trace(args.out) if args.trace else None
    report = {"card": card, "inputs": {}}

    def bits(t):
        return t.contiguous().view(torch.int32) if t.dtype == torch.float32 \
            else t

    def same(a, b):
        return all(torch.equal(bits(x), bits(y)) for x, y in zip(a, b))

    def dev_ms(fn, name):
        fn()
        return cs.kernel_ms(torch, fn, name, 5)[0]

    inputs = synthetic(torch, D)
    groups = {}
    if args.bench:
        inputs.update(bench_inputs(torch, D, _kernels))
        if "fuzzy" in inputs:
            groups["bench group"] = inputs.pop("fuzzy")
    if args.old_fuzzy_csrc:
        old_fuzzy = build_old_fuzzy(args.old_fuzzy_csrc, args.out)
        if args.vocab:
            groups["large-vocabulary group"] = vocab_group(torch, cs)
        report["fuzzy"] = fuzzy_ab(torch, cs, D, _kernels, old_fuzzy,
                                   groups, 20)
    for label, inp in inputs.items():
        s = inp["scores"]
        n_rows, width = s.shape
        rep = report["inputs"].setdefault(label, {"rows": n_rows,
                                                  "width": width})
        for k in inp["ks"]:
            want = D.stable_top_k_plain(s, k)
            new_fn = (lambda k=k: _kernels.stage1_topk(s, k))
            row = rep.setdefault(f"top-k {k}", {})
            row["equal"] = same(new_fn(), want)
            fns = {"new": new_fn}
            if old is not None:
                fns["old"] = lambda k=k: old_topk(torch, old, s, k)
                row["old_equal"] = same(fns["old"](), want)
            del want
            turns = {n: [] for n in fns}
            for name in ("old", "new", "new", "old"):
                if name in fns:
                    turns[name].append(dev_ms(fns[name],
                                              "stage1_topk_kernel"))
            row.update(turns=turns, slices=_kernels.topk_slices(
                n_rows, width, s.device))
            if args.sweep:
                row["sweep"] = {
                    f"slices {sl}, runs {rk}": dev_ms(
                        lambda k=k, sl=sl, rk=rk: _kernels.stage1_topk(
                            s, k, slices=sl, run_keys=rk),
                        "stage1_topk_kernel")
                    for sl in (1, 2, 4, 8, 16) for rk in (4096, 16384)}
                row["sweep"].update({
                    f"shared_keys {sk}": dev_ms(
                        lambda k=k, sk=sk: _kernels.stage1_topk(
                            s, k, shared_keys=sk), "stage1_topk_kernel")
                    for sk in (4096, 1024, 256)})
                # the rows' shape: positives, rows with fewer than k, and
                # where the top k lie (the share in the first 1/16 of a row)
                ids = D.stable_top_k_plain(s, k)[1]
                row["rows"] = dict(
                    positives_median=int((s > 0).sum(dim=1).median()),
                    fewer_than_k=int(((s > 0).sum(dim=1) < k).sum()),
                    top_in_first_16th=float((ids < width // 16).float()
                                            .mean()))
            if trace is not None:
                row["phases_us"] = phase_us(torch, trace, s, k)
            keys = D.order_keys(s, torch.arange(width, device=s.device)
                                [None, :])
            row["library_ms"] = cs.cuda_ms(
                torch, lambda k=k: torch.topk(keys, k, dim=1), reps=3)
            del keys
            print(f"{label}: top-k {k}: {json.dumps(row)}", flush=True)
        for what, (cnt, live, thresh, fz_any, tables) in inp["lims"].items():
            n = cnt.shape[1]
            want = D.lim_rows_plain(cnt, live, thresh, fz_any, 500, 256, n, 0,
                                    1 << 24)

            def new_fn(cnt=cnt, live=live, thresh=thresh, tables=tables,
                       **kw):
                return _kernels.stage1_lim(cnt, live, thresh, *tables, 500,
                                           256, n, 0, 1 << 24, **kw)

            row = rep.setdefault(f"LIM, {what}", {})
            row["equal"] = torch.equal(new_fn(), want)
            fns = {"new": new_fn}
            if old is not None:
                fns["old"] = (lambda cnt=cnt, live=live, thresh=thresh,
                              tables=tables: old_lim(
                                  torch, old, cnt, live, thresh, tables, 500,
                                  256, n, 1 << 24))
                row["old_equal"] = torch.equal(fns["old"](), want)
            turns = {n_: [] for n_ in fns}
            for name in ("old", "new", "new", "old"):
                if name in fns:
                    turns[name].append(dev_ms(fns[name],
                                              "stage1_lim_kernel"))
            row.update(turns=turns, slices=_kernels.lim_slices(
                cnt.shape[0], n, cnt.device),
                       members=int((want[:, :256] < n).sum()))
            if args.sweep:
                row["sweep"] = {
                    f"slices {sl}": dev_ms(
                        lambda sl=sl: new_fn(slices=sl), "stage1_lim_kernel")
                    for sl in (1, 2, 4, 8, 16)}
            print(f"{label}: LIM, {what}: {json.dumps(row)}", flush=True)
    os.makedirs(args.out, exist_ok=True)
    with open(os.path.join(args.out, "epilogue_probe.json"), "w") as f:
        json.dump(report, f, indent=1)
    print(json.dumps(report), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
