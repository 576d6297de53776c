"""Where one 128-query batch of the PyTorch port spends its time, on a card.

    python3 scripts/profile_torch_batch.py [--docs N] [--walls N]
                                           [--old-csrc DIR] [--out DIR]

Indexes bench.py's corpus (1M docs by default) with infidex_tpu_torch on
CUDA, warms up with two batches, then serves one batch under
torch.profiler (CPU + CUDA activity: device kernel time, kernel count,
idle share = 1 - device time / wall, the device time of ``aten::index``)
and two more under cProfile (host time by function, pipeline threads
included). Both are taken twice over, in turns, on the same batches: with
the coverage block's gather as eager PyTorch (``gather_block_plain``
before the four kernels: the route before ``csrc/coverage_gather.cu``,
"eager gather"), and with the five kernels ("kernel"). ``--with-plain``
first adds two routes: "plain", with no kernel in the coverage program,
and "plain fusion", with the fake-LCS and the scorer + fusion program as
eager PyTorch (``coverage_lcs_plain``, ``coverage_fusion_plain``). The
route is swapped by rebinding the coverage module's five dispatchers, not
by an option of the package. Prints the card's name and power limit and a
summary (kernels a coverage block, ``_coverage_block`` host ms a block),
and writes the full tables to DIR/profile_torch_{route}.txt and
DIR/profile_host_{route}.txt.

Each profiled batch also prints the Stage-1 epilogue's device ms: by op
(``aten::topk``, ``mul``, ``add``, ``index_add_``, ``copy_`` and the other
ops of the plain epilogue) and by epilogue kernel (``csrc/stage1_*.cu``),
and the batch's peak device bytes. ``--routes`` picks the turns; "plain
epilogue" serves the Stage-1 epilogue by its plain versions on the card
(``index/device.py _use_plain`` rebound), where the package has them. A
tree without them (an earlier commit, unpacked with ``git archive``) runs
this script too: ``python3 scripts/profile_torch_batch.py --root DIR``
profiles the package under DIR, so parent and change are measured by the
same script, in turns. ``--walls N`` then serves N more batches with the
kernels, no profiler attached, and prints their walls (host clock, each
ending in a synchronise), so that parent and change compare by more than
one batch each. With ``--old-csrc DIR`` (an earlier ``csrc/``, e.g.
``git archive 051d756 infidex_tpu_torch/csrc``), N pairs of batches
instead: each pair serves one batch with today's pair and fuzzy-presence
kernels and with DIR's (``coverage_pairs.cu``, ``stage1_fuzzy.cu``, built
with the port's nvcc flags and called through the same wrappers,
``lib=``; the pair words as two launches a block, as before the
one-launch kernel), in turns which goes first: the kernels' effect on
the wall in one process, on one index, by the pairs' differences.
"""

import argparse
import cProfile
import io
import os
import pstats
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

BATCH = 128
#: functions whose cProfile rows the summary prints
WATCH = ("_dispatch_chunk", "coverage_fusion_batch", "_coverage_block",
         "gather_block", "gather_block_plain", "coverage_gather",
         "coverage_pairs", "coverage_pairs_plain", "coverage_pair_block",
         "coverage_pair_block_plain", "coverage_cascade",
         "coverage_cascade_plain", "coverage_lcs", "coverage_lcs_plain",
         "coverage_fusion", "coverage_fusion_plain", "_dispatch_group",
         "_collect_group", "_device_collect", "stage1_scatter_lanes",
         "_assemble_prior")
#: the coverage program's dispatchers, by the name of their kernel (a tree
#: from before the pair kernel's one launch a block calls
#: ``coverage_pairs`` in place of ``coverage_pair_block``)
COVERAGE_KERNELS = {"gather_block": "coverage_gather_kernel",
                    "coverage_pair_block": "coverage_pairs_kernel",
                    "coverage_cascade": "coverage_cascade_kernel",
                    "coverage_lcs": "coverage_lcs_kernel",
                    "coverage_fusion": "coverage_fusion_kernel"}
#: the ops of the plain Stage-1 epilogue, and the epilogue's kernels
EPILOGUE_OPS = ("aten::topk", "aten::mul", "aten::add", "aten::index_add_",
                "aten::copy_", "aten::max", "aten::where", "aten::sum",
                "aten::index_put_", "aten::ge", "aten::gt", "aten::fill_",
                "aten::zero_", "aten::bitwise_or", "aten::gather")
EPILOGUE_KERNELS = ("stage1_fuzzy_", "stage1_epilogue_kernel",
                    "stage1_topk_kernel", "stage1_lim_kernel")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--docs", type=int, default=1_000_000)
    ap.add_argument("--out", default=os.path.join(ROOT, "build", "profile"))
    ap.add_argument("--with-plain", action="store_true",
                    help="also profile the route with no kernel in the "
                         "coverage program")
    ap.add_argument("--routes", default=None,
                    help="comma-separated turns (default: plain epilogue, "
                         "kernel, kernel, plain epilogue where the package "
                         "has the epilogue kernels, else kernel, kernel)")
    ap.add_argument("--walls", type=int, default=0,
                    help="batches served after the profiles, their walls "
                         "printed")
    ap.add_argument("--old-csrc", default=None,
                    help="with --walls N: N pairs of batches, each batch "
                         "served with today's pair and fuzzy kernels and "
                         "with DIR's")
    ap.add_argument("--root", default=ROOT,
                    help="the repository whose package is profiled")
    args = ap.parse_args(argv)
    sys.path.insert(0, os.path.abspath(args.root))

    import torch
    from torch.profiler import ProfilerActivity, profile

    import bench
    import infidex_tpu_torch as it
    from infidex_tpu_torch import runtime
    from infidex_tpu_torch.ops import _kernels

    runtime.set_device("cuda")
    _kernels.build()
    os.makedirs(args.out, exist_ok=True)
    titles = bench.make_corpus(args.docs)
    queries = bench.make_queries(titles, 5 * BATCH)
    t0 = time.perf_counter()
    eng = it.SearchEngine.create_default()
    eng.index_documents([it.Document(i, t) for i, t in enumerate(titles)])
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    print(f"{args.docs} docs indexed in {time.perf_counter() - t0:.1f} s on "
          f"{card}", flush=True)
    batches = [[it.Query(q, 10) for q in queries[i:i + BATCH]]
               for i in range(0, len(queries), BATCH)]

    def serve(b):
        t = time.perf_counter()
        eng.search_batch(b)
        torch.cuda.synchronize()
        return time.perf_counter() - t

    print("warm-up walls ms", [round(serve(b) * 1e3, 1) for b in batches[:2]],
          flush=True)

    from infidex_tpu_torch.index import device
    from infidex_tpu_torch.ops import coverage_kernel as ck

    names = tuple(n if hasattr(ck, n) else "coverage_pairs"
                  for n in COVERAGE_KERNELS)
    kernels = tuple(getattr(ck, name) for name in names)
    plain = tuple(getattr(ck, name + "_plain") for name in names)
    routes = {"plain": plain, "plain fusion": kernels[:3] + plain[3:],
              "eager gather": plain[:1] + kernels[1:], "kernel": kernels,
              "plain epilogue": kernels}
    use_plain = getattr(device, "_use_plain", None)

    def take(route):
        for name, fn in zip(names, routes[route]):
            setattr(ck, name, fn)
        if use_plain is not None:
            device._use_plain = ((lambda t: True) if route == "plain epilogue"
                                 else use_plain)

    def profiled(route):
        take(route)
        blocks = []
        block = ck._coverage_block
        ck._coverage_block = lambda *a, **k: blocks.append(1) or block(*a, **k)
        _kernels.reset_launch_counts()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            wall = serve(batches[2])
        peak = torch.cuda.max_memory_allocated()
        ck._coverage_block = block
        ka = prof.key_averages()
        on_card = [e for e in ka if str(e.device_type).endswith("CUDA")]
        dev_s = sum(e.self_device_time_total for e in on_card) / 1e6
        n_kernels = sum(e.count for e in on_card)
        hand = {kernel: sum(e.self_device_time_total for e in on_card
                            if kernel in e.key) / 1e3
                for kernel in COVERAGE_KERNELS.values()}
        index = [e for e in ka if e.key == "aten::index"]
        index_ms = sum(e.self_device_time_total for e in index) / 1e3
        index_calls = sum(e.count for e in index)
        print(f"[profiler, {route}] batch wall {wall * 1e3:.1f} ms; "
              f"device kernel time {dev_s * 1e3:.1f} ms in {n_kernels} "
              f"kernels; idle share {1 - dev_s / wall:.4f}; {len(blocks)} "
              f"coverage blocks, {n_kernels / max(len(blocks), 1):.0f} "
              f"kernels a block (Stage 1 included); hand-kernel launches "
              f"{dict(_kernels.launch_counts)}, device ms of the coverage "
              f"kernels {hand}; aten::index {index_ms:.3f} ms device in "
              f"{index_calls} calls", flush=True)
        ops = {op: round(sum(e.self_device_time_total for e in ka
                             if e.key == op) / 1e3, 4)
               for op in EPILOGUE_OPS}
        mine = {k: (round(sum(e.self_device_time_total for e in on_card
                              if k in e.key) / 1e3, 4),
                    sum(e.count for e in on_card if k in e.key))
                for k in EPILOGUE_KERNELS}
        print(f"[profiler, {route}] Stage-1 epilogue, device ms by op "
              f"{ {k: v for k, v in ops.items() if v} }; epilogue kernels "
              f"(device ms, launches) {mine}; peak device memory {peak} B",
              flush=True)
        tag = route.replace(" ", "_")
        with open(os.path.join(args.out, f"profile_torch_{tag}.txt"),
                  "w") as f:
            f.write(ka.table(sort_by="self_cuda_time_total", row_limit=40))
            f.write("\n\n")
            f.write(ka.table(sort_by="self_cpu_time_total", row_limit=40))

    def host_profiled(route):
        take(route)
        pr = cProfile.Profile()
        t = time.perf_counter()
        pr.enable()
        for b in batches[3:5]:
            eng.search_batch(b)
        torch.cuda.synchronize()
        pr.disable()
        wall2 = time.perf_counter() - t
        s = io.StringIO()
        st = pstats.Stats(pr, stream=s)
        st.sort_stats("cumulative").print_stats(60)
        st.sort_stats("tottime").print_stats(40)
        with open(os.path.join(args.out,
                               f"profile_host_{route.replace(' ', '_')}.txt"),
                  "w") as f:
            f.write(f"two batches, wall {wall2:.3f} s\n{s.getvalue()}")
        print(f"[cprofile, {route}] two batches in "
              f"{wall2 * 1e3:.1f} ms wall", flush=True)
        for (path, line, name), v in sorted(st.stats.items()):
            if name in WATCH:
                print(f"  {name} ({os.path.basename(path)}:{line}): calls "
                      f"{v[1]}, cum {v[3] * 1e3:.1f} ms "
                      f"({v[3] * 1e3 / max(v[1], 1):.2f} ms a call), self "
                      f"{v[2] * 1e3:.1f} ms")

    if args.routes:
        turns = tuple(args.routes.split(","))
    else:
        turns = (("plain epilogue", "kernel", "kernel", "plain epilogue")
                 if use_plain is not None else ("kernel", "kernel"))
    turns = (("plain", "plain fusion") if args.with_plain else ()) + turns
    try:
        for route in turns:
            profiled(route)
        for route in turns:
            host_profiled(route)
    finally:
        take("kernel")
    if args.walls and args.old_csrc:
        alternate_walls(args, serve, batches, _kernels, ck)
    elif args.walls:
        walls = sorted(serve(batches[i % len(batches)]) * 1e3
                       for i in range(args.walls))
        print(f"[walls] {args.walls} batches of {BATCH} with the kernels: "
              f"median {walls[len(walls) // 2]:.1f} ms, min {walls[0]:.1f}, "
              f"max {walls[-1]:.1f}; all {[round(w, 1) for w in walls]}",
              flush=True)


def alternate_walls(args, serve, batches, _kernels, ck):
    """``args.walls`` pairs of walls: pair i serves batch i mod 5 once with
    the pair and fuzzy kernels built from ``args.old_csrc`` ("old") and
    once with today's ("new"), old first in even pairs, new first in odd
    ones, after one unrecorded pass of every batch on each side. Prints
    each side's walls and the pairs' differences (new - old)."""
    import ctypes

    so = os.path.join(args.out, "libinfidex_old_pairs_fuzzy.so")
    res = subprocess.run([_kernels._nvcc(), *_kernels.NVCC_FLAGS, "-o", so,
                          *(os.path.join(args.old_csrc, f) for f in
                            ("coverage_pairs.cu", "stage1_fuzzy.cu"))],
                         capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed:\n{res.stdout}\n{res.stderr}")
    old = _kernels.bind(ctypes.CDLL(so))
    new_block, new_fuzzy = ck.coverage_pair_block, _kernels.stage1_fuzzy

    def old_block(q_set, fq_set, *doc):
        return (_kernels.coverage_pairs(*q_set, *doc, True, lib=old),
                _kernels.coverage_pairs(*fq_set, *doc, False, lib=old))

    def old_fuzzy(*a):
        return new_fuzzy(*a, lib=old)

    def wall(side, b):
        ck.coverage_pair_block = old_block if side == "old" else new_block
        _kernels.stage1_fuzzy = old_fuzzy if side == "old" else new_fuzzy
        return serve(b) * 1e3

    walls = {"old": [], "new": []}
    try:
        for b in batches:
            wall("old", b), wall("new", b)
        for i in range(args.walls):
            b = batches[i % len(batches)]
            for side in (("old", "new") if i % 2 == 0 else ("new", "old")):
                walls[side].append(wall(side, b))
    finally:
        ck.coverage_pair_block, _kernels.stage1_fuzzy = new_block, new_fuzzy

    def quartiles(v):
        v = sorted(v)
        return [round(v[(len(v) - 1) * q // 4], 1) for q in range(5)]

    for side, w in walls.items():
        print(f"[walls, {side} kernels] {len(w)} batches of {BATCH}: "
              f"min, quartiles, max {quartiles(w)}; in order "
              f"{[round(x, 1) for x in w]}", flush=True)
    diff = [n - o for n, o in zip(walls["new"], walls["old"])]
    print(f"[walls, new - old] {len(diff)} pairs on the same batch: min, "
          f"quartiles, max {quartiles(diff)}; new faster in "
          f"{sum(d < 0 for d in diff)} of {len(diff)}", flush=True)


if __name__ == "__main__":
    main()
