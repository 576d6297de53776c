"""The lane kernel with its doc window against the kernel without one.

    python3 scripts/lane_window_ab.py --old-csrc DIR [--out DIR] [--reps N]

DIR holds the earlier ``stage1_lanes.cu`` (the C interface of commit
4a21a78: one launch per group, no doc window), e.g. unpacked with
``git archive 4a21a78 infidex_tpu_torch/csrc``. The script builds it with
the port's ``nvcc`` flags and, on one card, on the chunk table of the
first 128-query group of bench.py's corpus at 1,000,000 docs
(chip_smoke.py phase 2's input), checks that the windowed kernel over the
whole doc axis ``(0, n_pad)`` gives the earlier kernel's bits, then times
the two in turns (old, new, new, old) with CUDA events, ``--reps``
launches a turn, and one shard window of four beside them. Prints one JSON
object and writes it to ``--out``/lane_window_ab.json.
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
sys.path.insert(0, os.path.join(ROOT, "scripts"))

BATCH = 128


def build_old(src_dir: str, out_dir: str):
    """The earlier lane kernel, bound with its C interface."""
    from infidex_tpu_torch.ops import _kernels

    so = os.path.join(out_dir, "libstage1_lanes_old.so")
    os.makedirs(out_dir, exist_ok=True)
    res = subprocess.run([_kernels._nvcc(), *_kernels.NVCC_FLAGS, "-o", so,
                          os.path.join(src_dir, "stage1_lanes.cu")],
                         capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed:\n{res.stdout}\n{res.stderr}")
    lib = ctypes.CDLL(so)
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.stage1_scatter_lanes.argtypes = [p, p, p, p, p, p, p, i, p, p, p, p,
                                         p]
    lib.stage1_scatter_lanes.restype = i
    return lib


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--old-csrc", required=True)
    ap.add_argument("--out", default=os.path.join(ROOT, "build",
                                                  "lane_window_ab"))
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("lane_window_ab: needs a CUDA card", file=sys.stderr)
        return 2
    import bench
    import chip_smoke as cs
    import infidex_tpu_torch as it
    from infidex_tpu_torch import runtime
    from infidex_tpu_torch.index.device import (prepare_batch_arrays,
                                                split_batch_by_lanes)
    from infidex_tpu_torch.ops import _kernels
    from infidex_tpu_torch.ops import stage1_lanes as lanes
    from kernel_ab import in_turns

    runtime.set_device("cuda")
    card = cs.nvidia_smi_line()
    _kernels.build()
    lib = build_old(args.old_csrc, args.out)

    titles = bench.make_corpus(cs.N_DOCS)
    queries = bench.make_queries(titles, BATCH)
    t0 = time.perf_counter()
    eng = cs.build_engine(it, titles)
    print(f"[lanes] {cs.N_DOCS} docs indexed in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    dev = eng.vector_model.device
    preps = [eng.vector_model.prepare_stage1(q) for q in queries]
    lo, hi = split_batch_by_lanes(dev.built, preps)[0]
    chunks = dev.stage1_chunks(preps[lo:hi])
    docs, cfac, n_pad = dev.postings_docs, dev.cfac, dev.n_pad
    n = (hi - lo) * n_pad
    width = n_pad // 4

    def old(s, c):
        rc = lib.stage1_scatter_lanes(
            chunks.qstart.data_ptr(), chunks.off.data_ptr(),
            chunks.vstart.data_ptr(), chunks.vend.data_ptr(),
            chunks.idf.data_ptr(), chunks.base.data_ptr(),
            chunks.rank.data_ptr(), hi - lo, docs.data_ptr(),
            cfac.data_ptr(), s.data_ptr(), c.data_ptr(),
            torch.cuda.current_stream().cuda_stream)
        assert rc == 0, rc

    def new(s, c):
        lanes.scatter_lanes(s, c, chunks, docs, cfac, 0, n_pad)

    out = {}
    for name, fn in (("old", old), ("new", new)):
        s = torch.zeros(n, device=docs.device)
        c = torch.zeros(n, device=docs.device)
        fn(s, c)
        out[name] = (s.view(torch.int32), c)
    torch.cuda.synchronize()
    same = (torch.equal(out["old"][0], out["new"][0])
            and torch.equal(out["old"][1], out["new"][1]))
    s = torch.zeros(n, device=docs.device)
    c = torch.zeros(n, device=docs.device)
    times = in_turns(torch, cs, {"old": lambda: old(s, c),
                                 "new": lambda: new(s, c)}, args.reps)
    n_t = sum(len(q[0]) for q in preps[lo:hi])
    prep = prepare_batch_arrays(dev.built, preps[lo:hi])
    wchunks = lanes.build_query_chunks(*(a[:n_t] for a in prep[1:5]),
                                       hi - lo, width, docs.device)
    ws = torch.zeros((hi - lo) * width, device=docs.device)
    wc = torch.zeros_like(ws)
    window_ms = cs.cuda_ms(torch, lambda: lanes.scatter_lanes(
        ws, wc, wchunks, docs, cfac, width, 2 * width), reps=args.reps)
    result = dict(card=card, torch=torch.__version__, queries=hi - lo,
                  lanes=int((chunks.vend - chunks.vstart).sum()),
                  bit_equal=same, ms=times, window_of_four_ms=window_ms)
    line = json.dumps(result)
    with open(os.path.join(args.out, "lane_window_ab.json"), "w") as f:
        f.write(line + "\n")
    print(line, flush=True)
    return 0 if same else 1


if __name__ == "__main__":
    sys.exit(main())
