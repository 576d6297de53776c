"""The port's two hand kernels against an earlier design, in one run.

    python3 scripts/kernel_ab.py --old-csrc DIR [--out DIR] [--reps N]

DIR holds the earlier design's CUDA sources (``stage1_lanes.cu`` and
``fuzzy_match.cu`` with the C interfaces of commit c7be62e: the lane
kernel launched once per term rank over a rank-major table, the match
kernel one block per token row), e.g. unpacked with
``git archive c7be62e infidex_tpu_torch/csrc``. The script builds them
with the same ``nvcc`` flags as the port's library, then, on one card:

* lanes: the chunk table of the first 128-query group of bench.py's
  corpus at 1,000,000 docs (chip_smoke.py phase 2's input);
* match: the unknown tokens of the first 128-query batch of the
  large-vocabulary corpus (chip_smoke.py phase 7's input).

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


def build_old(src_dir: str, out_dir: str):
    """The earlier design's library, bound with its C interfaces."""
    from infidex_tpu_torch.ops import _kernels

    srcs = [os.path.join(src_dir, f) for f in ("stage1_lanes.cu",
                                                "fuzzy_match.cu")]
    so = os.path.join(out_dir, "libinfidex_kernels_old.so")
    os.makedirs(out_dir, exist_ok=True)
    res = subprocess.run([_kernels._nvcc(), *_kernels.NVCC_FLAGS, "-o", so,
                          *srcs], capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed:\n{res.stdout}\n{res.stderr}")
    lib = ctypes.CDLL(so)
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.stage1_scatter_lanes.argtypes = [p, p, p, p, p, i, p, p, p, p, p]
    lib.stage1_scatter_lanes.restype = i
    lib.fuzzy_match.argtypes = [p, p, p, p, p, p, p, i, i, i, p, p]
    lib.fuzzy_match.restype = i
    return lib


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
    """ms of each of the two callables, timed old, new, new, old."""
    times = {"old": [], "new": []}
    for name in ("old", "new", "new", "old"):
        times[name].append(cs.cuda_ms(torch, fns[name], reps=reps))
    return times


def lanes_ab(torch, cs, it, bench, lib, reps: int) -> dict:
    from infidex_tpu_torch.index.device import split_batch_by_lanes
    from infidex_tpu_torch.ops import stage1_lanes as lanes

    titles = bench.make_corpus(cs.N_DOCS)
    queries = bench.make_queries(titles, BATCH)
    t0 = time.perf_counter()
    eng = cs.build_engine(it, titles)
    print(f"[lanes] {cs.N_DOCS} docs indexed in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    m = eng.vector_model
    preps = [m.prepare_stage1(q) for q in queries]
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
    ap.add_argument("--old-csrc", required=True)
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
    lib = build_old(args.old_csrc, args.out)
    result = dict(card=card, torch=torch.__version__,
                  lanes=lanes_ab(torch, cs, it, bench, lib, args.reps),
                  match=match_ab(torch, cs, it, bench, lib, args.reps))
    line = json.dumps(result)
    with open(os.path.join(args.out, "kernel_ab.json"), "w") as f:
        f.write(line + "\n")
    print(line, flush=True)
    ok = result["lanes"]["bit_equal"] and result["match"]["bit_equal"]
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
