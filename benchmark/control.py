#!/usr/bin/env python3
"""The control's readings: the reference, computed in the precision below
the one the configuration states, put in the program's place. It is the
control of the titles deployment (``deployments/titles.py``): the
titles reference's answers with bfloat16 final scores.

    python3 benchmark/control.py --workloads <cell>[,<cell>...] \
        --seeds <n>,<n>,... [--window-queries N]

On a CUDA card (the tests call ``readings`` on the CPU). For each seed: the program set up as a run sets it up (one index serves every
named cell of one configuration), as many queries as a run samples
drawn from the first ``N`` queries of each cell's timed stream (its
traffic's generator) and served in one call through the cell's entry
with the candidates read (``check.Capture``); the control's answers and
the reference both come from that state, so the call's shape does not
matter here.
The reference then answers the sample with its final scores rounded to
bfloat16 (the control, below the configuration's float32), and
``check.judge`` compares those answers, and the Stage-1 lists with their
scores rounded to bfloat16, with the reference as a run does. Prints one
JSON line a (seed, cell) with the numbers the control reads; it has to
come out failing them.
"""

import argparse
import copy
import gc
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from benchmark import check, generators, run  # noqa: E402
from benchmark.reference import answers  # noqa: E402


def bf16(x: float) -> float:
    """``x`` (a float32) rounded to bfloat16, to nearest, ties to even."""
    bits = int(np.float32(x).view(np.uint32))
    bits = (bits + 0x7FFF + ((bits >> 16) & 1)) & 0xFFFF0000
    return float(np.uint32(bits).view(np.float32))


def sample_specs(gen, made, tr: dict, seed: int, n: int) -> list:
    rngs = generators.streams(seed)
    specs = gen.queries(made, tr, n, rngs["timed"])
    k = min(tr["check_sample"], n)
    return [specs[i] for i in sorted(rngs["sample"].sample(range(n), k))]


def readings(manifest, names, seed, window_queries, device="cuda",
             shrink=None):
    ctx, _ = run.set_up(manifest, names[0], seed, device, shrink,
                        warm=False)
    ref = ctx.dep.reference(ctx.made)
    out = []
    for name in names:
        cell = run.cell_of(manifest, name)
        tr = copy.deepcopy(cell["traffic_data"])
        tr.update((shrink or {}).get("traffic", {}))
        ctx.traffic = tr
        ctx.gen = run._module("generators", tr["generator"])
        entry = run._module("entries", tr["entry"])
        specs = sample_specs(ctx.gen, ctx.made, tr, seed, window_queries)
        texts = [s.text for s in specs]
        cap = check.Capture(ctx.eng._pipeline, tr["top"])
        try:
            entry.replay(ctx, specs)
        finally:
            cap.restore()
        t = time.perf_counter()
        ctl = []
        for text in texts:
            st = cap.state.get(answers.query_text(text), {})
            ctl.append(answers.answer(
                ref, text, st.get("ids", []), st.get("bases", []),
                st.get("wm", False), st.get("stage1"), tr["top"],
                rounding=bf16) if "stage1" in st else None)
            if "stage1_all" in st:
                st["stage1_all"] = [(d, bf16(v)) for d, v in st["stage1_all"]]
        numbers = check.judge(ref, texts, ctl, ctl, cap.state, tr["top"])
        out.append(dict(seed=seed, workload=name, of=len(texts),
                        seconds=round(time.perf_counter() - t, 1),
                        **{k: v["value"] for k, v in numbers.items()}))
    del ctx
    gc.collect()
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workloads", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--window-queries", type=int, default=2048,
                    help="queries of the timed stream the sample is drawn from")
    args = ap.parse_args(argv)
    manifest = run.load_manifest()
    for seed in (int(s) for s in args.seeds.split(",")):
        for line in readings(manifest, args.workloads.split(","), seed,
                             args.window_queries):
            print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
