"""The index build of a benchmark corpus, phase by phase.

    python3 scripts/profile_build.py [--root DIR] [--titles N] [--seed S]
        [--device cuda|cpu] [--runs K] [--profile] [--out FILE]

Makes the titles of ``benchmark/configs/movies-1m.json`` (``--titles``
overrides their number) from ``--seed`` as ``benchmark/run.py`` does,
then indexes them ``--runs`` times with ``SearchEngine.create_default()``
of the package under ``--root`` (default: this checkout; give an
unpacked earlier tree to time it in the same process layout) with the
tracer on. Prints, a run, the wall of ``index_documents``, the phases of
``get_statistics().build_seconds`` and the ``build.*`` counters (a tree
without them prints none); ``--profile`` adds cProfile's thirty largest
self times. Writes everything to FILE as JSON.
"""

import argparse
import cProfile
import io
import json
import os
import pstats
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=HERE)
    ap.add_argument("--titles", type=int)
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--runs", type=int, default=1)
    ap.add_argument("--profile", action="store_true")
    ap.add_argument("--out")
    args = ap.parse_args()
    sys.path.insert(0, HERE)
    from benchmark import corpus  # this checkout's generator, either way

    sys.path.insert(0, os.path.abspath(args.root))
    import infidex_tpu_torch as it
    from infidex_tpu_torch import runtime, tracing

    assert it.__file__.startswith(os.path.abspath(args.root)), it.__file__
    runtime.set_device(args.device)
    with open(os.path.join(HERE, "benchmark", "configs",
                           "movies-1m.json")) as f:
        config = json.load(f)["corpus"]
    if args.titles:
        config["titles"] = args.titles
    titles, _ = corpus.make_titles(config, args.seed)
    runs = []
    for r in range(args.runs):
        docs = [it.Document(i, t) for i, t in enumerate(titles)]
        eng = it.SearchEngine.create_default()
        prof = cProfile.Profile() if args.profile else None
        tracing.start()
        t = time.perf_counter()
        if prof:
            prof.enable()
        eng.index_documents(docs)
        if prof:
            prof.disable()
        if args.device == "cuda":
            import torch

            torch.cuda.synchronize()
        wall = time.perf_counter() - t
        snap = tracing.stop()
        run = {"root": args.root, "titles": len(titles), "wall_s": wall,
               "build_seconds": eng.get_statistics().build_seconds,
               "index_build_s": sum(
                   eng.get_statistics().build_seconds.values()),
               "counters": {k: v for k, v in snap.counters.items()
                            if k.startswith("build.")}}
        if prof:
            out = io.StringIO()
            pstats.Stats(prof, stream=out).sort_stats("tottime").print_stats(30)
            run["profile"] = out.getvalue()
        print(json.dumps({k: v for k, v in run.items() if k != "profile"}),
              flush=True)
        if prof:
            print(run["profile"], flush=True)
        runs.append(run)
        del eng, docs
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(runs, f, indent=1)


if __name__ == "__main__":
    main()
