#!/usr/bin/env python3
"""One run of one cell of BENCHMARK.json on one CUDA card.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

From the root of a checkout. The cell names a configuration
(``benchmark/configs/<name>.json``: the deployment's recipe and
guarantees, and in ``deployment_module`` the module of
``benchmark/deployments/`` that makes its documents, builds its engine
and names its reference) and a traffic mix
(``benchmark/traffic/<name>.json``, whose ``entry`` names the module of
``benchmark/entries/`` that drives the program and whose ``generator``
the module of ``benchmark/generators/`` that draws its queries). Set-up
makes the documents and the queries from ``--seed``, builds the engine
and warms up; the window then measures for ``--seconds``. With
``--trace 1`` the window runs under torch.profiler and the benchmark's
own wrappers, and the line carries the cell's per-layer metrics (readers
in ``benchmark/metrics/<name>.py``) instead of its end-to-end ones (the
card's memory peak and set-up; the window's own rates and latencies are
host-clock readings that spread with the host's speed, so they are
per-layer metrics). After the window a sample of the answers, drawn
from the seed, is served again with the candidates read, and
compared with the deployment's plain reference (under
``benchmark/reference/``) on the CPU (``check.py``).

Prints the compared numbers beside their limits as the last lines of
standard error and one JSON object as the last line of standard output.
Exits non-zero, printing no result, without a CUDA card or without the
program, or if ``jax``, ``jaxlib``, ``flax`` or ``infidex_tpu`` was
imported.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import copy  # noqa: E402
import gc  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from types import SimpleNamespace  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
if sys.path and os.path.abspath(sys.path[0] or ".") == HERE:
    sys.path.pop(0)
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from benchmark import check, devtrace, generators  # noqa: E402
from benchmark.record import Record  # noqa: E402

#: top-level module names no run may hold
FORBIDDEN = ("jax", "jaxlib", "flax", "infidex_tpu")
#: build and kernel caches, at fixed paths inside the checkout
CACHES = {"TORCH_EXTENSIONS_DIR": os.path.join("build", "torch_extensions"),
          "TRITON_CACHE_DIR": os.path.join("build", "triton")}


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def load_manifest(root: str = ROOT) -> dict:
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return json.load(f)


#: the key of each data file that names its module, with its folder
MODULE_KEYS = {"configs": ("deployment_module", "deployments"),
               "traffic": ("generator", "generators")}


def _data(kind: str, name: str) -> dict:
    """``benchmark/<kind>/<name>.json``: a configuration or traffic mix."""
    with open(os.path.join(HERE, kind, f"{name}.json")) as f:
        return json.load(f)


def _module(kind: str, name: str):
    """``benchmark/<kind>/<name>.py``: a deployment, generator or entry."""
    return importlib.import_module(f"benchmark.{kind}.{name}")


def cell_of(manifest: dict, name: str) -> dict:
    """The workload ``name`` with its configuration and traffic files;
    each file has to name its module."""
    cells = {w["name"]: w for w in manifest["workloads"]}
    if name not in cells:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json; "
                         f"known: {sorted(cells)}")
    cell = dict(cells[name])
    for kind, key in (("configs", "config"), ("traffic", "traffic")):
        data = _data(kind, cell[key])
        need, folder = MODULE_KEYS[kind]
        if need not in data:
            raise SystemExit(f"benchmark/{kind}/{cell[key]}.json has no "
                             f"{need!r} key: it names the module "
                             f"benchmark/{folder}/<name>.py")
        cell[f"{key}_data"] = data
    return cell


def _merge(into: dict, over: dict) -> None:
    """``over``'s entries written into ``into``, nested objects merged."""
    for k, v in over.items():
        if isinstance(v, dict) and isinstance(into.get(k), dict):
            _merge(into[k], v)
        else:
            into[k] = v


def applies(metric: dict, cell: str, manifest: dict) -> bool:
    """Whether ``cell`` reports ``metric``: the cells its ``workloads``
    list; without one, an end-to-end metric is every cell's and a
    per-layer one every cell that reports the metric it moves."""
    if "workloads" in metric:
        return cell in metric["workloads"]
    if "moves" in metric:
        e2e = {m["name"]: m for m in manifest["end_to_end"]}
        return applies(e2e[metric["moves"]], cell, manifest)
    return True


def reader(name: str):
    """The per-layer metric reader ``benchmark/metrics/<name>.py``."""
    path = os.path.join(HERE, "metrics", f"{name}.py")
    mod_name = "benchmark.metrics." + name.replace(".", "__")
    spec = importlib.util.spec_from_file_location(mod_name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def forbidden_modules() -> list:
    return sorted(m for m in list(sys.modules)
                  if m.split(".")[0] in FORBIDDEN)


def card_line() -> str:
    res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    return res.stdout.strip().splitlines()[0] if res.returncode == 0 else ""


def label_spans(ctx, rec) -> None:
    """Spans that name what the host was doing, for ``breakdown``."""
    eng, pipe = ctx.eng, ctx.eng._pipeline
    for attr, name in (("search_many", "search_many"), ("search", "search")):
        rec.wrap(eng, attr, name)
    for attr, name in (("_prime_fuzzy_tokens", "prime_fuzzy_tokens"),
                       ("_coverage_run_begin", "coverage_run_begin"),
                       ("_coverage_run_end", "coverage_run_end"),
                       ("_device_collect", "coverage_collect")):
        rec.wrap(pipe, attr, name)
    rec.wrap(eng.vector_model, "prepare_stage1", "prepare_stage1")
    if eng.word_matcher is not None:
        rec.wrap(eng.word_matcher, "lookup_parts_grouped", "word_matcher")


def set_up(manifest: dict, name: str, seed: int, device: str = "cuda",
           shrink: dict = None, warm: bool = True):
    """The program built and (with ``warm``) warmed up for cell ``name``:
    returns (ctx, entry module). ``shrink`` (tests only) overrides entries
    of the configuration (``shrink["config"]``, merged into it) and of
    the traffic file (``shrink["traffic"]``)."""
    cell = cell_of(manifest, name)
    config = copy.deepcopy(cell["config_data"])
    traffic = copy.deepcopy(cell["traffic_data"])
    if shrink:
        _merge(config, shrink.get("config", {}))
        traffic.update(shrink.get("traffic", {}))
    dep = _module("deployments", config["deployment_module"])
    gen = _module("generators", traffic["generator"])
    entry = _module("entries", traffic["entry"])
    for var, rel in CACHES.items():
        os.environ[var] = os.path.join(ROOT, rel)

    import torch

    import infidex_tpu_torch as it
    from infidex_tpu_torch import runtime
    from infidex_tpu_torch.ops import _kernels

    cuda = device == "cuda"
    runtime.set_device(device)
    t = time.perf_counter()
    if cuda:
        _kernels.build()
    log(f"[setup] kernels ready in {time.perf_counter() - t:.1f} s")
    t = time.perf_counter()
    made = dep.documents(config, seed)
    log(f"[setup] documents ({config['deployment_module']}) in "
        f"{time.perf_counter() - t:.1f} s")
    t = time.perf_counter()
    eng = dep.engine(it, made, config)
    if cuda:
        torch.cuda.synchronize()
    log(f"[setup] indexed in {time.perf_counter() - t:.1f} s")
    ctx = SimpleNamespace(it=it, eng=eng, traffic=traffic, made=made,
                          dep=dep, gen=gen, rngs=generators.streams(seed),
                          torch=torch, cuda=cuda)
    if not warm:
        return ctx, entry
    t = time.perf_counter()
    rates = entry.warm_up(ctx)
    if cuda:
        torch.cuda.synchronize()
    log(f"[setup] warmed up in {time.perf_counter() - t:.1f} s"
        + (f"; calls at {', '.join(f'{r:.1f}' for r in rates)} queries/s"
           if rates else ""))
    return ctx, entry


def run_cell(manifest: dict, name: str, seed: int, seconds: float,
             trace: bool, device: str = "cuda", shrink: dict = None,
             tamper=None) -> dict:
    """One run; returns the result object. ``shrink`` as ``set_up``
    takes it; ``tamper(ctx)`` (tests only) may break the program after
    set-up."""
    ctx, entry = set_up(manifest, name, seed, device, shrink)
    setup_s = time.perf_counter() - T_START
    if tamper is not None:
        tamper(ctx)
    torch, cuda = ctx.torch, ctx.cuda
    eng, traffic = ctx.eng, ctx.traffic

    rec = Record()
    wanted = [m for m in manifest["per_layer" if trace else "end_to_end"]
              if applies(m, name, manifest)]
    readers = {m["name"]: reader(m["name"]) for m in wanted} if trace else {}
    split0 = eng.serving_split(reset=False)
    if trace:
        rec.card = card_line() if cuda else ""
        for r in readers.values():
            if hasattr(r, "install"):
                r.install(ctx, rec)
        label_spans(ctx, rec)
        try:
            if cuda:
                out = devtrace.traced(
                    torch, lambda: entry.window(ctx, seconds, rec), rec)
            else:
                out = entry.window(ctx, seconds, rec)
        finally:
            rec.restore()
    else:
        out = entry.window(ctx, seconds, None)
    split1 = eng.serving_split(reset=False)
    rec.counters = {k: split1[k] - split0[k] for k in split0}
    rec.window_metrics = dict(out["metrics"])
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    log(f"[window] {out['attempted']} queries, {out['failed']} failed; "
        f"{json.dumps(out['metrics'])}; "
        f"{json.dumps(out['load'])}; device wait "
        f"{rec.counters['device_wait_s']:.3f} s in "
        f"{rec.counters['device_calls']} calls")

    metrics = {}
    if trace:
        for m in wanted:
            value = readers[m["name"]].read(rec)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        values = dict(setup_s=setup_s, memory_peak_mib=peak / 2**20)
        for m in wanted:
            metrics[m["name"]] = {"value": values[m["name"]],
                                  "unit": m["unit"]}
    dev_info = {"platform": "gpu" if cuda else "cpu",
                "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
                "count": 1, "memory_peak_bytes": peak}
    result = {"correct": False, "attempted": out["attempted"],
              "failed": out["failed"], "metrics": metrics,
              "device": dev_info}
    if trace:
        dev_info["busy_s"] = rec.busy_s()
        dev_info["window_s"] = rec.window_s
        if rec.card:
            dev_info["card"] = rec.card
        result["breakdown"] = devtrace.breakdown(rec)

    # correctness: a sample of the window's answers against the reference
    specs, top = out["specs"], traffic["top"]
    drawn, sample = check.draw_sample(ctx.rngs["sample"], specs,
                                      out["calls"], traffic["check_sample"])
    calls = [out["calls"][c] for c in drawn]
    got = {i: check.answer_of(out["answers"][i]) for i in sample}
    failed, k = out["failed"], len(sample)
    t = time.perf_counter()
    replays = check.replay_calls(lambda s: entry.replay(ctx, s),
                                 eng._pipeline, specs, calls, top)
    t_replay = time.perf_counter() - t
    del ctx.eng, eng, out
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    t = time.perf_counter()
    dep = ctx.dep
    ref = dep.reference(ctx.made)
    numbers = []
    groups = check.rounds([st for _, st in replays])
    for members, state in groups:
        idx = [(i, p) for p in members for i in sample
               if calls[p][0] <= i < calls[p][1]]
        numbers.append(dep.judge(
            ref, [specs[i] for i, _ in idx], [got[i] for i, _ in idx],
            [replays[p][0][i - calls[p][0]] for i, p in idx], state, top,
            log=log))
    numbers = check.total(numbers)
    log(f"[reference] {k} queries of {len(calls)} calls "
        f"({sum(h - lo for lo, h in calls)} queries served again), "
        f"{len(groups)} round(s): replay {t_replay:.1f} s, reference "
        f"{time.perf_counter() - t:.1f} s")
    result["correct"] = bool(k and not failed and check.passed(numbers))
    result["checks"] = {n: {"value": v["value"], "limit": v["limit"]}
                        for n, v in numbers.items()}
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    manifest = load_manifest()
    cell = cell_of(manifest, args.workload)
    try:
        import torch
    except ImportError as exc:
        log(f"no torch: {exc}")
        return 2
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell["chips"]:
        log(f"this run needs {cell['chips']} CUDA card(s); "
            f"torch.cuda.is_available() is {torch.cuda.is_available()}")
        return 2
    try:
        import infidex_tpu_torch  # noqa: F401
    except ImportError as exc:
        log(f"the program infidex_tpu_torch cannot be imported: {exc}")
        return 2
    result = run_cell(manifest, args.workload, args.seed, args.seconds,
                      bool(args.trace))
    found = forbidden_modules()
    if found:
        log(f"forbidden modules were imported: {found}")
        return 3
    for line in check.lines(result["checks"]):
        log(line)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
