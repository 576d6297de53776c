"""A new deployment and a new generator arrive as new files only.

``extra/`` holds a configuration, a traffic file, a deployment and a
generator that are for these tests alone (titles of 4-9 invented words,
queries of 2-4 words of a title). The tests point the harness's lookup of
data files and modules (``run._data``, ``run._module``) at ``extra/``
first and drive ``run.run_cell`` on the CPU as a run drives a cell: sound,
it comes out correct; with an answer altered, or a reference that adds a
number above its limit, not. The check's draw of calls and sample, its
rounds, and the entries' options are tested here too."""

import copy
import importlib.util
import json
import os

import pytest
import torch

from benchmark import check, run
from benchmark.entries import make_query
from benchmark.generators import Spec
from test_bench_faults import alter_answer

EXTRA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "extra")
CELL = "words3k.batch-phrases"
SEED = 2**31 + 4099


@pytest.fixture
def new_files(monkeypatch):
    """The harness's lookups, ``extra/`` first; returns the manifest with
    the new configuration and cell beside the repository's."""
    data, module = run._data, run._module
    loaded = {}

    def extra_data(kind, name):
        path = os.path.join(EXTRA, kind, f"{name}.json")
        if not os.path.exists(path):
            return data(kind, name)
        with open(path) as f:
            return json.load(f)

    def extra_module(kind, name):
        path = os.path.join(EXTRA, kind, f"{name}.py")
        if not os.path.exists(path):
            return module(kind, name)
        if path not in loaded:
            spec = importlib.util.spec_from_file_location(
                f"benchmark_tests_extra.{kind}.{name}", path)
            loaded[path] = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(loaded[path])
        return loaded[path]

    monkeypatch.setattr(run, "_data", extra_data)
    monkeypatch.setattr(run, "_module", extra_module)
    manifest = copy.deepcopy(run.load_manifest())
    manifest["configs"].append({"name": "words-3k", "source": "tests",
                                "file": "extra/configs/words-3k.json",
                                "reduced": [], "why": "tests"})
    manifest["workloads"].append({"name": CELL, "config": "words-3k",
                                  "traffic": "batch-phrases", "chips": 1,
                                  "why": "tests"})
    return manifest, extra_module


def _run(manifest, tamper=None):
    torch.set_num_threads(2)
    return run.run_cell(manifest, CELL, SEED, 1.0, False, device="cpu",
                        shrink={}, tamper=tamper)


def test_new_deployment_and_generator_run_correct(new_files):
    manifest, _ = new_files
    kept = {}
    res = _run(manifest, tamper=lambda ctx: kept.update(ctx=ctx))
    assert res["correct"], res
    assert set(res["checks"]) == set(check.LIMITS)
    assert all(v["value"] == 0 for v in res["checks"].values())
    assert set(res["metrics"]) == {"memory_peak_mib", "setup_s"}
    ctx = kept["ctx"]
    assert all(4 <= len(t.split()) <= 9 for t in ctx.made.titles)
    specs = ctx.gen.queries(ctx.made, ctx.traffic, 64,
                            run.generators.streams(1)["timed"])
    assert all(2 <= len(s.text.split()) <= 4 for s in specs)


def test_new_deployment_with_an_answer_altered_is_not_correct(new_files):
    manifest, _ = new_files
    res = _run(manifest, tamper=alter_answer)
    assert not res["correct"]
    assert res["checks"]["mismatched"]["value"] > 0


@pytest.mark.parametrize("extra, correct", [(1, False), (0, True)])
def test_a_reference_may_add_a_number_of_its_own(new_files, monkeypatch,
                                                  extra, correct):
    manifest, lookup = new_files
    dep = lookup("deployments", "words")
    judge = dep.judge

    def judge_more(ref, specs, *a, **k):
        numbers = judge(ref, specs, *a, **k)
        numbers["stub_extra"] = {"value": extra, "limit": 0,
                                 "of": len(specs)}
        return numbers

    monkeypatch.setattr(dep, "judge", judge_more)
    res = _run(manifest)
    assert res["correct"] is correct
    assert res["checks"]["stub_extra"] == {"value": extra, "limit": 0}
    assert res["checks"]["mismatched"]["value"] == 0
    assert f"check stub_extra: {extra} (limit 0)" in \
        check.lines(res["checks"])


def _engine(titles):
    import infidex_tpu_torch as it
    from infidex_tpu_torch import runtime

    runtime.set_device("cpu")
    eng = it.SearchEngine.create_default()
    eng.index_documents([it.Document(i, t) for i, t in enumerate(titles)])
    return it, eng


def test_sample_leaves_out_what_a_call_makes_ambiguous():
    """Calls are drawn until MIN_CALLS of them hold enough queries; a
    query whose text its call also holds with other options (the
    pipeline keys its state by text) is never sampled."""
    import random

    shallow = (("coverage_depth", 50),)
    specs = [Spec("Dark"), Spec("dark", shallow), Spec("knight"),
             Spec("dark"), Spec("river"), Spec("storm"), Spec("crown"),
             Spec("dark", shallow), Spec("empire"), Spec("river")]
    calls = [(0, 3), (3, 4), (4, 6), (6, 8), (8, 10)]
    for seed in range(20):
        drawn, sample = check.draw_sample(random.Random(seed), specs, calls,
                                          3)
        assert len(drawn) >= check.MIN_CALLS and drawn == sorted(drawn)
        assert len(sample) == 3 and sample == sorted(sample)
        assert not {0, 1} & set(sample)
        assert all(any(calls[c][0] <= i < calls[c][1] for c in drawn)
                   for i in sample)
    drawn, sample = check.draw_sample(random.Random(1), specs, calls, 100)
    assert drawn == list(range(5)) and sample == [2] + list(range(3, 10))


def test_calls_are_served_again_whole_and_judged_apart():
    """Each drawn call is served again as one call, with its own state;
    calls whose states read a text otherwise go to rounds of their own
    (a coverage depth of 50 gives a Stage-1 list of 50)."""
    from benchmark.deployments import titles

    torch.set_num_threads(2)
    made = titles.documents({"corpus": dict(
        run._data("configs", "movies-1m")["corpus"], titles=2000,
        vocab_words=1000)}, 3)
    it, eng = _engine(made.titles)
    shallow = (("coverage_depth", 50),)
    specs = [Spec("dark"), Spec("knight"), Spec("dark", shallow),
             Spec("knight"), Spec("dark")]
    calls = [(0, 2), (2, 3), (3, 5)]
    served = []

    def replay(chunk):
        served.append(chunk)
        return eng.search_many([make_query(it, s, 10) for s in chunk],
                               batch_size=16)

    replays = check.replay_calls(replay, eng._pipeline, specs, calls, 10)
    assert served == [specs[lo:hi] for lo, hi in calls]
    assert [len(got) for got, _ in replays] == [2, 1, 2]
    assert len(replays[1][1]["dark"]["stage1_all"]) == 50
    assert len(replays[0][1]["dark"]["stage1_all"]) > 50
    groups = check.rounds([st for _, st in replays])
    assert [members for members, _ in groups] == [[0, 2], [1]]
    assert groups[0][1]["knight"] == replays[2][1]["knight"]


def test_rounds_add_up():
    a = {"mismatched": {"value": 1, "limit": 0, "of": 3}}
    b = {"mismatched": {"value": 2, "limit": 0, "of": 4},
         "extra": {"value": 0, "limit": 0, "of": 4}}
    assert check.total([a, b]) == {
        "mismatched": {"value": 3, "limit": 0, "of": 7},
        "extra": {"value": 0, "limit": 0, "of": 4}}
    with pytest.raises(ValueError, match="limits"):
        check.total([a, {"mismatched": {"value": 0, "limit": 1, "of": 1}}])


def test_entries_pass_a_specs_options_to_query():
    import infidex_tpu_torch as it

    q = make_query(it, Spec("dark", (("enable_facets", True),
                                     ("filter", "genre = 'Drama'"))), 7)
    assert (q.text, q.max_number_of_records_to_return) == ("dark", 7)
    assert q.enable_facets is True and isinstance(q.filter, it.Filter)
    with pytest.raises(ValueError, match="no_such_option"):
        make_query(it, Spec("dark", (("no_such_option", 1),)), 7)


def test_titles_reference_refuses_options():
    from benchmark.deployments import titles

    with pytest.raises(ValueError, match="options"):
        titles.judge(None, [Spec("dark", (("enable_facets", True),))],
                     [None], [None], {}, 10)
