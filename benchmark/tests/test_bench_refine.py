"""The fielded deployment (``deployments/fielded.py``), its refinement
generator (``generators/refinements.py``) and its reference
(``reference/refine.py``), driven through the harness on the CPU at 3,000
fielded titles: a sound run is correct with every number at 0; with the
program's pre-filter bypassed, a facet count altered or a record that
fails its filter, it is not. Also the generator's mix, the reference's
filters against the program's masks, the cell's readers, and the
control (bfloat16 final scores) on the cell, which is mismatched."""

import random
from types import SimpleNamespace

import numpy as np
import pytest

from benchmark import program_trace, run
from benchmark.record import Record
from benchmark.reference import refine
from benchmark.reference.stats import Corpus
from helpers import cpu_run

CELL = "imdb1m.batch-refine"
SHRINK = {"config": {"corpus": {"titles": 3000, "vocab_words": 2000}},
          "traffic": {"batch_size": 16, "call_batches": 2, "warmup_calls": 1,
                      "check_sample": 24}}
READERS = ["prefilter_ms.batch", "prefilter_hit_share.batch",
           "facets_ms.batch", "pipeline_batches.batch"]


def _run(tamper=None, trace=False):
    return cpu_run(CELL, trace=trace, tamper=tamper, shrink=SHRINK)


def _after_each_answer(ctx, change):
    """``change(query, result)`` on every answer, after the deployment's
    recorder kept it."""
    serve = ctx.eng.search_many

    def changed(queries, *a, **k):
        out = serve(queries, *a, **k)
        for q, r in zip(queries, out):
            change(ctx, q, r)
        return out

    ctx.eng.search_many = changed


def _bump_a_facet(ctx, q, r):
    for pairs in r.facets.values():
        value, count = pairs[0]
        pairs[0] = (value, count + 1)        # in place: the kept dict too
        return


def _a_record_that_fails(ctx, q, r):
    if not r.records:
        return
    mask = ctx.eng._get_column_store().evaluate(q.filter)
    r.records[0].document_id = int(np.flatnonzero(~mask)[0])


def test_sound_run_is_correct_with_every_number_at_0():
    res = _run(trace=True)
    assert res["correct"], res
    assert set(res["checks"]) == set(refine.LIMITS)
    assert all(v["value"] == 0 for v in res["checks"].values())
    assert set(res["metrics"]) == set(READERS)
    assert 1 <= res["metrics"]["pipeline_batches.batch"]["value"] <= 16


def test_prefilter_bypassed_is_not_correct(monkeypatch):
    import infidex_tpu_torch as it

    monkeypatch.setattr(it.SearchEngine, "_prefilter_mask",
                        lambda self, filt, key: None)
    res = _run()
    assert not res["correct"]
    assert res["checks"]["filter_violations"]["value"] > 0
    assert res["checks"]["stage1_top"]["value"] > 0


def test_a_facet_count_altered_is_facets_mismatched():
    res = _run(tamper=lambda ctx: _after_each_answer(ctx, _bump_a_facet))
    assert not res["correct"]
    assert res["checks"]["facets_mismatched"]["value"] > 0
    assert res["checks"]["mismatched"]["value"] == 0


def test_a_record_that_fails_its_filter_is_a_filter_violation():
    res = _run(tamper=lambda ctx: _after_each_answer(
        ctx, _a_record_that_fails))
    assert not res["correct"]
    assert res["checks"]["filter_violations"]["value"] > 0


@pytest.fixture(scope="module")
def made():
    config = run._data("configs", "imdb-basics-1m")
    run._merge(config, SHRINK["config"])
    from benchmark.deployments import fielded
    return fielded.documents(config, 2**31 + 99)


def test_generator_sends_the_mix_from_the_seed(made):
    from benchmark.generators import refinements

    traffic = run._data("traffic", "batch-refine")
    rng = random.Random(3)
    specs = refinements.queries(made, traffic, 400, rng)
    assert all(dict(s.options)["enable_facets"] is True for s in specs)
    forms = [dict(s.options)["filter"] for s in specs]
    want = {"genre": 6, "decade": 5, "type": 3, "genre_decade": 6}
    for lo in range(0, 400, 20):
        block = forms[lo:lo + 20]
        got = {"genre_decade": sum(" AND start_year" in f for f in block),
               "type": sum(f.startswith("title_type") for f in block),
               "decade": sum(f.startswith("start_year") for f in block)}
        got["genre"] = 20 - sum(got.values())
        assert got == want
    assert refinements.queries(made, traffic, 400, random.Random(3)) == specs
    ref = refine.Reference(Corpus(made.titles), made.attributes)
    assert min(ref.mask(f).sum() for f in forms) >= 1


def test_reference_filters_are_the_programs_masks(made):
    import infidex_tpu_torch as it
    from infidex_tpu_torch import runtime
    from infidex_tpu_torch.filtering.columnar import ColumnStore
    from benchmark.generators import refinements

    runtime.set_device("cpu")
    docs = it.DocumentCollection()
    for i in range(len(made.titles)):
        fields = it.DocumentFields()
        for name in ("title_type", "start_year", "genres"):
            fields.add_field(name, made.attributes[name][i], indexable=False,
                             filterable=True)
        docs.add_document(it.Document(i, fields))
    store = ColumnStore(docs)
    ref = refine.Reference(Corpus(made.titles), made.attributes)
    traffic = run._data("traffic", "batch-refine")
    texts = {dict(s.options)["filter"] for s in refinements.queries(
        made, traffic, 200, random.Random(5))}
    texts |= {"genres CONTAINS 'music'", "title_type = 'MOVIE'"}
    for text in sorted(texts):
        np.testing.assert_array_equal(
            ref.mask(text), store.evaluate(it.Filter.parse(text)), text)
    with pytest.raises(ValueError):
        refine.parse("genres LIKE 'Dr%'")


@pytest.mark.parametrize("name", READERS)
def test_readers_read_nothing_without_the_programs_records(name):
    assert run.reader(name).read(Record()) is None
    rec = Record()
    rec.window, rec.batches = (0.0, 1.0), 2
    setattr(rec, program_trace.KEY, SimpleNamespace(
        tracing=object(), build=None,
        snap=SimpleNamespace(spans=[], counters={"conj_memo.hit": 3})))
    assert run.reader(name).read(rec) is None


def test_control_is_mismatched():
    from benchmark import control

    (line,) = control.readings(run.load_manifest(), [CELL], 2**31 + 1, 256,
                               device="cpu", shrink=dict(SHRINK, traffic={
                                   "check_sample": 32}))
    assert line["mismatched"] > line["of"] // 2, line
    assert line["stage1_scores"] == line["of"], line
