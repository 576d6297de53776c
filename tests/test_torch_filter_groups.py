"""Filters group by meaning in the port's batch entries.

``SearchEngine.search_many`` and ``search_batch`` put queries whose
filters mean the same into one pipeline group, with one pre-filter mask
(``filtering/columnar.py`` ``mask_key``: the filter's INFISCRIPT-V1
bytecode, with each constant's type and each range's inclusive flags),
however many times the filter was parsed. Held here on fielded titles
(the benchmark's ``imdb-basics-1m`` recipe at 2,000 titles):

* filters parsed apart from one text share one group and one mask
  evaluation, and the answers are those served with one shared object;
  a call with more distinct filters than the mask cache keeps still
  evaluates each once;
* filters whose ``str()`` agrees and whose keys must not never share a
  group; a ``DerivedFilter`` groups by identity; queries without a
  filter group as before;
* the port against the JAX package (given one object per distinct filter
  text, so that its identity groups are the port's, and every coverage
  job on its device route, as the port sends them: the JAX package's
  host oracle scores small and lone jobs in float64) under the
  refinement generator's four filter forms with facets on: ids and order
  exactly, scores within 4 float32 ulps, facets exactly. The bound is
  ``tests/test_torch_device.py``'s for Stage-1 scores: a typo query with
  no word hit answers with its Stage-1 list, whose fuzzy groups XLA's CPU
  backend sums with contracted multiply-adds (2 ulps seen here).
"""

import json
import os
import random

import numpy as np
import pytest
import torch

import infidex_tpu as ref
import infidex_tpu_torch as port
from benchmark.deployments import fielded
from benchmark.generators import refinements
from infidex_tpu_torch import runtime, tracing
from infidex_tpu_torch.filtering.columnar import mask_key

runtime.set_device("cpu")
torch.set_num_threads(1)

TITLES = 2000
#: score tolerance in float32 ulps (see the module docstring)
MAX_ULP = 4
CONFIG = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "benchmark", "configs",
    "imdb-basics-1m.json")
TRAFFIC = {"kinds": {"exact": 1, "typo": 1, "split": 1, "partial": 1},
           "filters": {"genre": 6, "decade": 5, "type": 3,
                       "genre_decade": 6}}
TEXTS = ["dark", "storm", "the shawshank", "redemption"]
FILTERS = ["genres CONTAINS 'Drama'", "start_year BETWEEN 1990 AND 1999",
           "title_type = 'movie'"]


@pytest.fixture(scope="module")
def made():
    with open(CONFIG) as f:
        config = json.load(f)
    config["corpus"] = dict(config["corpus"], titles=TITLES,
                            vocab_words=1000)
    return fielded.documents(config, 2**31 + 5)


def _engine(pkg, made):
    eng = pkg.SearchEngine.create_default()
    docs = []
    for i, title in enumerate(made.titles):
        fields = pkg.DocumentFields()
        fields.add_field("title", title, weight=pkg.Weight.MED)
        for name in fielded.FIELDS:
            fields.add_field(name, made.attributes[name][i],
                             indexable=False, filterable=True,
                             facetable=True)
        docs.append(pkg.Document(i, fields))
    eng.index_documents(docs)
    return eng


@pytest.fixture(scope="module")
def engine(made):
    return _engine(port, made)


def _query(pkg, text, filt, facets=True):
    q = pkg.Query(text, 10)
    q.filter = filt
    q.enable_facets = facets
    return q


def _answers(results):
    return [([(r.document_id, r.score) for r in res.records], res.facets)
            for res in results]


def _serve(eng, entry, queries):
    """(answers, counters, filter.evaluate spans) of one call, the mask
    cache emptied first."""
    eng._get_column_store()._masks.clear()
    tracing.start()
    try:
        out = getattr(eng, entry)(queries)
    finally:
        snap = tracing.stop()
    evaluated = sum(s.name == "filter.evaluate" for s in snap.spans)
    return _answers(out), snap.counters, evaluated


@pytest.mark.parametrize("entry", ["search_many", "search_batch"])
def test_one_text_shares_one_group_and_one_mask(engine, entry):
    pairs = [(t, f) for f in FILTERS for t in TEXTS]
    apart = [_query(port, t, port.Filter.parse(f)) for t, f in pairs]
    got, counters, evaluated = _serve(engine, entry, apart)
    assert counters["engine.pipeline_batches"] == len(FILTERS)
    assert evaluated == len(FILTERS)
    assert counters["prefilter.miss"] == len(FILTERS)
    assert counters.get("prefilter.hit", 0) == 0
    shared = {f: port.Filter.parse(f) for f in FILTERS}
    want, counters, _ = _serve(
        engine, entry, [_query(port, t, shared[f]) for t, f in pairs])
    assert counters["engine.pipeline_batches"] == len(FILTERS)
    assert got == want
    assert any(records for records, _ in got)
    assert all(facets for records, facets in got if records)


@pytest.mark.parametrize("entry", ["search_many", "search_batch"])
def test_more_filters_than_the_cache_are_each_evaluated_once(engine, entry):
    """The post-filter reads its group's pre-filter mask, so a call with
    more distinct filters than the store keeps evaluates each once; the
    most recently used masks are the ones kept."""
    from infidex_tpu_torch.filtering.columnar import ColumnStore

    texts = [f"start_year BETWEEN {y} AND {y}"
             for y in range(1930, 1936 + ColumnStore.MASK_CACHE)]
    got, counters, evaluated = _serve(engine, entry, [
        _query(port, "dark", port.Filter.parse(t)) for t in texts])
    assert counters["engine.pipeline_batches"] == len(texts)
    assert evaluated == len(texts)
    assert any(records for records, _ in got)
    tracing.start()
    try:
        getattr(engine, entry)([_query(port, "dark", port.Filter.parse(t))
                                for t in texts[-10:]])
    finally:
        snap = tracing.stop()
    assert snap.counters["prefilter.hit"] == 10
    assert "prefilter.miss" not in snap.counters


def _pair(name):
    parse, V, R = port.Filter.parse, port.ValueFilter, port.RangeFilter
    return {
        "exclusive_min": (parse("start_year > 1990"),
                          parse("start_year >= 1990")),
        "text_or_whole": (V("start_year", "1990"), V("start_year", 1990)),
        "float_or_text": (V("start_year", 1990.0), V("start_year", "1990.0")),
        "between_ends": (R("start_year", "1990", "1999", include_min=False,
                           include_max=False),
                         parse("start_year BETWEEN 1990 AND 1999")),
    }[name]


@pytest.mark.parametrize("entry", ["search_many", "search_batch"])
@pytest.mark.parametrize("name", ["exclusive_min", "text_or_whole",
                                  "float_or_text", "between_ends"])
def test_filters_printed_alike_never_share_a_group(engine, entry, name):
    a, b = _pair(name)
    assert str(a) == str(b)
    assert mask_key(a) != mask_key(b)
    if name in ("float_or_text", "between_ends"):
        # one bytecode, two masks: the bytecode alone would merge them
        assert a.compile_to_bytes() == b.compile_to_bytes()
        store = engine._get_column_store()
        assert (store.evaluate(a) != store.evaluate(b)).any()
    got, counters, evaluated = _serve(
        engine, entry, [_query(port, "dark", a), _query(port, "dark", b)])
    assert counters["engine.pipeline_batches"] == 2 and evaluated == 2
    alone = [_serve(engine, entry, [_query(port, "dark", f)])[0][0]
             for f in (a, b)]
    assert got == alone


@pytest.mark.parametrize("entry", ["search_many", "search_batch"])
def test_derived_filters_group_by_identity(engine, entry):
    def recent(v):
        return v is not None and int(v) >= 1990

    one = port.DerivedFilter("start_year", recent)
    other = port.DerivedFilter("start_year", recent)
    assert mask_key(one) == ("id", id(one)) != mask_key(other)
    _, counters, _ = _serve(engine, entry, [
        _query(port, t, one) for t in TEXTS] + [_query(port, "dark", other)])
    assert counters["engine.pipeline_batches"] == 2
    got, _, evaluated = _serve(engine, entry, [_query(port, "dark", one)])
    assert evaluated == 0          # a derived filter only post-filters
    assert got[0][0] and all(
        recent(engine.get_document(d).fields.get_field("start_year").value)
        for d, _ in got[0][0])


@pytest.mark.parametrize("entry", ["search_many", "search_batch"])
def test_queries_without_filters_group_as_before(engine, entry):
    queries = [_query(port, t, None, facets=False) for t in TEXTS * 2]
    deep = _query(port, "dark", None, facets=False)
    deep.coverage_depth = 50
    _, counters, evaluated = _serve(engine, entry, queries + [deep])
    assert counters["engine.pipeline_batches"] == 2
    assert evaluated == 0 and "prefilter.miss" not in counters
    assert mask_key(None) is None


def test_port_and_jax_agree_on_refinements(made, engine, monkeypatch):
    from infidex_tpu.scoring import pipeline as jax_pipeline

    monkeypatch.setattr(jax_pipeline, "DEVICE_COVERAGE_MIN_CANDIDATES", 1)
    monkeypatch.setattr(jax_pipeline, "DEVICE_COVERAGE_MIN_SINGLE", 1)
    specs = refinements.queries(made, TRAFFIC, 96, random.Random(11))
    assert {dict(s.options)["filter"].split(" ")[0] for s in specs} == \
        {"genres", "start_year", "title_type"}
    jax_eng = _engine(ref, made)
    objects = {}
    jax_queries = []
    for s in specs:
        text = dict(s.options)["filter"]
        if text not in objects:
            objects[text] = ref.Filter.parse(text)
        jax_queries.append(_query(ref, s.text, objects[text]))
    want = _answers(jax_eng.search_many(jax_queries, batch_size=32))
    got = _answers(engine.search_many(
        [_query(port, s.text, port.Filter.parse(dict(s.options)["filter"]))
         for s in specs], batch_size=32))
    assert sum(len(records) for records, _ in got) > 0
    for s, (wr, wf), (gr, gf) in zip(specs, want, got):
        assert [d for d, _ in gr] == [d for d, _ in wr], s
        ws = np.asarray([v for _, v in wr], np.float32)
        gs = np.asarray([v for _, v in gr], np.float32)
        ulps = np.abs(ws.view(np.int32).astype(np.int64)
                      - gs.view(np.int32).astype(np.int64))
        assert ulps.max(initial=0) <= MAX_ULP, s
        assert gf == wf, s
