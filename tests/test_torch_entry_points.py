"""The engine's single-query, async, persistence and segment entry points
through the port (infidex_tpu_torch, plain PyTorch on the CPU).

Two kinds of check:

* against the reference (infidex_tpu, JAX on the CPU) on the same
  inputs: ids and their order exact, scores within 1 f32 ulp (XLA's FMA
  contraction and log1p on the CPU; see tests/test_torch_engine.py);
* the reference suite's own corpora and expectations, run on the port:
  the tests of tests/test_mmap_serving.py, test_golden_regressions.py,
  test_school_parity.py and test_incremental_and_concurrency.py are
  imported (not copied) and run with their modules' reference names
  (``SearchEngine``, ``Document``, ``Query``, ...) bound to the port's.
"""

import importlib
import os
import sys
import types

import numpy as np
import pytest
import torch

import bench
import infidex_tpu as ref
import infidex_tpu_torch as port
from infidex_tpu_torch import runtime
from infidex_tpu_torch.index import mmap_serving as port_mmap
from tests import test_golden_regressions as golden
from tests import test_incremental_and_concurrency as incremental
from tests import test_mmap_serving as mmap_tests
from tests import test_school_parity as school

runtime.set_device("cpu")
# the suite runs in several worker processes on shared cores; one intra-op
# thread each keeps torch from oversubscribing them
torch.set_num_threads(1)


def _source(name, val) -> str:
    """The module that ``val`` (bound to ``name`` in a test module) comes
    from, for the classes, functions and modules that a suite imports
    ("" for everything else)."""
    if isinstance(val, types.ModuleType):
        return val.__name__
    if callable(val) and not name.startswith("test"):
        return getattr(val, "__module__", None) or ""
    return ""


def _bind_to_port(mp, mod):
    """Rebind every class, function and module that ``mod`` imported from
    the reference package to the port's object of the same module and
    name."""
    for name, val in list(vars(mod).items()):
        src = _source(name, val)
        if not src.startswith("infidex_tpu."):
            continue
        pmod = importlib.import_module("infidex_tpu_torch"
                                       + src[len("infidex_tpu"):])
        mp.setattr(mod, name, pmod if isinstance(val, types.ModuleType)
                   else getattr(pmod, val.__name__))


def _port_in_sys_modules(mp, *names):
    """For tests that import inside their bodies: ``import infidex_tpu``
    (and each ``infidex_tpu.<name>``) resolves to the port's module while
    ``mp`` holds."""
    for name in ("",) + tuple("." + n for n in names):
        mp.setitem(sys.modules, "infidex_tpu" + name,
                   importlib.import_module("infidex_tpu_torch" + name))


def reference_suites_on_port(*suites, sys_modules=None):
    """For a test module that runs the reference test modules ``suites``
    on the port: (a module-scoped autouse fixture that binds their
    reference names to the port's objects and, where ``sys_modules`` is a
    tuple, the reference package and those of its submodules in
    ``sys.modules`` too; a test that the names are bound)."""

    @pytest.fixture(scope="module", autouse=True)
    def bound():
        mp = pytest.MonkeyPatch()
        try:
            for mod in suites:
                _bind_to_port(mp, mod)
            if sys_modules is not None:
                _port_in_sys_modules(mp, *sys_modules)
            yield
        finally:
            mp.undo()

    def names_are_bound():
        for mod in suites:
            for name, val in vars(mod).items():
                assert not _source(name, val).startswith("infidex_tpu."), (
                    mod.__name__, name)
            if hasattr(mod, "SearchEngine"):
                assert mod.SearchEngine is port.SearchEngine, mod.__name__
                assert mod.Query is port.Query, mod.__name__

    return bound, names_are_bound


_reference_tests_on_the_port, _names_are_bound = reference_suites_on_port(
    golden, incremental, mmap_tests, school)


def _flat(results):
    return [[(r.document_id, np.float32(r.score)) for r in res.records]
            for res in results]


def _assert_close(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert [i for i, _ in g] == [i for i, _ in w]
        for (_, a), (_, b) in zip(g, w):
            assert abs(int(np.array(a).view(np.int32))
                       - int(np.array(b).view(np.int32))) <= 1


def _engine(pkg, titles):
    eng = pkg.SearchEngine.create_default()
    eng.index_documents([pkg.Document(i, t) for i, t in enumerate(titles)])
    return eng


@pytest.fixture(scope="module")
def corpus():
    titles = bench.make_corpus(3000)
    return titles, bench.make_queries(titles, 24) + ["shawshenk"]


@pytest.fixture(scope="module")
def port_engine(corpus):
    return _engine(port, corpus[0])


def test_search_and_search_async_match_reference(corpus, port_engine):
    titles, queries = corpus
    ref_eng = _engine(ref, titles)
    want = _flat([ref_eng.search(ref.Query(q, 10)) for q in queries])
    m = port_engine.vector_model
    calls = []
    orig = m.host_stage1.search_batch
    m.host_stage1.search_batch = lambda *a, **k: calls.append(1) or orig(
        *a, **k)
    try:
        got = _flat([port_engine.search(port.Query(q, 10)) for q in queries])
    finally:
        del m.host_stage1.search_batch
    assert calls, "no query took the host Stage-1 route"
    assert isinstance(m.host_stage1, port_mmap.MmapStage1)
    _assert_close(got, want)
    assert got[-1][0][0] == 0                 # "shawshenk" -> doc 0
    futs = [port_engine.search_async(port.Query(q, 10)) for q in queries]
    assert _flat([f.result(timeout=300) for f in futs]) == got
    batch = _flat(port_engine.search_batch([port.Query(q, 10)
                                            for q in queries]))
    assert batch == got


def test_index_documents_async_matches_sync(corpus, port_engine):
    titles, queries = corpus
    eng = port.SearchEngine.create_default()
    eng.index_documents_async([port.Document(i, t) for i, t in
                               enumerate(titles)]).result(timeout=300)
    qs = [port.Query(q, 10) for q in queries[:8]]
    assert _flat(eng.search_batch(qs)) == _flat(port_engine.search_batch(qs))


def test_save_load_roundtrip_and_reference_snapshot(corpus, port_engine,
                                                    tmp_path):
    titles, queries = corpus
    qs = queries[:8]
    before = _flat([port_engine.search(port.Query(q, 10)) for q in qs])
    p = str(tmp_path / "port.bin")
    port_engine.save(p)
    loaded = port.SearchEngine.load(p)
    assert _flat([loaded.search(port.Query(q, 10)) for q in qs]) == before
    # a snapshot written by the reference loads into the port
    ref_eng = _engine(ref, titles)
    p_ref = str(tmp_path / "ref.bin")
    ref_eng.save(p_ref)
    from_ref = port.SearchEngine.load(p_ref)
    _assert_close(_flat([from_ref.search(port.Query(q, 10)) for q in qs]),
                  _flat([ref_eng.search(ref.Query(q, 10)) for q in qs]))


def _mmap_engine(pkg, tmp):
    titles = mmap_tests._corpus()
    tmp.mkdir()
    eng = _engine(pkg, titles[:500])
    eng.flush(str(tmp / "seg0.ifts"), materialize=False)
    for i, t in enumerate(titles[500:]):
        eng.index_document(pkg.Document(500 + i, t))
    eng.calculate_weights()
    return eng


def test_mmap_serving_matches_reference(tmp_path, monkeypatch):
    """flush(materialize=False), then the host route (single queries)
    and device streaming (batches above HOST_S1_MAX_BATCH) against the
    reference's mmap engine."""
    texts = ["alpha document", "charlie", "foxtrot echo", "document 42",
             "charlei", "india juliet golf", "bravo 17", "hotel"]
    want_eng = _mmap_engine(ref, tmp_path / "ref")
    got_eng = _mmap_engine(port, tmp_path / "port")
    s1 = got_eng.vector_model._mmap_stage1
    assert isinstance(s1, port_mmap.MmapStage1) and s1.device_stream
    streamed = []
    orig = port_mmap.MmapStage1._dispatch_group
    monkeypatch.setattr(port_mmap.MmapStage1, "_dispatch_group",
                        lambda self, *a: streamed.append(1) or orig(self, *a))
    single = _flat([got_eng.search(port.Query(t, 10)) for t in texts])
    assert not streamed
    _assert_close(single,
                  _flat([want_eng.search(ref.Query(t, 10)) for t in texts]))
    batch = _flat(got_eng.search_batch([port.Query(t, 10) for t in texts]))
    assert streamed, "the batch did not stream through the device"
    _assert_close(batch, _flat(want_eng.search_batch(
        [ref.Query(t, 10) for t in texts])))


# --- the reference suite's tests, on the port ---------------------------

def test_reference_names_are_bound_to_the_port():
    _names_are_bound()
    assert incremental.IndexMerger.__module__.startswith("infidex_tpu_torch")


engines = mmap_tests.engines
test_segment_postings_not_resident = \
    mmap_tests.test_segment_postings_not_resident
test_exact_query_spans_segment_and_memory = \
    mmap_tests.test_exact_query_spans_segment_and_memory
test_ranking_matches_materialized_engine = \
    mmap_tests.test_ranking_matches_materialized_engine
test_typo_query_reaches_segment_docs = \
    mmap_tests.test_typo_query_reaches_segment_docs
test_device_streaming_matches_resident_device = \
    mmap_tests.test_device_streaming_matches_resident_device
test_device_streaming_facade_parity = \
    mmap_tests.test_device_streaming_facade_parity
# last of the mmap tests: saving materializes the shared engine
test_save_materializes_and_roundtrips = \
    mmap_tests.test_save_materializes_and_roundtrips


class TestFuzzyRegressionOnPort(golden.TestFuzzyRegression):
    pass


class TestReferenceMatchingOnPort(golden.TestReferenceMatching):
    pass


class TestSegmentTrackingOnPort(golden.TestSegmentTracking):
    pass


class TestIncrementalOnPort(incremental.TestIncremental):
    pass


class TestThreadSafetyOnPort(incremental.TestThreadSafety):
    pass


@pytest.fixture(scope="module")
def engine():
    """The school corpus engine, built by the reference fixture's own
    code with the port's names (the corpus file is not always present)."""
    if not os.path.exists(school.SCHOOLS_JSON):
        pytest.skip("schools.json corpus not present")
    return school.engine.__wrapped__()


class TestBelohradOnPort(school.TestBelohrad):
    pass


class TestScioZlinOnPort(school.TestScioZlin):
    pass


class TestDiacriticsFoldingOnPort(school.TestDiacriticsFolding):
    pass


class TestScioCityRoutingOnPort(school.TestScioCityRouting):
    pass


class TestSkolaZlinSOnPort(school.TestSkolaZlinS):
    pass


class TestTyrsovkaOnPort(school.TestTyrsovka):
    pass


class TestZlinskaAdjectiveOnPort(school.TestZlinskaAdjective):
    pass
