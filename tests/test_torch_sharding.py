"""Sharded serving in the port (infidex_tpu_torch/parallel/sharding.py)
against the reference's shard_map programs (JAX on the conftest's
8-device CPU mesh) and against the port's own single-device path.

* ``_stable_merge`` on heavy-tie per-shard lists: exact against the
  reference's merge;
* ``ShardedDeviceIndex.search_batch`` (8 and 3 CPU shards) on the
  200-doc model of tests/test_sharding.py, with fuzzy groups: against the
  reference's ``sharded_stage1_batch`` ids and LIM rows exact and scores
  within 4 ulp (XLA's CPU FMA contraction of the BM25+ factor, ROADMAP
  §3); against the port's ``DeviceIndex.search_batch`` ids, scores and LIM
  rows bit-equal;
* ``sharded_coverage_batch`` against the reference's: score row within 1
  ulp, integer rows exact;
* the tests of tests/test_sharded_engine.py and tests/test_sharding.py,
  imported and run with their module's reference names bound to the
  port's (``test_sharded_matches_single``: the single-query
  ``ShardedDeviceIndex.search`` against ``DeviceIndex.search``);
* whole engines: 8 and 3 shards against a one-shard mesh on the bench
  corpus (identical records), and the reference's sharded engine against
  the port's (ids exact, scores within 1 ulp).
"""

import importlib
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bench
import infidex_tpu as ref
import infidex_tpu_torch as port
from infidex_tpu.index.vector_model import VectorModel as RefVectorModel
from infidex_tpu.parallel import sharding as ref_sharding
from infidex_tpu.tokenization.normalizer import TextNormalizer
from infidex_tpu.tokenization.tokenizer import Tokenizer, TokenizerSetup
from infidex_tpu_torch import convert, runtime
from infidex_tpu_torch.index.device import DeviceIndex, stable_top_k
from infidex_tpu_torch.parallel import sharding
from tests import test_sharded_engine as engine_tests
from tests import test_sharding as sharding_tests
from tests.test_torch_entry_points import _bind_to_port

runtime.set_device("cpu")
# the suite runs in several worker processes on shared cores; one intra-op
# thread each keeps torch from oversubscribing them
torch.set_num_threads(1)


@pytest.fixture(scope="module", autouse=True)
def _reference_tests_on_the_port():
    mp = pytest.MonkeyPatch()
    try:
        for mod in (engine_tests, sharding_tests):
            _bind_to_port(mp, mod)
        yield
    finally:
        mp.undo()


def _ulps(a, b):
    a = np.asarray(a, np.float32).view(np.int32).astype(np.int64)
    b = np.asarray(b, np.float32).view(np.int32).astype(np.int64)
    return int(np.abs(a - b).max(initial=0))


# --- _stable_merge --------------------------------------------------------

@pytest.mark.parametrize("seed,n_shards,k", [(0, 4, 10), (1, 8, 7),
                                             (2, 3, 25), (3, 5, 1)])
def test_stable_merge_matches_reference_on_heavy_ties(seed, n_shards, k):
    """Each shard's stable local top-k of scores drawn from four values
    (most rows tie), merged: the same scores and ids as the reference."""
    rng = np.random.default_rng(seed)
    size, n_q = 40, 6
    scores = rng.choice(np.float32([0.0, 1.5, 2.0, 3.25]),
                        (n_q, n_shards * size)).astype(np.float32)
    k_local = min(k, size)
    tops_s, tops_i = [], []
    for s in range(n_shards):
        ts, ti = stable_top_k(torch.from_numpy(
            scores[:, s * size:(s + 1) * size]), k_local)
        tops_s.append(ts)
        tops_i.append(ti + s * size)
    all_s = torch.cat(tops_s, 1)
    all_i = torch.cat(tops_i, 1)
    got_s, got_i = sharding._stable_merge(all_s, all_i, k)
    want_s, want_i = ref_sharding._stable_merge(
        jnp.asarray(all_s.numpy()), jnp.asarray(all_i.numpy()), k)
    assert np.array_equal(got_s.numpy().view(np.int32),
                          np.asarray(want_s).view(np.int32))
    assert np.array_equal(got_i.numpy(), np.asarray(want_i))
    # and the unsharded top-k of the whole rows
    one_s, one_i = stable_top_k(torch.from_numpy(scores), k)
    assert torch.equal(got_i.int(), one_i) and torch.equal(got_s, one_s)


@pytest.mark.parametrize("seed,n_shards,k2", [(0, 4, 256), (1, 8, 5),
                                              (2, 3, 40), (3, 2, 1)])
def test_lim_merge_equals_the_lowest_ids(seed, n_shards, k2):
    """Per-shard LIM rows (ascending ids of rising windows, then pads),
    merged: the ``k2`` lowest of their ids ascending, as the reference's
    ``top_k`` of the negated ids takes them; rows with no ids, with fewer
    than ``k2`` and with ids in one shard only."""
    rng = np.random.default_rng(seed)
    size, n_q, pad = 500, 7, 1 << 24
    rows = []
    for s in range(n_shards):
        m = rng.random((n_q, size)) < rng.choice([0.0, 0.002, 0.05, 0.5],
                                                  (n_q, 1))
        m[0] = False
        if s:
            m[1] = False
        ids = np.where(m, np.arange(size)[None, :] + s * size, pad)
        rows.append(np.sort(ids, axis=1)[:, :k2])
    lows = torch.from_numpy(np.concatenate(rows, axis=1).astype(np.int64))
    want = torch.topk(lows, k2, dim=1, largest=False, sorted=True).values
    got = sharding._lim_merge(lows, k2, pad)
    assert torch.equal(got, want)
    assert (got[0] == pad).all() and (got[1] < pad).sum() <= k2


# --- Stage 1 ---------------------------------------------------------------

WORDS = ["alpha", "bravo", "charlie", "delta", "echo", "foxtrot", "golf",
         "hotel", "india", "juliet", "kilo", "lima"]


@pytest.fixture(scope="module")
def ref_model():
    """tests/test_sharding.py's model, built by the reference."""
    tok = Tokenizer([3], 2, 0, TextNormalizer.create_default(),
                    TokenizerSetup())
    m = RefVectorModel(tok)
    rng = np.random.default_rng(42)
    for i in range(200):
        text = " ".join(rng.choice(WORDS, size=rng.integers(2, 6)))
        m.index_document(ref.Document(i, text))
    m.build_inverted_lists()
    return m


def _stage1_queries(m):
    """(term_ids, idfs, fuzzy_groups) per query: plain terms, several
    terms, and fuzzy groups (two groups in one query, one group alone)."""
    tid = {t: i for i, t in enumerate(m.built.terms)}
    ids = [tid[t] for t in m.built.terms if len(t) == 3][:40]
    rng = np.random.default_rng(5)
    out = []
    for n_terms, n_groups in ((2, 0), (5, 0), (3, 1), (0, 1), (4, 2),
                              (1, 0), (8, 0), (2, 2)):
        t = rng.choice(ids, n_terms, replace=False)
        idfs = (rng.random(n_terms) * 3 + 0.2).astype(np.float32)
        groups = [rng.choice(ids, int(rng.integers(1, 6)), replace=False)
                  for _ in range(n_groups)]
        out.append((t.astype(np.int64), idfs, groups))
    return out


@pytest.mark.parametrize("n_shards", [8, 3])
def test_sharded_stage1_matches_reference_and_single_device(ref_model,
                                                            n_shards):
    queries = _stage1_queries(ref_model)
    k = 50
    want = ref_sharding.ShardedDeviceIndex(
        ref_model.built, ref_sharding.make_mesh(n_shards)).search_batch(
            queries, k, total_docs=200, stop_term_limit=150)
    built = convert.built_index_from_reference(ref_model.built)
    mesh = sharding.make_mesh(n_shards)
    assert mesh == [torch.device("cpu")] * n_shards
    sdi = sharding.ShardedDeviceIndex(built, mesh)
    assert sdi.n_pad % (8 * n_shards) == 0
    got = sdi.search_batch(queries, k, total_docs=200, stop_term_limit=150)
    single = DeviceIndex(built).search_batch(queries, k, total_docs=200,
                                             stop_term_limit=150)
    assert len(got) == len(want) == len(single) == len(queries)
    for (gs, gi, gl), (ws, wi, wl), (ss, si, sl) in zip(got, want, single):
        assert np.array_equal(gi, wi) and np.array_equal(gl, wl)
        assert _ulps(gs, ws) <= 4
        assert np.array_equal(gi, si) and np.array_equal(gl, sl)
        assert np.array_equal(gs.view(np.int32), ss.view(np.int32))
    assert any((s > 0).sum() > 10 for s, _, _ in got)


def test_sharded_stage1_deletes_and_lane_groups(ref_model, monkeypatch):
    """Deleted docs drop out on every shard; a batch split into several
    lane groups gives the results of one group."""
    built = convert.built_index_from_reference(ref_model.built)
    queries = _stage1_queries(ref_model)
    deleted = np.zeros(200, bool)
    deleted[::7] = True
    sdi = sharding.ShardedDeviceIndex(built, sharding.make_mesh(4),
                                      deleted=deleted)
    one = DeviceIndex(built, deleted=deleted)
    want = one.search_batch(queries, 30, total_docs=200)
    from infidex_tpu_torch.index import device as port_device
    monkeypatch.setattr(port_device, "_MAX_L_PER_CALL", 200)
    assert len(port_device.split_batch_by_lanes(built, queries)) > 1
    got = sdi.search_batch(queries, 30, total_docs=200)
    for (gs, gi, gl), (ws, wi, wl) in zip(got, want):
        assert np.array_equal(gi, wi) and np.array_equal(gl, wl)
        assert np.array_equal(gs.view(np.int32), ws.view(np.int32))
        assert not deleted[gi[gs > 0]].any()


def test_mesh_of_a_repeated_device_holds_replicas_once():
    mesh = sharding.make_mesh(devices=["cpu"] * 4)
    assert mesh == [torch.device("cpu")] * 4
    eng = port.SearchEngine.create_default()
    eng.index_documents([port.Document(i, t) for i, t in
                         enumerate(engine_tests.TITLES)])
    eng.enable_sharded_serving(mesh=mesh)
    sdi = eng.vector_model.sharded
    assert len(sdi._replicas) == 1
    base = sdi._replicas[torch.device("cpu")].doc_lengths
    assert all(t.untyped_storage().data_ptr()
               == base.untyped_storage().data_ptr() for t in sdi.doc_lengths)
    tables = eng.vector_model.sharded_tables
    assert all(s.word_chars is tables.shards[0].word_chars
               for s in tables.shards)
    eng.disable_sharded_serving()
    assert eng.vector_model.sharded is None


# --- Stage 2/3 -------------------------------------------------------------

def _coverage_inputs(pkg):
    """tests/test_sharding.py:68's tables and queries, for either package."""
    cov = importlib.import_module(pkg.__name__ + ".ops.coverage_kernel")
    setup = importlib.import_module(pkg.__name__ + ".coverage.setup")
    texts = [f"alpha bravo doc{i} charlie" for i in range(40)] + \
        ["delta echo"] * 8
    tables = cov.CoverageTables.build([t.lower() for t in texts], {" "})
    config = cov.CoverageConfig.from_setup(
        setup.CoverageSetup.create_default())

    class Tok:
        def __init__(self, t, p):
            self.lower, self.position = t, p

    def enc(words, qp=4):
        toks = [Tok(w, i) for i, w in enumerate(words)]
        qc, qr, ql, _, qn, _ = cov.encode_query_tokens(toks, qp)
        order = sorted(range(qn), key=lambda i: -ql[i])
        qs = np.full(qp, qn, np.int32)
        qs[: len(order)] = order
        return (qc, qr, ql, np.ones(qp, np.float32),
                np.ones(qp, np.float32), qn, qs)

    encs = [enc(["alpha", "brvo"]), enc(["delta"]), enc(["charlie", "doc7"])]
    stk = lambda i: np.stack([e[i] for e in encs])  # noqa: E731
    q_args = (stk(0), stk(1), stk(2), stk(3), stk(4),
              np.array([e[5] for e in encs], np.int32), stk(6),
              stk(0), stk(1), stk(2),
              np.array([e[5] for e in encs], np.int32),
              np.array([False, False, True]))
    rng = np.random.default_rng(4)
    text_ids = rng.permutation(48).astype(np.int32)
    qsel = (np.arange(48) % 3).astype(np.int32)
    lcs = np.zeros(48, np.float32)
    base = (rng.random(48) * 2).astype(np.float32)
    return (tables, text_ids, qsel, q_args, lcs, base,
            np.array([10, 5, 12], np.int32), config)


@pytest.mark.parametrize("n_shards", [8, 3])
def test_sharded_coverage_matches_reference(n_shards):
    tables, *args = _coverage_inputs(ref)
    want = np.asarray(ref_sharding.sharded_coverage_batch(
        ref_sharding.ShardedCoverageTables(
            tables, ref_sharding.make_mesh(n_shards)), *args))
    tables, *args = _coverage_inputs(port)
    st = sharding.ShardedCoverageTables(tables, sharding.make_mesh(n_shards))
    got = sharding.sharded_coverage_batch(st, *args)
    assert got.shape == (3, 48) and got.device == torch.device("cpu")
    got = got.numpy()
    assert _ulps(got[0], want[0]) <= 1
    assert np.array_equal(got[1:], want[1:])


# --- the reference suite's tests, on the port ------------------------------

def test_reference_names_are_bound_to_the_port():
    for mod in (engine_tests, sharding_tests):
        for name in ("Document",):
            assert getattr(mod, name) is port.Document
    assert engine_tests.SearchEngine is port.SearchEngine
    assert sharding_tests.make_mesh is sharding.make_mesh
    assert sharding_tests.ShardedDeviceIndex is sharding.ShardedDeviceIndex


engines = engine_tests.engines
test_search_parity_all_query_classes = \
    engine_tests.test_search_parity_all_query_classes
test_search_batch_parity = engine_tests.test_search_batch_parity
test_sharded_delete_documents = engine_tests.test_sharded_delete_documents
test_reindex_keeps_sharding = engine_tests.test_reindex_keeps_sharding

model = sharding_tests.model
test_sharded_matches_single = sharding_tests.test_sharded_matches_single
test_mesh_shapes = sharding_tests.test_mesh_shapes


def test_sharded_coverage_matches_single_device(monkeypatch):
    """The reference test imports its modules inside its body: they are
    the port's for its duration."""
    for name in ("coverage.setup", "ops.coverage_kernel",
                 "parallel.sharding"):
        monkeypatch.setitem(sys.modules, "infidex_tpu." + name,
                            importlib.import_module("infidex_tpu_torch."
                                                    + name))
    sharding_tests.test_sharded_coverage_matches_single_device()


# --- whole engines ---------------------------------------------------------

def _records(results):
    return [[(r.document_id, r.score, r.tiebreaker) for r in res.records]
            for res in results]


def test_bench_corpus_sharded_equals_one_shard():
    titles = bench.make_corpus(3000)
    queries = bench.make_queries(titles, 24) + ["shawshenk", "the dark"]
    eng = port.SearchEngine.create_default()
    eng.index_documents([port.Document(i, t) for i, t in enumerate(titles)])
    got = {}
    for n in (1, 8, 3):
        eng.enable_sharded_serving(n_devices=n)
        assert len(eng.vector_model.sharded.mesh) == n
        got[n] = (_records(eng.search_batch([port.Query(q, 10)
                                             for q in queries])),
                  _records([eng.search(port.Query(q, 10))
                            for q in queries[::4]]))
    assert got[8] == got[1] and got[3] == got[1]
    assert sum(bool(r) for r in got[1][0]) >= len(queries) - 2


def test_reference_sharded_engine_matches_port_sharded_engine():
    docs = list(enumerate(engine_tests.TITLES))
    want_eng = ref.SearchEngine.create_default()
    want_eng.index_documents([ref.Document(i, t) for i, t in docs])
    want_eng.enable_sharded_serving(n_devices=8)
    got_eng = port.SearchEngine.create_default()
    got_eng.index_documents([port.Document(i, t) for i, t in docs])
    got_eng.enable_sharded_serving(n_devices=8)
    qs = engine_tests.QUERIES
    want = [want_eng.search(ref.Query(q, 10)) for q in qs] + \
        want_eng.search_batch([ref.Query(q, 10) for q in qs])
    got = [got_eng.search(port.Query(q, 10)) for q in qs] + \
        got_eng.search_batch([port.Query(q, 10) for q in qs])
    for w, g in zip(want, got):
        assert [r.document_id for r in g.records] == \
            [r.document_id for r in w.records]
        assert _ulps([r.score for r in g.records],
                     [r.score for r in w.records]) <= 1
