"""The single-query device Stage 1 of the port
(infidex_tpu_torch/index/device.py ``DeviceIndex.search``, its extra
postings ``stage1_extras``, and parallel/sharding.py
``ShardedDeviceIndex.search``).

* ``DeviceIndex.search`` against the reference's (``_stage1_kernel``, JAX
  on the CPU) on a random CSR with deletions and zero-length terms, on
  tests/test_sharding.py's 200-doc model and on tests/test_search_batch.py's
  movie corpus (its typo queries' fuzzy groups materialised as extra
  postings, as that test does): ids exact, scores within ``MAX_ULP``
  (XLA's CPU backend contracts the BM25+ factor's multiply-adds into
  FMAs; the port rounds each operation). Cases: with and without extras,
  extras that repeat a doc within one group and across groups, deleted
  docs, an empty term list, a zero-length term, top_k above the match
  count and above n_pad.
* The port's single route against its own ``search_batch`` on the
  reference test's six queries: ids exact, scores within rtol 1e-6 and bit
  for bit wherever a doc takes at most one extra (the batch route sums a
  query's fuzzy groups apart before it adds them, so two extras on one doc
  may round differently).
* The extras kernel's cell code (csrc/stage1_extras_cell.cuh over
  csrc/block_steps.cuh), compiled for the host with g++ -ffp-contract=off
  behind the kernel's C interface (blocks last to first) and called
  through ``_kernels.stage1_extras(lib=...)``: bit-equal to
  ``stage1_extras_plain`` and to a serial numpy loop on seeded inputs
  with heavy duplication; the whole single route (and 4 shards) through
  the kernel route of the extras, epilogue and top-k dispatchers with
  that host build: bit-equal to the plain route.
* ``ShardedDeviceIndex.search`` on 8 and 3 CPU shards: bit-equal to the
  port's single route, and against the reference's sharded search ids
  exact, scores within ``MAX_ULP``.
* On a card (``gpu``), the kernel against the plain version and the
  single route's CUDA results against the CPU's.

Inputs are made with numpy from a seed.
"""

import functools
import os

import numpy as np
import pytest
import torch

os.environ["INFIDEX_TPU_PALLAS_INTERPRET"] = "1"

import infidex_tpu as ref  # noqa: E402
import infidex_tpu_torch as port  # noqa: E402
from infidex_tpu.index import device as ref_dev  # noqa: E402
from infidex_tpu.index.vector_model import VectorModel as RefVectorModel  # noqa: E402
from infidex_tpu.parallel import sharding as ref_sharding  # noqa: E402
from infidex_tpu.tokenization.normalizer import TextNormalizer  # noqa: E402
from infidex_tpu.tokenization.tokenizer import (  # noqa: E402
    Tokenizer, TokenizerSetup)
from infidex_tpu_torch import convert, runtime  # noqa: E402
from infidex_tpu_torch.index import builder as port_builder  # noqa: E402
from infidex_tpu_torch.index import device as port_dev  # noqa: E402
from infidex_tpu_torch.ops import _kernels  # noqa: E402
from infidex_tpu_torch.parallel import sharding  # noqa: E402
from tests.test_search_batch import TITLES  # noqa: E402
from tests.test_torch_coverage_lcs import compile_cell  # noqa: E402
from tests.test_torch_device import MAX_ULP, _random_index, _ulps  # noqa: E402
from tests.test_torch_stage1_epilogue import _HOST  # noqa: E402

runtime.set_device("cpu")
# the suite runs in several worker processes on shared cores; one intra-op
# thread each keeps torch from oversubscribing them
torch.set_num_threads(1)

_HOST_EXTRAS = r"""
#include "stage1_extras_cell.cuh"
// The extras kernel's C interface on the host: every block in turn, last
// to first (the card runs blocks in no order).
extern "C" int stage1_extras(float* scores, const int* docs, const int* off,
    const float* idf, const float* doc_fac, int n_docs, void*) {
  if (n_docs <= 0) return 0;
  const extras::Args a{scores, docs, off, idf, doc_fac, n_docs};
  const long long n_blocks = (n_docs + extras::kThreads - 1) / extras::kThreads;
  for (long long b = n_blocks - 1; b >= 0; --b) extras::block(a, b);
  return 0;
}
"""


@pytest.fixture(scope="module")
def host(tmp_path_factory):
    """The extras cell and the epilogue's four cells behind their
    kernels' C interfaces, bound by ``_kernels.bind``."""
    return _kernels.bind(compile_cell(tmp_path_factory, "stage1_single",
                                      _HOST + _HOST_EXTRAS))


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    return torch.device("cuda")


def _same(want, got, exact=False):
    """Ids exact; scores bit-equal (``exact``) or within MAX_ULP."""
    (ws, wi), (gs, gi) = want, got
    assert gs.dtype == np.float32 and gi.dtype == np.int32
    assert gs.shape == gi.shape == np.asarray(wi).shape
    assert np.array_equal(np.asarray(wi), gi)
    if exact:
        assert np.array_equal(np.asarray(ws).view(np.int32), gs.view(np.int32))
    else:
        assert _ulps(ws, gs).max(initial=0) <= MAX_ULP


# ---- inputs ------------------------------------------------------------


def random_case(seed, case):
    """(built for the reference, built for the port, deleted, args of
    ``search``) on tests/test_torch_device.py's random CSR (some terms have
    no postings) with 5 % of the docs deleted."""
    rng = np.random.default_rng(seed)
    ref_built = _random_index(np.random.default_rng(seed))
    built = _random_index(np.random.default_rng(seed),
                          cls=port_builder.BuiltIndex)
    n = built.num_docs
    deleted = rng.random(n) < 0.05
    live_terms = np.flatnonzero(built.df > 0)
    tids = rng.choice(live_terms, 4, replace=False).astype(np.int64)
    idfs = np.asarray([ref_dev.compute_idf(n, int(built.df[t]))
                       for t in tids], np.float32)
    # two groups of doc unions (distinct docs each) that overlap
    groups = [np.unique(rng.integers(0, n, 60)) for _ in range(2)]
    groups.append(np.union1d(groups[0][:20], rng.integers(0, n, 10)))
    ed = np.concatenate(groups).astype(np.int32)
    ei = np.concatenate([np.full(g.size, 0.5 + i, np.float32)
                         for i, g in enumerate(groups)])
    zero = int(np.flatnonzero(built.df == 0)[0])
    args = {
        "terms": (tids, idfs, 20),
        "extras": (tids, idfs, 20, groups[0].astype(np.int32),
                   np.full(groups[0].size, 1.25, np.float32)),
        "repeated_extras": (tids, idfs, 30, ed, ei),
        "random_extras": (tids, idfs, 30,
                          rng.integers(0, n, 400).astype(np.int32),
                          rng.random(400).astype(np.float32) * 3),
        "empty_terms": (tids[:0], idfs[:0], 20, ed, ei),
        "nothing": (tids[:0], idfs[:0], 10),
        "zero_length_term": (np.r_[tids[:2], zero, tids[2:]],
                             np.r_[idfs[:2], np.float32(2.0),
                                   idfs[2:]].astype(np.float32), 20, ed, ei),
        "k_above_matches": (tids[:1], idfs[:1], 300, ed[:5], ei[:5]),
        "k_above_n_pad": (tids, idfs, 5000),
    }[case]
    return ref_built, built, deleted, args


CASES = ["terms", "extras", "repeated_extras", "random_extras",
         "empty_terms", "nothing", "zero_length_term", "k_above_matches",
         "k_above_n_pad"]

WORDS = ["alpha", "bravo", "charlie", "delta", "echo", "foxtrot", "golf",
         "hotel", "india", "juliet", "kilo", "lima"]


@pytest.fixture(scope="module")
def ref_model():
    """tests/test_sharding.py's 200-doc model, built by the reference."""
    tok = Tokenizer([3], 2, 0, TextNormalizer.create_default(),
                    TokenizerSetup())
    m = RefVectorModel(tok)
    rng = np.random.default_rng(42)
    for i in range(200):
        text = " ".join(rng.choice(WORDS, size=rng.integers(2, 6)))
        m.index_document(ref.Document(i, text))
    m.build_inverted_lists()
    return m


def model_queries(m, seed=3):
    """(term_ids, idfs) queries of 1-6 of the model's terms."""
    rng = np.random.default_rng(seed)
    n_terms = len(m.built.terms)
    out = []
    for n in (1, 2, 4, 6):
        t = rng.choice(n_terms, n, replace=False).astype(np.int64)
        idfs = np.asarray([ref_dev.compute_idf(200, int(m.built.df[x]))
                           for x in t], np.float32)
        out.append((t, idfs))
    return out


@pytest.fixture(scope="module")
def movie_engines():
    """tests/test_search_batch.py's movie corpus, indexed by both
    packages."""
    out = {}
    for pkg in (ref, port):
        eng = pkg.SearchEngine.create_default()
        eng.index_documents([pkg.Document(i, t)
                             for i, t in enumerate(TITLES)])
        out[pkg] = eng
    return out


#: tests/test_search_batch.py::test_stage1_device_batch_matches_single's
#: queries (typo queries included)
MOVIE_QUERIES = ["shawshank", "star wars", "godfather", "terminator",
                 "shawshenk", "termnator wars"]


def materialize(model, groups, compute_idf):
    """The fuzzy groups as extra postings, as the reference test makes
    them: each group's posting-doc union (when 0 < size <= the stop
    limit) at its union's idf."""
    ed_l, ei_l = [], []
    for grp in groups:
        chunks = [model.built.postings_for(int(t))[0] for t in np.asarray(grp)]
        union = (np.unique(np.concatenate(chunks)) if chunks
                 else np.zeros(0, np.int32))
        if 0 < union.size <= model.stop_term_limit:
            fidf = compute_idf(model.documents.count, int(union.size))
            ed_l.append(union.astype(np.int32))
            ei_l.append(np.full(union.size, fidf, np.float32))
    if not ed_l:
        return None, None
    return np.concatenate(ed_l), np.concatenate(ei_l)


# ---- against the reference --------------------------------------------


@pytest.mark.parametrize("case", CASES)
def test_search_matches_reference(case):
    ref_built, built, deleted, args = random_case(0, case)
    want = ref_dev.DeviceIndex(ref_built, deleted).search(*args)
    index = port_dev.DeviceIndex(built, deleted)
    got = index.search(*args)
    _same(want, got)
    k = min(args[2], index.n_pad)
    assert got[1].size == k
    if case == "k_above_matches":
        assert (got[0] > 0).sum() < k and (got[0] == 0).any()
    if case in ("terms", "extras", "repeated_extras"):
        assert (got[0] > 0).sum() >= 10
    if case == "nothing":
        assert not got[0].any()
    # deleted docs never score
    assert not deleted[got[1][(got[0] > 0)]].any()


def test_search_on_the_200_doc_model_matches_reference(ref_model):
    built = convert.built_index_from_reference(ref_model.built)
    ref_index = ref_dev.DeviceIndex(ref_model.built)
    index = port_dev.DeviceIndex(built)
    rng = np.random.default_rng(9)
    for t, idfs in model_queries(ref_model):
        _same(ref_index.search(t, idfs, 20), index.search(t, idfs, 20))
        ed = rng.integers(0, 200, 50).astype(np.int32)
        ei = rng.random(50).astype(np.float32)
        _same(ref_index.search(t, idfs, 20, ed, ei),
              index.search(t, idfs, 20, ed, ei))


def test_search_on_the_movie_corpus_matches_reference(movie_engines):
    got = {}
    for pkg, eng in movie_engines.items():
        m = eng.vector_model
        out = []
        for q in MOVIE_QUERIES:
            t, i, groups = m.prepare_stage1(q)
            ed, ei = materialize(m, groups,
                                 ref_dev.compute_idf if pkg is ref
                                 else port_dev.compute_idf)
            out.append(m.device.search(t, i, 16, ed, ei))
        got[pkg] = out
    for want, have in zip(got[ref], got[port]):
        _same(want, have)
    assert all((s > 0).any() for s, _ in got[port])


def test_single_matches_the_port_search_batch(movie_engines):
    m = movie_engines[port].vector_model
    preps = [m.prepare_stage1(q) for q in MOVIE_QUERIES]
    batch = m.device.search_batch(preps, 16,
                                  total_docs=m.documents.count,
                                  stop_term_limit=m.stop_term_limit)
    n_extras = n_once = 0
    for (t, i, groups), (b_s, b_i, _lim) in zip(preps, batch):
        ed, ei = materialize(m, groups, port_dev.compute_idf)
        s_s, s_i = m.device.search(t, i, 16, ed, ei)
        np.testing.assert_array_equal(s_i, b_i)
        np.testing.assert_allclose(s_s, b_s, rtol=1e-6)
        # bit for bit where a doc took at most one extra
        times = np.bincount(ed if ed is not None else np.zeros(0, np.int64),
                            minlength=m.device.n_pad)[s_i]
        once = times <= 1
        assert np.array_equal(s_s[once].view(np.int32),
                              b_s[once].view(np.int32))
        n_once += int((once & (times == 1)).sum())
        n_extras += ed is not None
    assert n_extras >= 2 and n_once >= 1   # the typo queries' extras


# ---- the extras kernel's cell code ----------------------------------------


def extras_inputs(seed, width=5000, n=3000, n_docs=300):
    """A score row, doc factors and ``n`` extras over ``n_docs`` distinct
    docs (about ten a doc), idfs of mixed magnitudes."""
    rng = np.random.default_rng(seed)
    scores = (rng.random(width) * 8).astype(np.float32)
    scores[rng.random(width) < 0.5] = 0.0
    doc_fac = (rng.random(width) + 1.0).astype(np.float32)
    pool = rng.choice(width, n_docs, replace=False)
    docs = rng.choice(pool, n).astype(np.int32)
    idf = (rng.random(n) * 10.0 ** rng.integers(-3, 3, n)).astype(np.float32)
    return torch.from_numpy(scores), torch.from_numpy(doc_fac), docs, idf


def serial_oracle(scores, doc_fac, docs, idf):
    out = scores.numpy().copy()
    fac = doc_fac.numpy()
    for d, w in zip(docs, idf):
        out[d] = np.float32(out[d] + np.float32(w * fac[d]))
    return out


@pytest.mark.parametrize("seed,width,n,n_docs", [
    (0, 5000, 3000, 300), (1, 5000, 3000, 2900), (2, 700, 50, 1),
    (3, 100_000, 20_000, 9000), (4, 300, 1, 1)])
def test_extras_cell_equals_plain(host, seed, width, n, n_docs):
    scores, doc_fac, docs, idf = extras_inputs(seed, width, n, n_docs)
    plain = scores.clone()
    port_dev.stage1_extras_plain(plain, docs.astype(np.int64), idf, doc_fac)
    t = port_dev.extras_table(docs.astype(np.int64), idf, "cpu")
    assert t.docs.numel() == np.unique(docs).size
    got = scores.clone()
    _kernels.stage1_extras(got, t.docs, t.off, t.idf, doc_fac, lib=host)
    assert torch.equal(got.view(torch.int32), plain.view(torch.int32))
    assert np.array_equal(plain.numpy().view(np.int32),
                          serial_oracle(scores, doc_fac, docs, idf)
                          .view(np.int32))
    if n > 1:
        assert not torch.equal(got, scores)


def test_extras_table_is_doc_major_in_array_order():
    docs = np.asarray([5, 2, 5, 9, 2, 5], np.int64)
    idf = np.asarray([1, 2, 3, 4, 5, 6], np.float32)
    t = port_dev.extras_table(docs, idf, "cpu")
    assert t.docs.tolist() == [2, 5, 9]
    assert t.off.tolist() == [0, 2, 5, 6]
    assert t.idf.tolist() == [2, 5, 1, 3, 6, 4]


def test_extras_reject_bad_input():
    scores = torch.zeros(100)
    fac = torch.ones(100)
    with pytest.raises(ValueError):
        port_dev.stage1_extras(scores, np.asarray([3, 100]),
                               np.ones(2, np.float32), fac)
    with pytest.raises(ValueError):
        port_dev.stage1_extras(scores, np.asarray([-1]),
                               np.ones(1, np.float32), fac)
    with pytest.raises(ValueError):
        port_dev.stage1_extras(scores, np.asarray([1, 2]),
                               np.ones(3, np.float32), fac)
    port_dev.stage1_extras(scores, np.zeros(0, np.int32),
                           np.zeros(0, np.float32), fac)
    assert not scores.any()


def test_cpu_tensors_never_reach_the_kernel_wrapper():
    t = port_dev.extras_table(np.asarray([1, 2]), np.ones(2, np.float32),
                              "cpu")
    with pytest.raises(ValueError, match="CUDA tensors required"):
        _kernels.stage1_extras(torch.zeros(8), t.docs, t.off, t.idf,
                               torch.ones(8))


# ---- the single route through the kernel route ----------------------------


@pytest.fixture
def kernel_route(host, monkeypatch):
    """The dispatchers take the kernel route on CPU tensors, with the host
    build in place of the card's library."""
    monkeypatch.setattr(port_dev, "_use_plain", lambda t: False)
    for name in ("stage1_extras", "stage1_epilogue", "stage1_topk"):
        monkeypatch.setattr(_kernels, name, functools.partial(
            getattr(_kernels, name), lib=host))


def _singles(sharded):
    out = []
    for case in CASES:
        _, built, deleted, args = random_case(1, case)
        if sharded:
            idx = sharding.ShardedDeviceIndex(
                built, sharding.make_mesh(n_devices=4), deleted)
            args = args[:3]
        else:
            idx = port_dev.DeviceIndex(built, deleted)
        out.append(idx.search(*args))
    return out


@pytest.mark.parametrize("sharded", [False, True])
def test_search_kernel_route_equals_plain(request, sharded):
    plain = _singles(sharded)
    request.getfixturevalue("kernel_route")
    for want, got in zip(plain, _singles(sharded)):
        _same(want, got, exact=True)


# ---- sharded -----------------------------------------------------------


@pytest.mark.parametrize("n_shards", [8, 3])
def test_sharded_search_matches_single_and_reference(ref_model, n_shards):
    built = convert.built_index_from_reference(ref_model.built)
    deleted = np.zeros(200, bool)
    deleted[::9] = True
    ref_sharded = ref_sharding.ShardedDeviceIndex(
        ref_model.built, ref_sharding.make_mesh(n_shards), deleted)
    mesh = sharding.make_mesh(n_shards)
    assert mesh == [torch.device("cpu")] * n_shards
    sdi = sharding.ShardedDeviceIndex(built, mesh, deleted)
    single = port_dev.DeviceIndex(built, deleted)
    for t, idfs in model_queries(ref_model, seed=n_shards):
        got = sdi.search(t, idfs, 20)
        _same(single.search(t, idfs, 20), got, exact=True)
        _same(ref_sharded.search(t, idfs, 20), got)
        assert not deleted[got[1][got[0] > 0]].any()
    # top_k above a shard's size; above n_pad, where the two doc axes
    # (padded apart) end at other pad ids
    t, idfs = model_queries(ref_model)[-1]
    _same(single.search(t, idfs, sdi.shard_size + 5),
          sdi.search(t, idfs, sdi.shard_size + 5), exact=True)
    got = sdi.search(t, idfs, 1000)
    want = single.search(t, idfs, 1000)
    assert got[1].size == sdi.n_pad and want[1].size == single.n_pad
    n = min(sdi.n_pad, single.n_pad)
    _same((want[0][:n], want[1][:n]), (got[0][:n], got[1][:n]), exact=True)


# ---- on a card ---------------------------------------------------------


@pytest.mark.gpu
@pytest.mark.parametrize("seed,width,n,n_docs", [
    (0, 5000, 3000, 300), (3, 100_000, 20_000, 9000), (5, 1 << 20,
                                                       200_000, 60_000)])
def test_extras_kernel_equals_plain(cuda, seed, width, n, n_docs):
    scores, doc_fac, docs, idf = extras_inputs(seed, width, n, n_docs)
    plain = scores.clone()
    port_dev.stage1_extras_plain(plain, docs.astype(np.int64), idf, doc_fac)
    got = scores.to(cuda)
    port_dev.stage1_extras(got, docs, idf, doc_fac.to(cuda))
    torch.cuda.synchronize()
    assert torch.equal(got.cpu().view(torch.int32), plain.view(torch.int32))


@pytest.mark.gpu
@pytest.mark.parametrize("sharded", [False, True])
def test_search_cuda_equals_cpu(cuda, sharded):
    for case in CASES:
        _, built, deleted, args = random_case(2, case)
        out = []
        for dev in ("cpu", "cuda"):
            if sharded:
                idx = sharding.ShardedDeviceIndex(
                    built, sharding.make_mesh(devices=[dev] * 4), deleted)
                out.append(idx.search(*args[:3]))
            else:
                out.append(port_dev.DeviceIndex(built, deleted,
                                                device=dev).search(*args))
        _same(out[0], out[1], exact=True)
