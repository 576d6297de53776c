"""Port Stage-1 (infidex_tpu_torch/index/device.py) vs the reference's
chunked Stage-1 (Pallas lane kernel in interpret mode).

Held exactly: top-k ids (order included) and LIM rows. Scores: bit-equal
when both packages scatter the same per-posting factors (the reference's
``cfac`` handed to the port) — that pins the port's rank-ordered scatter
to the reference's serial lane order. With each package computing its own
factors, scores may differ by a few ulp: XLA's CPU backend contracts the
multiply-adds of the BM25+ factor and of the fuzzy doc factor into FMAs,
while the port rounds every operation (as the reference's numpy and C++
host scorers do); the fuzzy idf's log1p is rounded from f64 in the port.
"""

import os

import numpy as np
import pytest

os.environ["INFIDEX_TPU_PALLAS_INTERPRET"] = "1"

import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from infidex_tpu.index.builder import BuiltIndex  # noqa: E402
from infidex_tpu.index import device as ref_dev  # noqa: E402
from infidex_tpu_torch import convert, runtime  # noqa: E402
from infidex_tpu_torch.index import builder as port_builder  # noqa: E402
from infidex_tpu_torch.index import device as port_dev  # noqa: E402

runtime.set_device("cpu")
# the suite runs in several worker processes on shared cores; one intra-op
# thread each keeps torch from oversubscribing them
torch.set_num_threads(1)

#: score tolerance in f32 ulps without shared factors (see module
#: docstring): each factor may sit up to 2 ulp from XLA's, and a query
#: sums at most a few of them (measured: at most 2 ulp on seeds 0-7)
MAX_ULP = 4


def _ulps(a, b):
    a = np.asarray(a, np.float32).view(np.int32).astype(np.int64)
    b = np.asarray(b, np.float32).view(np.int32).astype(np.int64)
    return np.abs(a - b)


def _random_index(rng, n_docs=700, n_terms=40, cls=BuiltIndex):
    """tests/test_stage1_chunked.py's random CSR (terms list distinct
    sorted docs)."""
    lens = rng.integers(0, 90, n_terms)
    lens[rng.integers(0, n_terms, 4)] = 0
    offsets = np.zeros(n_terms + 1, np.int64)
    np.cumsum(lens, out=offsets[1:])
    docs = np.concatenate([np.sort(rng.permutation(n_docs)[:n])
                           for n in lens]).astype(np.int32)
    weights = rng.integers(1, 255, docs.size).astype(np.uint8)
    doc_lengths = (rng.random(n_docs) * 30 + 1).astype(np.float32)
    return _built(cls, offsets, docs, weights, doc_lengths, lens)


def _built(cls, offsets, docs, weights, doc_lengths, dfs):
    n_terms = offsets.size - 1
    return cls(terms=[f"t{i}" for i in range(n_terms)],
               term_to_id={f"t{i}": i for i in range(n_terms)},
               term_offsets=offsets, postings_docs=docs,
               postings_weights=weights, df=np.asarray(dfs, np.int32),
               doc_lengths=doc_lengths, avgdl=float(doc_lengths.mean()),
               num_docs=doc_lengths.size)


def _queries(rng, built, n=6, fuzzy=True):
    qs = []
    for _ in range(n):
        tids = rng.choice(len(built.terms), size=rng.integers(1, 6),
                          replace=False)
        tids = [int(t) for t in tids if built.df[t] > 0] or \
            [int(np.argmax(built.df))]
        idfs = np.asarray([ref_dev.compute_idf(built.num_docs,
                                               int(built.df[t]))
                           for t in tids], np.float32)
        groups = []
        for _ in range(rng.integers(0, 3) if fuzzy else 0):
            grp = rng.choice(len(built.terms), size=3, replace=False)
            groups.append(np.asarray(sorted(int(g) for g in grp), np.int64))
        qs.append((np.asarray(tids, np.int64), idfs, groups))
    return qs


def _ref_index(built, deleted=None):
    d = ref_dev.DeviceIndex(built, deleted)
    d.use_chunked = True
    return d


def _assert_same(ref, got, exact_scores):
    assert len(ref) == len(got)
    for (rs, ri, rl), (gs, gi, gl) in zip(ref, got):
        assert gi.dtype == np.int32 and gl.dtype == np.int32
        assert np.array_equal(np.asarray(ri), gi)
        assert np.array_equal(np.asarray(rl), gl)
        if exact_scores:
            assert np.array_equal(np.asarray(rs), gs)
        else:
            assert _ulps(rs, gs).max(initial=0) <= MAX_ULP


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_search_batch_matches_reference(seed):
    rng = np.random.default_rng(seed)
    built = _random_index(rng)
    deleted = rng.random(built.num_docs) < 0.05
    qs = _queries(rng, built)
    ref = _ref_index(built, deleted).search_batch(qs, 50)
    got = port_dev.DeviceIndex(built, deleted).search_batch(qs, 50)
    _assert_same(ref, got, exact_scores=False)


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_scatter_bit_equal_with_shared_factors(seed):
    rng = np.random.default_rng(seed)
    built = _random_index(rng, n_docs=900, n_terms=60)
    qs = _queries(rng, built, n=9, fuzzy=False)
    jd = _ref_index(built)
    ref = jd.search_batch(qs, 64)
    pd_ = convert.device_index_from_reference(jd)
    pd_.cfac = torch.from_numpy(np.array(jd._ensure_cfac()))
    _assert_same(ref, pd_.search_batch(qs, 64), exact_scores=True)


def test_converted_state_equals_native_state():
    rng = np.random.default_rng(5)
    built = _random_index(rng)
    jd = _ref_index(built)
    a = port_dev.DeviceIndex(built)
    b = convert.device_index_from_reference(jd)
    n = built.ext_docs.size
    assert a.n_pad == b.n_pad and a.num_docs == b.num_docs
    assert torch.equal(a.postings_docs[:n], b.postings_docs[:n])
    assert torch.equal(a.cfac[:n], b.cfac[:n])
    assert torch.equal(a.doc_lengths, b.doc_lengths)
    assert torch.equal(a.live_mask, b.live_mask)
    assert torch.equal(a.avgdl, b.avgdl)


def _tie_index():
    """Heavy ties: every doc has the same length and weights, so docs
    matching the same terms score bit-identically (cf. test_lim_class)."""
    n_docs = 3000
    members = [np.arange(n_docs), np.arange(0, n_docs, 3),
               np.arange(1, n_docs, 7), np.arange(n_docs - 600, n_docs),
               np.arange(5, 2500, 11)]
    lens = np.array([m.size for m in members])
    offsets = np.concatenate([[0], np.cumsum(lens)]).astype(np.int64)
    docs = np.concatenate(members).astype(np.int32)
    weights = np.full(docs.size, 7, np.uint8)
    return BuiltIndex, offsets, docs, weights, np.full(n_docs, 4.0,
                                                     np.float32), lens


@pytest.mark.parametrize("k", [20, 500])
def test_heavy_ties_same_ids_and_lim(k):
    cls, offsets, docs, weights, dl, lens = _tie_index()
    built = _built(cls, offsets, docs, weights, dl, lens)
    pbuilt = _built(port_builder.BuiltIndex, offsets, docs, weights, dl, lens)
    idf = lambda t: ref_dev.compute_idf(built.num_docs, int(lens[t]))
    qs = [(np.array(t, np.int64), np.array([idf(i) for i in t], np.float32),
           g) for t, g in (([0], []), ([0, 1], []), ([1, 2, 4], []),
                           ([3, 0], [np.array([1, 4])]), ([4], []))]
    ref = _ref_index(built).search_batch(qs, k)
    got = port_dev.DeviceIndex(pbuilt).search_batch(qs, k)
    _assert_same(ref, got, exact_scores=False)
    for s, ids, _ in got:          # (score desc, id asc) order
        order = np.lexsort((ids, -s))
        assert np.array_equal(order, np.arange(ids.size))


def test_stable_top_k_exact_order():
    rng = np.random.default_rng(2)
    scores = np.round(rng.random((4, 5000)) * 8).astype(np.float32) / 4
    scores[1, :100] = -0.0
    for k in (1, 37, 500):
        s, ids = port_dev.stable_top_k(torch.from_numpy(scores), k)
        rs, rids = ref_dev.stable_top_k(jnp.asarray(scores), k)
        for b in range(scores.shape[0]):
            want = np.lexsort((np.arange(scores.shape[1]), -scores[b]))[:k]
            assert np.array_equal(ids[b].numpy(), want)
            assert np.array_equal(ids[b].numpy(), np.asarray(rids[b]))
            assert np.array_equal(s[b].numpy(), scores[b][want])


def test_lim_rows_lowest_true_positions():
    rng = np.random.default_rng(7)
    for _ in range(4):
        m = rng.random((3, 4000)) > 0.99
        out = port_dev._lim_rows(torch.from_numpy(m), 300).numpy()
        ref = np.asarray(ref_dev._lim_rows(jnp.asarray(m), 300))
        assert np.array_equal(out, ref.astype(np.int32))
        for b in range(m.shape[0]):
            pos = np.flatnonzero(m[b])[: min(port_dev.LIM_K, 300)]
            assert np.array_equal(out[b][:pos.size], pos)


def test_masked_live_prefilters():
    rng = np.random.default_rng(9)
    built = _random_index(rng)
    qs = _queries(rng, built, fuzzy=False)
    mask = rng.random(built.num_docs) < 0.5
    jd = _ref_index(built)
    pd_ = port_dev.DeviceIndex(built)
    ref = jd.search_batch(qs, 40, live_override=jd.masked_live(mask))
    got = pd_.search_batch(qs, 40, live_override=pd_.masked_live(mask))
    assert pd_.masked_live(mask) is pd_.masked_live(mask)
    _assert_same(ref, got, exact_scores=False)
    for s, ids, _ in got:
        assert mask[ids[s > 0]].all()


def test_dispatch_then_collect_equals_search_batch():
    rng = np.random.default_rng(4)
    built = _random_index(rng)
    qs = _queries(rng, built, n=8)
    pd_ = port_dev.DeviceIndex(built)
    a = pd_.search_batch(qs, 30)
    handles = pd_.search_batch_dispatch(qs, 30)
    b = pd_.search_batch_collect(handles)
    _assert_same(a, b, exact_scores=True)


@pytest.mark.gpu
@pytest.mark.parametrize("k", [20, 500])
def test_heavy_ties_cuda_equals_cpu(k):
    """The whole Stage 1 on the card (lane kernel, fuzzy block, epilogue)
    against the CPU on the heavy-tie index: ids, LIM rows and score bits
    identical."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    _, offsets, docs, weights, dl, lens = _tie_index()
    pbuilt = _built(port_builder.BuiltIndex, offsets, docs, weights, dl, lens)
    idf = lambda t: ref_dev.compute_idf(pbuilt.num_docs, int(lens[t]))
    qs = [(np.array(t, np.int64), np.array([idf(i) for i in t], np.float32),
           g) for t, g in (([0], []), ([0, 1], []), ([1, 2, 4], []),
                           ([3, 0], [np.array([1, 4])]), ([4], []),
                           ([4, 3, 2, 1, 0], [np.array([0, 2])]))]
    cpu = port_dev.DeviceIndex(pbuilt, device="cpu").search_batch(qs, k)
    cuda = port_dev.DeviceIndex(pbuilt, device="cuda").search_batch(qs, k)
    _assert_same(cpu, cuda, exact_scores=True)


@pytest.mark.gpu
def test_tie_heavy_corpus_stage1_cuda_equals_cpu():
    """tests/test_lim_class.py's tie-heavy corpus (3000 two-word titles
    over ten syllables) through the engine's whole Stage 1, at the depths
    of its nesting test: the card gives the CPU's ids, LIM rows and score
    bits."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    import random

    import infidex_tpu_torch as port

    rng = random.Random(5)
    syll = ["ba", "ce", "do", "fa", "gi", "ha", "ji", "ka", "lo", "me"]
    titles = [f"Yorin{rng.choice(syll)} {rng.choice(syll).title()}zen"
              for _ in range(3000)]
    out = {}
    try:
        for dev in ("cpu", "cuda"):
            runtime.set_device(dev)
            eng = port.SearchEngine.create_default()
            eng.index_documents([port.Document(i, t)
                                 for i, t in enumerate(titles)])
            m = eng.vector_model
            preps = [m.prepare_stage1(q) for q in
                     ("yorin", "yorinba cezen", "yorinka", "dozen yorin")]
            out[dev] = [m.device.search_batch(preps, depth,
                                              total_docs=m.documents.count)
                        for depth in (500, 2000)]
    finally:
        runtime.set_device("cpu")
    for a, b in zip(out["cpu"], out["cuda"]):
        _assert_same(a, b, exact_scores=True)
