"""Device pool scoring in the port (infidex_tpu_torch/ops/pool_score.py,
``DeviceIndex.pool_score_dispatch``) against the reference.

* ``pool_score_plain`` + ``stable_top_k`` against the reference's jitted
  ``_pool_score_kernel`` (JAX on the CPU) on random pools over a random
  CSR, including empty, one-doc and pad-heavy pools and terms that no pool
  doc carries: scores and ids exact;
* ``pool_score_plain`` against the host scorer ``candidates.score_pool``
  (its native C++ twin and its numpy path): exact;
* the tests of tests/test_pool_device.py, imported (not copied) and run
  with their module's reference names bound to the port's;
* the same three-way comparison on the pools that stress the kernel's
  tiles: valid slots sparse inside a tile (and tiles with none), a pool
  spanning a term's whole range, a narrowed range longer than the
  kernel's shared-memory buffer; and a range of more than 2^21 postings,
  past the depth of the reference's search, against the host scorer;
* on a card, the CUDA kernel against the plain version and the native
  ``score_pool`` on all of those pools: bit-equal.
"""

import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from infidex_tpu.index import device as ref_device
from infidex_tpu_torch import native, runtime
from infidex_tpu_torch.index import candidates as port_candidates
from infidex_tpu_torch.index.device import stable_top_k
from infidex_tpu_torch.ops import _kernels
from infidex_tpu_torch.ops import pool_score as port_pool
from tests import test_pool_device as pool_tests
from tests.test_torch_entry_points import _bind_to_port

runtime.set_device("cpu")
# the suite runs in several worker processes on shared cores; one intra-op
# thread each keeps torch from oversubscribing them
torch.set_num_threads(1)


@pytest.fixture(scope="module", autouse=True)
def _reference_tests_on_the_port():
    mp = pytest.MonkeyPatch()
    try:
        _bind_to_port(mp, pool_tests)
        yield
    finally:
        mp.undo()


def _csr(seed, n_docs=3000, n_terms=24):
    """A doc-sorted CSR (distinct docs per term, uint8 weights), doc
    lengths (some 0) padded to n_pad, and an avgdl."""
    rng = np.random.default_rng(seed)
    lens = rng.integers(0, 900, n_terms)
    lens[3] = 0
    lens[4] = n_docs                      # a term on every doc
    docs = np.concatenate([np.sort(rng.permutation(n_docs)[:n])
                           for n in lens]).astype(np.int32)
    starts = np.concatenate([[0], np.cumsum(lens)[:-1]]).astype(np.int32)
    weights = rng.integers(1, 256, docs.size).astype(np.uint8)
    n_pad = 4096
    dl = np.zeros(n_pad, np.float32)
    dl[:n_docs] = (rng.random(n_docs) * 30).astype(np.float32)
    dl[:40] = 0.0                         # zero-length docs take dl = 1
    return docs, weights, starts, lens.astype(np.int32), dl, np.float32(8.7)


def _jobs(seed, docs, starts, lens, n_pad, n_docs=3000):
    """[B, Pp] pools and [B, T] term tables in the reference's layout."""
    rng = np.random.default_rng(seed)
    b_pad, p_pad, t_pad = 8, 512, 8
    pool = np.full((b_pad, p_pad), n_pad - 1, np.int32)
    valid = np.zeros((b_pad, p_pad), bool)
    t_starts = np.zeros((b_pad, t_pad), np.int32)
    t_lens = np.zeros((b_pad, t_pad), np.int32)
    t_idf = np.zeros((b_pad, t_pad), np.float32)
    carried = np.zeros(n_docs, bool)
    for t in range(len(lens)):
        if t != 4:
            carried[docs[starts[t]:starts[t] + lens[t]]] = True
    absent = np.flatnonzero(~carried)
    sizes = [0, 1, 5, 512, 300, 64, 512, 2]
    for b, size in enumerate(sizes):
        src = absent if b == 5 else np.arange(n_docs)
        p = np.sort(rng.choice(src, size=min(size, src.size), replace=False))
        pool[b, :p.size] = p
        valid[b, :p.size] = True
        n_t = int(rng.integers(1, t_pad + 1))
        terms = rng.choice([t for t in range(len(lens)) if t != 4], n_t,
                           replace=False)
        if b == 6:
            terms[0] = 3                    # a term with no postings
        t_starts[b, :n_t] = starts[terms]
        t_lens[b, :n_t] = lens[terms]
        t_idf[b, :n_t] = (rng.random(n_t) * 6 + 0.1).astype(np.float32)
    return pool, valid, t_starts, t_lens, t_idf


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_plain_pool_scores_equal_the_reference_kernel(seed):
    docs, weights, starts, lens, dl, avgdl = _csr(seed)
    jobs = _jobs(seed + 10, docs, starts, lens, dl.size)
    k = 37
    want_s, want_i = ref_device._pool_score_kernel(
        jnp.asarray(docs), jnp.asarray(weights), jnp.asarray(dl),
        *(jnp.asarray(a) for a in jobs), jnp.float32(avgdl), t_pad=8, k=k)
    t = [torch.from_numpy(a) for a in jobs]
    scores = port_pool.pool_score_plain(
        *t, torch.from_numpy(docs), torch.from_numpy(weights),
        torch.from_numpy(dl), torch.tensor(avgdl))
    got_s, pos = stable_top_k(scores, k)
    got_i = torch.gather(t[0], 1, pos.long())
    assert np.array_equal(got_s.numpy().view(np.int32),
                          np.asarray(want_s).view(np.int32))
    assert np.array_equal(got_i.numpy(), np.asarray(want_i))
    # the dispatcher takes the plain version for CPU tensors
    same = port_pool.pool_score(
        *t, torch.from_numpy(docs), torch.from_numpy(weights),
        torch.from_numpy(dl), torch.tensor(avgdl))
    assert torch.equal(same.view(torch.int32), scores.view(torch.int32))
    pool, valid = jobs[0], jobs[1]
    assert (scores.numpy()[~valid] == 0).all()
    assert (scores.numpy()[5] == 0).all()      # no pool doc carries a term
    assert (scores.numpy()[3] > 0).any()


@pytest.mark.parametrize("use_native", [True, False])
def test_plain_pool_scores_equal_the_host_scorer(use_native, monkeypatch):
    """``score_pool`` over the port's built index (the native C++ twin, or
    its numpy path) and ``DeviceIndex.pool_score_dispatch`` give the same
    f32 bits."""
    if use_native:
        assert native.available
    else:
        monkeypatch.setattr(native, "available", False)
    eng = pool_tests._build_engine(n_docs=700, seed=5)
    model = eng.vector_model
    built = model.built
    dev = pool_tests._device_index(model)
    rng = np.random.default_rng(9)
    jobs = []
    for q in ("alpha bravo", "charlie delta echo", "kilo lima mike",
              "golf", "november india hotel juliet"):
        prep = model.prepare_stage1(q)
        term_ids = [int(x) for x in np.asarray(prep[0])]
        idfs = [float(x) for x in np.asarray(prep[1])]
        pool = np.unique(rng.integers(0, built.num_docs,
                                      int(rng.integers(1, 600))))
        jobs.append((pool.astype(np.int64), term_ids, idfs))
    handle = dev.pool_score_dispatch(jobs, 700)
    outs = dev.pool_score_collect(handle)
    for (pool, term_ids, idfs), (d_scores, d_ids) in zip(jobs, outs):
        h = port_candidates.score_pool(built, term_ids, idfs, pool)
        order = np.argsort(-h, kind="stable")
        assert np.array_equal(d_scores[:order.size].view(np.int32),
                              h[order].view(np.int32))
        assert np.array_equal(d_ids[:order.size], pool[order])


def test_pool_weights_upload_lazily():
    """Resident bytes do not grow until the first pool dispatch."""
    eng = pool_tests._build_engine(n_docs=200, seed=2)
    dev = pool_tests._device_index(eng.vector_model)
    assert dev._pool_weights is None
    prep = eng.vector_model.prepare_stage1("alpha bravo")
    dev.pool_score_collect(dev.pool_score_dispatch(
        [(np.arange(10), [int(x) for x in prep[0]],
          [float(x) for x in prep[1]])], 5))
    assert dev._pool_weights is not None
    assert dev._pool_weights.dtype == torch.uint8
    assert dev._pool_weights.numel() == dev.postings_docs.numel()


def test_cpu_tensors_never_reach_the_kernel_wrapper():
    z = torch.zeros((1, 1), dtype=torch.int32)
    with pytest.raises(ValueError):
        _kernels.pool_score(z, z.bool(), z, z, z.float(),
                            torch.zeros(1, dtype=torch.int32),
                            torch.zeros(1, dtype=torch.uint8),
                            torch.zeros(1), torch.ones(1))


# --- the reference suite's tests, on the port ----------------------------

def test_reference_names_are_bound_to_the_port():
    assert pool_tests.SearchEngine.__module__.startswith("infidex_tpu_torch")
    assert pool_tests.cand_mod is port_candidates
    assert pool_tests.score_pool is port_candidates.score_pool
    assert pool_tests.VectorModel.__module__.startswith("infidex_tpu_torch")


engine = pool_tests.engine
test_pool_kernel_matches_host_scorer = \
    pool_tests.test_pool_kernel_matches_host_scorer
test_pool_kernel_empty_and_tiny_pools = \
    pool_tests.test_pool_kernel_empty_and_tiny_pools
test_batch_results_identical_host_vs_device_pool = \
    pool_tests.test_batch_results_identical_host_vs_device_pool
test_select_pool_run_consistency = pool_tests.test_select_pool_run_consistency


# --- pools that stress the kernel's tiles ---------------------------------

EDGE_CASES = ["sparse_tiles", "whole_range", "long_range"]


def _edge_case(case):
    """A CSR, [B, Pp] job arrays and, per job, (slots, pool docs, term ids,
    idfs). Pools are ascending over their valid slots; other slots hold
    the pad id and are not valid."""
    rng = np.random.default_rng(EDGE_CASES.index(case) + 40)
    n_docs = 20_000 if case == "long_range" else 6000
    n_pad = 1 << 15
    if case == "long_range":
        # a term on every doc, one on every second doc, a short one: 256
        # consecutive slots of a pool spread over all docs span far more
        # postings of the first two than the kernel's buffer holds
        ranges = [np.arange(n_docs), np.arange(0, n_docs, 2),
                  np.sort(rng.permutation(n_docs)[:700])]
    else:
        ranges = [np.sort(rng.permutation(n_docs)[:n])
                  for n in (900, 2500, 40, 1, 1600)]
    lens = np.array([r.size for r in ranges], np.int32)
    starts = np.concatenate([[0], np.cumsum(lens)[:-1]]).astype(np.int32)
    docs = np.concatenate(ranges).astype(np.int32)
    weights = rng.integers(1, 256, docs.size).astype(np.uint8)
    dl = np.zeros(n_pad, np.float32)
    dl[:n_docs] = (rng.random(n_docs) * 30).astype(np.float32)
    p_pad, t_pad = 1024, 8
    if case == "sparse_tiles":
        keep = rng.random((4, p_pad)) < 0.1
        keep[0, 256:512] = False            # a tile with no valid slot
        keep[1, 512:768] = False
        keep[1, 700] = True                 # a tile with one
        keep[2] = False
        keep[2, [0, 1023]] = True           # first and last slot only
        slots = [np.flatnonzero(k) for k in keep]
        pools = [np.sort(rng.choice(n_docs, s.size, replace=False))
                 for s in slots]
    elif case == "whole_range":
        # the pool IS a term's posting list, first to last doc; and a pool
        # that brackets every range
        pools = [ranges[0], np.unique(np.concatenate([ranges[2], [0],
                                                      [n_docs - 1]])),
                 ranges[4][:1024]]
        slots = [np.arange(p.size) for p in pools]
    else:
        pools = [np.sort(rng.choice(n_docs, 300, replace=False)),
                 np.arange(5000, 6024),                     # dense: buffered
                 np.sort(rng.choice(n_docs, 1024, replace=False)),
                 # every 25th doc: a tile's ranges of the two dense terms
                 # are of the buffer's order, one each side of it
                 np.arange(0, n_docs, 25)]
        slots = [np.arange(p.size) for p in pools]
    b_pad = 4
    pool = np.full((b_pad, p_pad), n_pad - 1, np.int32)
    valid = np.zeros((b_pad, p_pad), bool)
    t_starts = np.zeros((b_pad, t_pad), np.int32)
    t_lens = np.zeros((b_pad, t_pad), np.int32)
    t_idf = np.zeros((b_pad, t_pad), np.float32)
    jobs = []
    for b, (sl, p) in enumerate(zip(slots, pools)):
        pool[b, sl] = p
        valid[b, sl] = True
        terms = rng.permutation(len(ranges))
        idfs = (rng.random(terms.size) * 6 + 0.1).astype(np.float32)
        t_starts[b, :terms.size] = starts[terms]
        t_lens[b, :terms.size] = lens[terms]
        t_idf[b, :terms.size] = idfs
        jobs.append((sl, p, terms, idfs))
    offsets = np.concatenate([starts, [docs.size]]).astype(np.int64)
    built = types.SimpleNamespace(
        term_offsets=offsets, postings_docs=docs, postings_weights=weights,
        doc_lengths=dl, avgdl=8.7)
    return (docs, weights, dl, np.float32(8.7),
            (pool, valid, t_starts, t_lens, t_idf), jobs, built)


def _plain_scores(docs, weights, dl, avgdl, arrays):
    return port_pool.pool_score_plain(
        *(torch.from_numpy(a) for a in arrays), torch.from_numpy(docs),
        torch.from_numpy(weights), torch.from_numpy(dl), torch.tensor(avgdl))


def _assert_equals_host_scorer(scores, jobs, built):
    """``scores`` [B, Pp] against ``candidates.score_pool`` per job, bit
    for bit at the pool's slots; zero elsewhere."""
    rest = np.ones(scores.shape, bool)
    for b, (sl, p, terms, idfs) in enumerate(jobs):
        want = port_candidates.score_pool(
            built, [int(t) for t in terms], [float(x) for x in idfs],
            p.astype(np.int64))
        assert np.array_equal(scores[b, sl].view(np.int32),
                              want.view(np.int32)), b
        assert (want > 0).any(), b
        rest[b, sl] = False
    assert (scores[rest] == 0).all()


@pytest.mark.parametrize("case", EDGE_CASES)
def test_plain_scores_equal_the_reference_kernel_on_edge_pools(case):
    docs, weights, dl, avgdl, arrays, jobs, _ = _edge_case(case)
    k = arrays[0].shape[1]
    want_s, want_i = ref_device._pool_score_kernel(
        jnp.asarray(docs), jnp.asarray(weights), jnp.asarray(dl),
        *(jnp.asarray(a) for a in arrays), jnp.float32(avgdl), t_pad=8, k=k)
    scores = _plain_scores(docs, weights, dl, avgdl, arrays).numpy()
    # per doc, not per rank: XLA's CPU backend contracts some of the
    # multiply-adds into FMAs, so a score may differ from the rounded f32
    # arithmetic (which the host scorers and the card reproduce bit for
    # bit, see below) in its last bits, and near-ties may swap ranks.
    # Tolerance: 4 ulp, the bound the Stage-1 tests use for the same cause.
    want_s, want_i = np.asarray(want_s), np.asarray(want_i)
    pool, valid = arrays[0], arrays[1]
    for b in range(pool.shape[0]):
        want = {int(i): s for s, i in zip(want_s[b], want_i[b]) if s > 0}
        got = {int(d): s for d, s, v in zip(pool[b], scores[b], valid[b])
               if v and s > 0}
        assert want.keys() == got.keys(), b
        for d, s in got.items():
            assert abs(int(s.view(np.int32))
                       - int(want[d].view(np.int32))) <= 4, (b, d)
    assert (scores[~valid] == 0).all()


@pytest.mark.parametrize("use_native", [True, False])
@pytest.mark.parametrize("case", EDGE_CASES)
def test_plain_scores_equal_the_host_scorer_on_edge_pools(case, use_native,
                                                          monkeypatch):
    if use_native:
        assert native.available
    else:
        monkeypatch.setattr(native, "available", False)
    docs, weights, dl, avgdl, arrays, jobs, built = _edge_case(case)
    scores = _plain_scores(docs, weights, dl, avgdl, arrays).numpy()
    _assert_equals_host_scorer(scores, jobs, built)


def _long_range():
    """One term on every doc of a range of 2^21 + 37 postings, and a short
    term; pools at the range's ends and middle."""
    n = (1 << 21) + 37
    rng = np.random.default_rng(77)
    short = np.sort(rng.permutation(n)[:500])
    docs = np.concatenate([np.arange(n), short]).astype(np.int32)
    weights = rng.integers(1, 256, docs.size).astype(np.uint8)
    dl = (rng.random(n + 1) * 30).astype(np.float32)
    pools = [np.unique(np.concatenate([[0, 1, n - 2, n - 1], short[:200],
                                       rng.integers(0, n, 300)])),
             np.arange(n - 512, n)]
    pool = np.full((4, 512), n, np.int32)
    valid = np.zeros((4, 512), bool)
    t_starts = np.zeros((4, 8), np.int32)
    t_lens = np.zeros((4, 8), np.int32)
    t_idf = np.zeros((4, 8), np.float32)
    jobs = []
    for b, p in enumerate(pools):
        pool[b, :p.size], valid[b, :p.size] = p, True
        t_starts[b, :2], t_lens[b, :2] = [n, 0], [500, n]
        t_idf[b, :2] = [2.5, 0.75]
        jobs.append((np.arange(p.size), p, np.array([1, 0]),
                     np.array([2.5, 0.75], np.float32)))
    built = types.SimpleNamespace(
        term_offsets=np.array([0, n, docs.size], np.int64),
        postings_docs=docs, postings_weights=weights, doc_lengths=dl,
        avgdl=8.7)
    return (docs, weights, dl, np.float32(8.7),
            (pool, valid, t_starts, t_lens, t_idf), jobs, built)


def test_plain_scores_are_exact_past_the_reference_search_depth():
    """A range of more than 2^21 postings: 21 halvings do not reach its
    lower bound, the plain version takes the steps the range needs."""
    docs, weights, dl, avgdl, arrays, jobs, built = _long_range()
    assert int(arrays[3].max()).bit_length() > port_pool.BSEARCH_BITS
    scores = _plain_scores(docs, weights, dl, avgdl, arrays).numpy()
    _assert_equals_host_scorer(scores, jobs, built)
    # every doc of the long range is found
    assert (scores[1] > 0).all()


@pytest.mark.gpu
@pytest.mark.parametrize("case", EDGE_CASES + ["past_2^21"])
def test_cuda_kernel_matches_plain_and_native_on_edge_pools(case):
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    assert native.available
    docs, weights, dl, avgdl, arrays, jobs, built = (
        _long_range() if case == "past_2^21" else _edge_case(case))
    want = _plain_scores(docs, weights, dl, avgdl, arrays)
    cuda = [torch.from_numpy(a).cuda() for a in (*arrays, docs, weights, dl)]
    cuda.append(torch.tensor(avgdl).cuda())
    got = [port_pool.pool_score(*cuda) for _ in range(2)]
    torch.cuda.synchronize()
    for g in got:
        assert torch.equal(g.cpu().view(torch.int32), want.view(torch.int32))
    _assert_equals_host_scorer(got[0].cpu().numpy(), jobs, built)


@pytest.mark.gpu
@pytest.mark.parametrize("seed", [1, 2])
def test_cuda_kernel_matches_plain_version(seed):
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    docs, weights, starts, lens, dl, avgdl = _csr(seed)
    jobs = _jobs(seed + 10, docs, starts, lens, dl.size)
    cpu = [torch.from_numpy(a) for a in (*jobs, docs, weights, dl)]
    cpu.append(torch.tensor(avgdl))
    want = port_pool.pool_score_plain(*cpu)
    cuda = [a.cuda() for a in cpu]
    n0 = _kernels.launch_counts["pool_score"]
    got = [port_pool.pool_score(*cuda) for _ in range(2)]
    torch.cuda.synchronize()
    assert _kernels.launch_counts["pool_score"] == n0 + 2
    for g in got:
        assert torch.equal(g.cpu().view(torch.int32), want.view(torch.int32))
