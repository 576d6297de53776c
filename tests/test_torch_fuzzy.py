"""Port signature matcher (infidex_tpu_torch/ops/fuzzy.py) vs the reference
(infidex_tpu/ops/fuzzy.py, JAX on the CPU).

Everything here is integer or id output and is held exactly: the match
rows (ids, order and padding), candidate and match lists, the whole
device state after an in-place extension, and engine result ids. Engine
scores may differ by at most 1 f32 ulp (XLA's FMA contraction and log1p
on the CPU; see tests/test_torch_engine.py).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import infidex_tpu as ref
import infidex_tpu_torch as port
from infidex_tpu.ops import fuzzy as ref_fuzzy
from infidex_tpu_torch import convert, runtime
from infidex_tpu_torch.ops import _kernels
from infidex_tpu_torch.ops import fuzzy as port_fuzzy
from tests.test_fuzzy_signature import TITLES, TYPO_TOKENS, _dict_expand

runtime.set_device("cpu")
# the suite runs in several worker processes on shared cores; one intra-op
# thread each keeps torch from oversubscribing them
torch.set_num_threads(1)


def _random_state(seed, v_pad=1536):
    """Random vocabulary signatures plus token rows of every kind: near
    copies of vocabulary signatures (pass), sparse rows that pass for a
    block of 800 sparse length-5 terms (fill a small cap), rows with an
    impossible length (empty), and all-zero pad rows."""
    rng = np.random.default_rng(seed)
    dens = rng.uniform(0.02, 0.2, v_pad)[:, None]
    sig = (rng.random((v_pad, 128)) < dens).astype(np.int8)
    # eligible terms are at least min_len = 3 long, as in an index
    vlen = rng.integers(3, 12, v_pad).astype(np.int32)
    sparse = np.arange(100, 900)
    sig[sparse] = 0
    sig[sparse, rng.integers(0, 128, sparse.size)] = 1
    vlen[sparse] = 5
    elig = rng.random(v_pad) < 0.8
    elig[-200:] = False                       # headroom slots
    sig[~elig] = 0
    vlen[~elig] = 0
    vpop = sig.sum(axis=1, dtype=np.int32)
    rows, lens = [], []
    for _ in range(12):                       # near copies
        v = int(rng.choice(np.flatnonzero(elig)))
        r = sig[v].copy()
        r[rng.integers(0, 128, 2)] ^= 1
        rows.append(r)
        lens.append(int(vlen[v]) + int(rng.integers(-1, 2)))
    for _ in range(3):                        # heavy: the sparse block
        r = np.zeros(128, np.int8)
        r[rng.integers(0, 128, 2)] = 1
        rows.append(r)
        lens.append(5)
    rows.append(sig[0].copy())                # impossible length: empty
    lens.append(60)
    qsig = np.zeros((24, 128), np.int8)       # the rest are pad rows
    qsig[:len(rows)] = np.stack(rows)
    qlen = np.zeros(24, np.int32)
    qlen[:len(lens)] = lens
    qpop = qsig.sum(axis=1, dtype=np.int32)
    return sig, vpop, vlen, elig, qsig, qpop, qlen


def _port_args(sig, vpop, vlen, elig, qsig, qpop, qlen):
    t = torch.from_numpy
    return (t(port_fuzzy.pack_signatures(sig)), t(vpop), t(vlen), t(elig),
            t(port_fuzzy.pack_signatures(qsig)), t(qpop), t(qlen))


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("cap", [16, 300, 1536])
def test_match_plain_equals_reference_match_kernel(seed, cap):
    state = _random_state(seed)
    sig, vpop, vlen, elig, qsig, qpop, qlen = state
    want = np.asarray(ref_fuzzy._match_kernel(
        jnp.asarray(sig.T), jnp.asarray(vpop), jnp.asarray(vlen),
        jnp.asarray(elig), jnp.asarray(qsig), jnp.asarray(qpop),
        jnp.asarray(qlen), cap=cap))
    got = port_fuzzy.match(*_port_args(*state), cap=cap).numpy()
    assert got.dtype == np.int32 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    v_pad = sig.shape[0]
    # the cases the rows were made for actually occur
    n_pass = (got < v_pad).sum(axis=1)
    assert (n_pass[12:15] == min(cap, 600)).all() if cap < 600 else \
        (n_pass[12:15] >= 600).all()
    assert n_pass[:12].min() > 0
    assert n_pass[15] == 0
    assert (got[16:] == v_pad).all(), "pad token rows must come out empty"


def test_pack_signatures_bit_order():
    sig = np.zeros((2, 128), np.int8)
    sig[0, [0, 31, 32, 127]] = 1
    words = port_fuzzy.pack_signatures(sig)
    assert words.shape == (2, 4) and words.dtype == np.int32
    assert words.view(np.uint32)[0].tolist() == [0x80000001, 1, 0,
                                                 0x80000000]
    assert (words[1] == 0).all()


@pytest.fixture(scope="module")
def ref_engine():
    eng = ref.SearchEngine.create_default()
    eng.index_documents([ref.Document(i, t) for i, t in enumerate(TITLES)])
    return eng


def test_candidates_and_matches_equal_reference(ref_engine):
    model = ref_engine.vector_model
    built = model.built
    want = ref_fuzzy.NGramSignatureIndex(built.terms, built.df)
    got = port_fuzzy.NGramSignatureIndex(built.terms, built.df)
    assert got.v == want.v and got.v_pad == want._sig_t.shape[1]
    for a, b in zip(got.candidates_batch(TYPO_TOKENS),
                    want.candidates_batch(TYPO_TOKENS)):
        np.testing.assert_array_equal(a, b)
    got_m = got.match_batch(TYPO_TOKENS, model._ld1_verify)
    for tok, a, b in zip(TYPO_TOKENS, got_m,
                         want.match_batch(TYPO_TOKENS, model._ld1_verify)):
        np.testing.assert_array_equal(a, b, err_msg=tok)
        # and the host delete-variant dictionary agrees
        np.testing.assert_array_equal(a, _dict_expand(model, tok),
                                      err_msg=tok)
    assert sum(m.size for m in got_m) > 0


def _state(idx):
    return (idx._sig.numpy(), idx._vpop.numpy(), idx._vlen.numpy(),
            idx._elig.numpy(), idx.v, list(idx._terms))


def _ref_state(idx):
    return (port_fuzzy.pack_signatures(np.asarray(idx._sig_t).T),
            np.asarray(idx._vpop), np.asarray(idx._vlen),
            np.asarray(idx._elig), idx.v, list(idx._terms))


def _assert_same_state(a, b):
    for x, y in zip(a[:4], b[:4]):
        np.testing.assert_array_equal(x, y)
    assert a[4:] == b[4:]


def test_converted_state_equals_reference(ref_engine):
    built = ref_engine.vector_model.built
    want = ref_fuzzy.NGramSignatureIndex(built.terms, built.df)
    got = convert.signature_index_from_reference(want)
    _assert_same_state(_state(got), _ref_state(want))
    _assert_same_state(
        _state(port_fuzzy.NGramSignatureIndex(built.terms, built.df)),
        _ref_state(want))


@pytest.mark.parametrize("flip", [False, True])
def test_extend_append_matches_reference_and_fresh_build(ref_engine, flip):
    built = ref_engine.vector_model.built
    terms = list(built.terms)
    df = np.asarray(built.df).copy()
    n0 = len(terms) - 20
    want = ref_fuzzy.NGramSignatureIndex(terms[:n0], df[:n0])
    got = convert.signature_index_from_reference(want)
    off = [i for i in range(n0) if want._elig[i]][:3] if flip else []
    df2 = df.copy()
    df2[off] = -1                             # flipped: now stop terms
    assert want.extend_append(terms, df2, n0, off)
    assert got.extend_append(terms, df2, n0, off)
    _assert_same_state(_state(got), _ref_state(want))
    fresh = port_fuzzy.NGramSignatureIndex(terms, df2)
    tokens = TYPO_TOKENS + [terms[i] for i in off] + terms[n0:n0 + 5]
    for a, b in zip(got.candidates_batch(tokens),
                    fresh.candidates_batch(tokens)):
        np.testing.assert_array_equal(a, b)
    # headroom overflow: the caller rebuilds
    many = terms + [f"zzfresh{i:06d}" for i in range(got.v_pad)]
    assert not got.extend_append(many, np.ones(len(many), np.int32), got.v)


def test_engine_signature_route_matches_reference():
    """Whole-engine parity with the signature matcher forced on (the
    reference's own threshold override), batch and single queries."""
    queries = ["shawshenk", "redemptoin day", "the godfathr", "fight clab",
               "intersteller", "matrx", "gladiatr"]
    out = []
    for pkg in (ref, port):
        eng = pkg.SearchEngine.create_default()
        eng.index_documents([pkg.Document(i, t)
                             for i, t in enumerate(TITLES)])
        eng.vector_model.SIGNATURE_VOCAB_THRESHOLD = 0
        batch = eng.search_batch([pkg.Query(q, 10) for q in queries])
        single = [eng.search(pkg.Query(q, 10)) for q in queries]
        assert eng.vector_model._sig_index is not None
        out.append([[(r.document_id, np.float32(r.score)) for r in res.records]
                    for res in batch + single])
    want, got = out
    assert isinstance(port.SearchEngine.create_default().vector_model,
                      port.VectorModel)
    for w, g in zip(want, got):
        assert [i for i, _ in g] == [i for i, _ in w]
        ulps = [abs(int(np.array(a).view(np.int32))
                    - int(np.array(b).view(np.int32)))
                for (_, a), (_, b) in zip(g, w)]
        assert max(ulps, default=0) <= 1
    assert any(got)


def test_cpu_tensors_never_reach_the_kernel_wrapper():
    i = torch.zeros(4, dtype=torch.int32)
    s = torch.zeros((4, 4), dtype=torch.int32)
    with pytest.raises(ValueError):
        _kernels.fuzzy_match(s, i, i, torch.zeros(4, dtype=torch.bool), s,
                             i, i, cap=4)


@pytest.mark.gpu
@pytest.mark.parametrize("cap", [16, 1536])
def test_cuda_kernel_matches_plain_version(cap):
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    args = [a.cuda() for a in _port_args(*_random_state(3))]
    n0 = _kernels.launch_counts["fuzzy_match"]
    k1 = _kernels.fuzzy_match(*args, cap=cap)
    k2 = _kernels.fuzzy_match(*args, cap=cap)
    plain = port_fuzzy.match_plain(*args, cap=cap)
    torch.cuda.synchronize()
    assert _kernels.launch_counts["fuzzy_match"] == n0 + 2
    assert torch.equal(k1, plain) and torch.equal(k1, k2)


@pytest.mark.gpu
@pytest.mark.parametrize("v_pad,cap,reps", [
    (1100, 16, 1),      # V_pad not a multiple of the kernel's 512-id tile
    (1100, 1100, 1),    # cap = V_pad: every passer fits
    (1664, 300, 13)])   # 312 token rows: more than one shared-memory stage
def test_cuda_kernel_edge_cases(v_pad, cap, reps):
    """Rows where more than ``cap`` ids pass, rows where none pass, pad
    rows, a ragged last tile and row staging: bit-equal to the plain
    version and deterministic."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    sig, vpop, vlen, elig, qsig, qpop, qlen = _random_state(7, v_pad=v_pad)
    qsig, qpop, qlen = (np.tile(a, (reps,) + (1,) * (a.ndim - 1))
                        for a in (qsig, qpop, qlen))
    args = [a.cuda() for a in _port_args(sig, vpop, vlen, elig, qsig, qpop,
                                         qlen)]
    k1 = _kernels.fuzzy_match(*args, cap=cap)
    k2 = _kernels.fuzzy_match(*args, cap=cap)
    plain = port_fuzzy.match_plain(*args, cap=cap)
    torch.cuda.synchronize()
    assert torch.equal(k1, plain) and torch.equal(k1, k2)
    n_out = (plain < v_pad).sum(dim=1)
    assert (n_out == 0).any()                   # empty and pad rows
    if cap < v_pad:                             # rows cut at cap
        assert (n_out == cap).any()
