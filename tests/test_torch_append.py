"""Incremental append through the port (infidex_tpu_torch) vs the reference
(infidex_tpu, JAX on the CPU).

``CoverageTables.append_texts`` is held to the reference's table state
WHOLE — every device table, pad rows included, the host mirrors and the
``n_docs``/``n_words`` counters — after each of several appends, and to
the same False (rebuild) decisions. At engine level the append route is
held to the rebuild route (``INFIDEX_TPU_APPEND_FINALIZE=0``) exactly and
to the reference with ids exact and scores within 1 f32 ulp (XLA's FMA
contraction and log1p on the CPU; see tests/test_torch_engine.py).
"""

import dataclasses

import numpy as np
import pytest
import torch

import infidex_tpu as ref
import infidex_tpu_torch as port
from infidex_tpu.ops import coverage_kernel as ref_cov
from infidex_tpu_torch import convert, runtime
from infidex_tpu_torch.index.vector_model import VectorModel as PortVM
from tests.test_append_finalize import ADDS, BASE, QUERIES

runtime.set_device("cpu")
# the suite runs in several worker processes on shared cores; one intra-op
# thread each keeps torch from oversubscribing them
torch.set_num_threads(1)

DELIMS = (" ", ",", "-", ":")

#: three appends: new and known words, an empty text, a long word (over
#: L_MAX), a doc of more than D_MAX tokens, non-ASCII and a surrogate pair
APPENDS = [
    ["streamed doc number one", "zyxwvu brandnewword title"],
    ["", "star redemption", "supercalifragilisticexpialidocious-x",
     " ".join(f"w{i}" for i in range(70))],
    ["zelená škola", "emoji \U0001F600 title", "the batman, returns"],
]


def _base_texts():
    return [t.lower() for t in BASE]


def _tables(t):
    """Every field of a CoverageTables as numpy (device tables widened to
    int64 where the packages store different integer types)."""
    out = {}
    for f in dataclasses.fields(t):
        v = getattr(t, f.name)
        if isinstance(v, torch.Tensor):
            v = v.numpy()
        elif v is not None and not isinstance(v, (int, np.integer,
                                                  np.ndarray)):
            v = np.asarray(v)
        if isinstance(v, np.ndarray) and v.dtype.kind in "iu":
            v = v.astype(np.int64)
        out[f.name] = v
    return out


def _assert_same_tables(got, want):
    g, w = _tables(got), _tables(want)
    assert g.keys() == w.keys()
    for name in w:
        if isinstance(w[name], np.ndarray):
            assert g[name].shape == w[name].shape, name
            np.testing.assert_array_equal(g[name], w[name], err_msg=name)
        else:
            assert g[name] == w[name], name


@pytest.mark.parametrize("n_appends", [1, 2, 3])
def test_append_texts_state_matches_reference(n_appends):
    want = ref_cov.CoverageTables.build(_base_texts(), DELIMS)
    got = convert.coverage_tables_from_reference(want, device="cpu")
    _assert_same_tables(got, want)
    ids = [id(v) for v in vars(got).values() if isinstance(v, torch.Tensor)]
    for texts in APPENDS[:n_appends]:
        start = want.n_docs
        assert want.append_texts(texts, DELIMS, start)
        assert got.append_texts(texts, DELIMS, start)
        _assert_same_tables(got, want)
    # in place: the same tensors, grown counters
    assert ids == [id(v) for v in vars(got).values()
                   if isinstance(v, torch.Tensor)]
    assert got.n_docs == len(BASE) + sum(map(len, APPENDS[:n_appends]))
    assert got.overflow[len(BASE):got.n_docs].any() == (n_appends >= 2)


def _overflow_case(case):
    """(base texts, appended texts, start) whose append must be refused."""
    if case == "doc_bucket":          # 1020 docs in a 1024-row table
        return [f"doc {i}" for i in range(1020)], ["a b"] * 5, 1020
    if case == "word_bucket":         # 1020 words in a 1024-row table
        return ([" ".join(f"word{4 * i + j}" for j in range(4))
                 for i in range(255)], ["entirely novel"], 255)
    if case == "lcs_bucket":          # 64-char texts, then a 100-char one
        return ["short title"] * 8, ["x" * 100], 8
    return ["short title"] * 8, ["a b"], 7   # start != n_docs


@pytest.mark.parametrize("case", ["doc_bucket", "word_bucket", "lcs_bucket",
                                  "start_mismatch"])
def test_append_refusals_match_reference(case):
    base, texts, start = _overflow_case(case)
    want = ref_cov.CoverageTables.build(base, DELIMS)
    got = convert.coverage_tables_from_reference(want, device="cpu")
    before = _tables(got)
    assert not want.append_texts(texts, DELIMS, start)
    assert not got.append_texts(texts, DELIMS, start)
    _assert_same_tables(got, want)
    for name, v in _tables(got).items():     # nothing was written
        if isinstance(v, np.ndarray):
            np.testing.assert_array_equal(v, before[name], err_msg=name)
        else:
            assert v == before[name], name


def _build(pkg, monkeypatch, fast: bool):
    """tests/test_append_finalize.py's scenario, extended by a delete of
    an appended doc and a re-add of its key."""
    monkeypatch.setenv("INFIDEX_TPU_APPEND_FINALIZE", "1" if fast else "0")
    eng = pkg.SearchEngine.create_default()
    eng.index_documents([pkg.Document(i, t) for i, t in enumerate(BASE)])
    tables = eng.vector_model.coverage_tables
    for j, t in enumerate(ADDS):
        eng.index_document(pkg.Document(1000 + j, t))
        if (j + 1) % 3 == 0:
            eng.calculate_weights()
    eng.calculate_weights()
    return eng, tables


def _results(pkg, eng):
    return [[(r.document_id, np.float32(r.score))
             for r in eng.search(pkg.Query(q, 10)).records] for q in QUERIES]


def _assert_close(got, want):
    for g, w in zip(got, want):
        assert [i for i, _ in g] == [i for i, _ in w]
        for (_, a), (_, b) in zip(g, w):
            assert abs(int(np.array(a).view(np.int32))
                       - int(np.array(b).view(np.int32))) <= 1


def test_append_route_matches_rebuild_and_reference(monkeypatch):
    fast, tables = _build(port, monkeypatch, fast=True)
    slow, _ = _build(port, monkeypatch, fast=False)
    want_eng, _ = _build(ref, monkeypatch, fast=True)
    m = fast.vector_model
    # the append route was taken: same tables object, grown in place
    assert m._last_append is not None and m.coverage_tables is tables
    assert tables.n_docs == len(BASE) + len(ADDS)
    _assert_same_tables(m.coverage_tables,
                        want_eng.vector_model.coverage_tables)
    steps = []
    for eng, pkg in ((fast, port), (slow, port), (want_eng, ref)):
        res = [_results(pkg, eng)]
        eng.delete_documents(1001)            # an appended doc
        res.append(_results(pkg, eng))
        eng.index_document(pkg.Document(1001, "Zyxwvu returns again"))
        eng.calculate_weights()
        res.append(_results(pkg, eng))
        steps.append(res)
    for a, b, w in zip(*steps):
        assert a == b                          # append route == rebuild route
        _assert_close(a, w)
    flat = [i for q in steps[0][1] for i, _ in q]
    assert 1001 not in flat and 1001 in [i for q in steps[0][2] for i, _ in q]


def test_signature_index_extends_through_the_port(monkeypatch):
    """tests/test_append_finalize.py's signature-extension scenario,
    through the port."""
    monkeypatch.setattr(PortVM, "SIGNATURE_VOCAB_THRESHOLD", 1)
    monkeypatch.setenv("INFIDEX_TPU_APPEND_FINALIZE", "1")

    def results(eng, text):
        res = eng.search(port.Query(text, 10))
        return [(r.document_id, round(r.score, 6)) for r in res.records]

    eng = port.SearchEngine.create_default()
    eng.index_documents([port.Document(i, t) for i, t in enumerate(BASE)])
    m = eng.vector_model
    results(eng, "shawshenk")                 # builds the signature index
    sig_before = m._sig_index
    assert sig_before is not None
    eng.index_document(port.Document(3000, "Quixotic adventures"))
    eng.calculate_weights()
    assert m._sig_index is sig_before         # extended, not rebuilt
    r_fast = results(eng, "quixotik")         # typo toward the NEW doc
    assert any(doc_id == 3000 for doc_id, _ in r_fast)
    eng2 = port.SearchEngine.create_default()
    eng2.index_documents(
        [port.Document(i, t) for i, t in enumerate(BASE)]
        + [port.Document(3000, "Quixotic adventures")])
    assert r_fast == results(eng2, "quixotik")
    ref_eng = ref.SearchEngine.create_default()
    ref_eng.index_documents(
        [ref.Document(i, t) for i, t in enumerate(BASE)]
        + [ref.Document(3000, "Quixotic adventures")])
    want = ref_eng.search(ref.Query("quixotik", 10)).records
    assert [i for i, _ in r_fast] == [r.document_id for r in want]


@pytest.mark.gpu
def test_cpu_and_cuda_agree_after_appends(monkeypatch):
    """The append scenario served on both devices: identical ids and f32
    scores (single-term typo queries reach the fusion score's
    lexical-similarity division)."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    out = []
    for dev in ("cpu", "cuda"):
        runtime.set_device(dev)
        try:
            eng, _ = _build(port, monkeypatch, fast=True)
            eng.vector_model.SIGNATURE_VOCAB_THRESHOLD = 0
            out.append(_results(port, eng))
        finally:
            runtime.set_device("cpu")
    assert out[0] == out[1]
