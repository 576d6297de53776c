"""Port lane expansion (infidex_tpu_torch/ops/stage1_lanes.py) vs the
reference's Pallas kernel (interpret mode) and its numpy oracle.

Inputs are those of tests/test_stage1_chunked.py (exact-chunk and
chunk+1 boundaries). Lane keys and contributions must be bit-equal: a
contribution is one f32 product of the same operands.

``posting_cfac`` is held bit-exact against a numpy oracle that rounds
every operation (the semantics of the reference's numpy and C++ host
scorers, whose native build disables FMA contraction). Against the
reference's jitted version it may differ by up to 2 ulp: XLA's CPU
backend contracts both multiply-add pairs of the expression into FMAs
(one rounding fewer at each).
"""

import os

import numpy as np
import pytest

os.environ["INFIDEX_TPU_PALLAS_INTERPRET"] = "1"

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from infidex_tpu.ops import stage1_lanes as ref  # noqa: E402
from infidex_tpu_torch.ops import _kernels  # noqa: E402
from infidex_tpu_torch.ops import stage1_lanes as port  # noqa: E402

K1, B, DELTA = 1.2, 0.75, 1.0

# the suite runs in several worker processes on shared cores; one intra-op
# thread each keeps torch from oversubscribing them
torch.set_num_threads(1)


def _inputs():
    rng = np.random.default_rng(7)
    P, N = 50_000, 3000
    docs = rng.integers(0, N, P).astype(np.int32)
    w = rng.integers(1, 255, P).astype(np.uint8)
    dl = (rng.random(N) * 20 + 1).astype(np.float32)
    cfac = np.asarray(ref.posting_cfac(jnp.asarray(docs), jnp.asarray(w),
                                       jnp.asarray(dl), 9.3))
    docs_p = np.concatenate([docs, np.zeros(ref.CHUNK, np.int32)])
    cfac_p = np.concatenate([cfac, np.zeros(ref.CHUNK, np.float32)])
    starts = rng.integers(0, P - 20000, 17)
    lens = rng.integers(0, 5000, 17)
    lens[2] = 0
    lens[5] = ref.CHUNK          # exact-chunk boundary
    lens[6] = ref.CHUNK + 1      # boundary + 1
    idfs = rng.random(17).astype(np.float32)
    qofs = rng.integers(0, 4, 17)
    return docs_p, cfac_p, starts, lens, idfs, qofs, N


def _cfac_oracle(docs, w, dl, avgdl):
    f = np.float32
    tf = w.astype(f)
    d = dl[docs]
    d = np.where(d <= 0, f(1), d)
    x = d / f(avgdl)
    norm = f(K1) * (f(1.0 - B) + f(B) * x)
    return (tf * f(K1 + 1.0)) / (tf + norm) + f(DELTA)


def test_chunk_table_is_the_reference_table():
    docs_p, cfac_p, starts, lens, idfs, qofs, N = _inputs()
    a = ref.build_chunk_table(starts, lens, idfs, qofs, N)
    b = port.build_chunk_table(starts, lens, idfs, qofs, N)
    for x, y in zip(a, b):
        assert x.dtype == y.dtype and np.array_equal(x, y)


def test_expand_lanes_bit_equal_to_reference_and_oracle():
    docs_p, cfac_p, starts, lens, idfs, qofs, N = _inputs()
    off, vs, ve, idf_c, base = port.build_chunk_table(starts, lens, idfs,
                                                      qofs, N)
    park = 4 * N - 1
    kj, cj = ref.expand_lanes(*(jnp.asarray(a) for a in
                                (off, vs, ve, idf_c, base, docs_p, cfac_p)),
                              park)
    kp, cp = port.expand_lanes(*(torch.from_numpy(a) for a in
                                 (off, vs, ve, idf_c, base, docs_p, cfac_p)),
                               park)
    ko, co = port.expand_lanes_reference(off, vs, ve, idf_c, base, docs_p,
                                         cfac_p, park)
    assert kp.dtype == torch.int32 and cp.dtype == torch.float32
    assert np.array_equal(kp.numpy(), np.asarray(kj))
    assert np.array_equal(cp.numpy(), np.asarray(cj))
    assert np.array_equal(kp.numpy(), ko)
    assert np.array_equal(cp.numpy(), co)


def test_posting_cfac_bit_exact_vs_oracle_and_within_2_ulp_of_xla():
    rng = np.random.default_rng(3)
    P, N = 40_000, 2000
    docs = rng.integers(0, N, P).astype(np.int32)
    w = rng.integers(1, 255, P).astype(np.uint8)
    dl = (rng.random(N) * 25).astype(np.float32)
    dl[:50] = 0.0                       # zero-length docs take dl = 1
    got = port.posting_cfac(torch.from_numpy(docs), torch.from_numpy(w),
                            torch.from_numpy(dl), 7.7).numpy()
    assert np.array_equal(got, _cfac_oracle(docs, w, dl, 7.7))
    xla = np.asarray(jax.jit(ref.posting_cfac)(
        jnp.asarray(docs), jnp.asarray(w), jnp.asarray(dl), 7.7))
    ulps = np.abs(got.view(np.int32).astype(np.int64)
                  - xla.view(np.int32).astype(np.int64))
    assert ulps.max() <= 2


def _csr(seed, n_terms=17, n_docs=3000, n_q=5):
    """A CSR whose terms list distinct docs (lens include 0, CHUNK and
    CHUNK + 1), owned by sorted queries, with trailing CHUNK pad."""
    rng = np.random.default_rng(seed)
    lens = rng.integers(0, 2500, n_terms)
    lens[2], lens[5], lens[6] = 0, port.CHUNK, port.CHUNK + 1
    starts = np.concatenate([[0], np.cumsum(lens)[:-1]])
    docs = np.concatenate([np.sort(rng.permutation(n_docs)[:n])
                           for n in lens] + [np.zeros(port.CHUNK, int)])
    w = rng.integers(1, 255, docs.size).astype(np.uint8)
    dl = (rng.random(n_docs) * 20 + 1).astype(np.float32)
    cfac = _cfac_oracle(docs, w, dl, 9.3)
    idfs = (rng.random(n_terms) * 5).astype(np.float32)
    qofs = np.sort(rng.integers(0, n_q, n_terms))
    return (docs.astype(np.int32), cfac, starts, lens, idfs, qofs, n_q,
            n_docs + 1)


def _serial_scatter(docs, cfac, starts, lens, idfs, qofs, n_q, n_pad):
    """numpy: every lane added in (query, term) order — the reference's
    serial lane order."""
    want = np.zeros(n_q * n_pad, np.float32)
    want_cnt = np.zeros(n_q * n_pad, np.float32)
    for t in np.argsort(qofs, kind="stable"):
        s, n = int(starts[t]), int(lens[t])
        keys = qofs[t] * n_pad + docs[s:s + n]
        contrib = np.float32(idfs[t]) * cfac[s:s + n]
        want[keys] += contrib                # distinct keys within a term
        want_cnt[keys] += (contrib > 0).astype(np.float32)
    return want, want_cnt


def test_ranked_scatter_equals_serial_scatter():
    """One pass per term rank reproduces a single serial scatter-add of
    all lanes in (query, term) order — the reference's order — bit for
    bit; so does ``scatter_lanes`` on the query-major table."""
    docs, cfac, starts, lens, idfs, qofs, n_q, n_pad = _csr(11)
    chunks = port.build_ranked_chunks(starts, lens, idfs, qofs, n_pad, "cpu")
    assert chunks.bounds[-1] == chunks.off.numel()
    assert len(chunks.bounds) - 1 == port.owner_ranks(qofs).max() + 1
    want, want_cnt = _serial_scatter(docs, cfac, starts, lens, idfs, qofs,
                                     n_q, n_pad)
    scores = torch.zeros(n_q * n_pad)
    cnt = torch.zeros(n_q * n_pad)
    port.scatter_lanes_plain(scores, cnt, chunks, torch.from_numpy(docs),
                             torch.from_numpy(cfac))
    assert np.array_equal(scores.numpy(), want)
    assert np.array_equal(cnt.numpy(), want_cnt)
    qc = port.build_query_chunks(starts, lens, idfs, qofs, n_q, n_pad, "cpu")
    scores = torch.zeros(n_q * n_pad)
    cnt = torch.zeros(n_q * n_pad)
    port.scatter_lanes(scores, cnt, qc, torch.from_numpy(docs),
                       torch.from_numpy(cfac))
    assert np.array_equal(scores.numpy(), want)
    assert np.array_equal(cnt.numpy(), want_cnt)


def _tables(seed, n_terms, n_q, shuffle):
    """Terms owned by random queries (in any order when ``shuffle``),
    some of length 0, CHUNK and CHUNK + 1."""
    docs, cfac, starts, lens, idfs, _, _, n_pad = _csr(seed, n_terms=n_terms,
                                                       n_q=n_q)
    qofs = np.random.default_rng(seed).integers(0, n_q, n_terms)
    if not shuffle:
        qofs = np.sort(qofs)
    return docs, cfac, starts, lens, idfs, qofs, n_q, n_pad


@pytest.mark.parametrize("seed,n_terms,n_q,shuffle", [
    (11, 17, 5, False), (3, 40, 6, True), (4, 16, 1, False),
    (8, 30, 9, True)])
def test_query_major_table_gives_the_rank_major_cells(seed, n_terms, n_q,
                                                      shuffle):
    """The query-major table (the kernel's) holds the rank-major table's
    rows: regrouped by rank it has the same rows in each rank (in the same
    order when the terms come query by query, as a batch gives them), and
    through ``scatter_lanes_plain`` it gives the same cells bit for bit."""
    docs, cfac, starts, lens, idfs, qofs, n_q, n_pad = _tables(
        seed, n_terms, n_q, shuffle)
    ranked = port.build_ranked_chunks(starts, lens, idfs, qofs, n_pad, "cpu")
    qc = port.build_query_chunks(starts, lens, idfs, qofs, n_q, n_pad, "cpu")
    # query q's rows are qstart[q]:qstart[q+1], its terms in rank order
    qstart = qc.qstart.tolist()
    assert len(qstart) == n_q + 1 and qstart[-1] == qc.off.numel()
    for q in range(n_q):
        rows = slice(qstart[q], qstart[q + 1])
        assert (qc.base[rows] == q * n_pad).all()
        r = qc.rank[rows]
        assert (r[1:] >= r[:-1]).all()
    regrouped = qc.ranked()
    assert regrouped.bounds == ranked.bounds

    def band_rows(table, lo, hi):
        rows = torch.stack([table.off[lo:hi], table.vstart[lo:hi],
                            table.vend[lo:hi], table.idf[lo:hi].view(
                                torch.int32), table.base[lo:hi]], 1)
        if shuffle:   # order within a rank follows the terms' order
            rows = rows[np.lexsort(rows.numpy().T[::-1])]
        return rows

    for lo, hi in zip(ranked.bounds, ranked.bounds[1:]):
        assert torch.equal(band_rows(regrouped, lo, hi),
                           band_rows(ranked, lo, hi))
    cells = []
    for table in (ranked, regrouped):
        scores = torch.zeros(n_q * n_pad)
        cnt = torch.zeros(n_q * n_pad)
        port.scatter_lanes_plain(scores, cnt, table, torch.from_numpy(docs),
                                 torch.from_numpy(cfac))
        cells.append((scores, cnt))
    assert torch.equal(cells[0][0].view(torch.int32),
                       cells[1][0].view(torch.int32))
    assert torch.equal(cells[0][1], cells[1][1])
    want, want_cnt = _serial_scatter(docs, cfac, starts, lens, idfs, qofs,
                                     n_q, n_pad)
    assert np.array_equal(cells[1][0].numpy(), want)
    assert np.array_equal(cells[1][1].numpy(), want_cnt)


def test_owner_ranks():
    assert port.owner_ranks(np.array([0, 1, 1, 0, 1])).tolist() == \
        [0, 0, 1, 1, 2]
    assert port.owner_ranks(np.zeros(0, np.int64)).size == 0


def test_cpu_tensors_never_reach_the_kernel_wrapper():
    t = torch.zeros(4)
    i = torch.zeros(1, dtype=torch.int32)
    q = torch.zeros(2, dtype=torch.int32)
    with pytest.raises(ValueError):
        _kernels.stage1_scatter_lanes(t, t, q, i, i, i, torch.zeros(1), i, i,
                                      i, torch.zeros(1))


def _sixteen_ranks(seed=21, n_q=7):
    """Every query has 16 terms; terms overlap in docs, so each cell sums
    up to 16 contributions in rank order."""
    docs, cfac, starts, lens, idfs, _, _, n_pad = _csr(seed, n_terms=16 * n_q,
                                                       n_q=n_q)
    qofs = np.repeat(np.arange(n_q), 16)
    return docs, cfac, starts, lens, idfs, qofs, n_q, n_pad


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["csr", "shuffled", "16 ranks", "1 query"])
def test_cuda_kernel_matches_plain_version(case):
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    docs, cfac, starts, lens, idfs, qofs, n_q, n_pad = {
        "csr": lambda: _csr(5),
        "shuffled": lambda: _tables(3, 40, 6, True),
        "16 ranks": _sixteen_ranks,
        "1 query": lambda: _tables(4, 16, 1, False)}[case]()
    dev = torch.device("cuda")
    qc = port.build_query_chunks(starts, lens, idfs, qofs, n_q, n_pad, dev)
    docs_t = torch.from_numpy(docs).to(dev)
    cfac_t = torch.from_numpy(cfac).to(dev)
    out = []
    n0 = _kernels.launch_counts["stage1_scatter_lanes"]
    for fn, table in ((port.scatter_lanes, qc), (port.scatter_lanes, qc),
                      (port.scatter_lanes_plain, qc.ranked())):
        s = torch.zeros(n_q * n_pad, device=dev)
        c = torch.zeros(n_q * n_pad, device=dev)
        fn(s, c, table, docs_t, cfac_t)
        out.append((s.cpu().view(torch.int32), c.cpu()))
    torch.cuda.synchronize()
    assert _kernels.launch_counts["stage1_scatter_lanes"] == n0 + 2
    for got in out[:2]:
        assert torch.equal(got[0], out[2][0])
        assert torch.equal(got[1], out[2][1])
    want, want_cnt = _serial_scatter(docs, cfac, starts, lens, idfs, qofs,
                                     n_q, n_pad)
    assert np.array_equal(out[0][0].numpy(), want.view(np.int32))
    assert np.array_equal(out[0][1].numpy(), want_cnt)


def _window_cells(seed, layout, doc_lo, doc_hi):
    """Cells of the whole doc axis, and of the window [doc_lo, doc_hi)
    scattered over a table whose keys are query * width + local doc."""
    docs, cfac, starts, lens, idfs, qofs, n_q, n_pad = _tables(seed, 30, 5,
                                                               True)
    width = doc_hi - doc_lo
    docs_t, cfac_t = torch.from_numpy(docs), torch.from_numpy(cfac)
    full = (torch.zeros(n_q * n_pad), torch.zeros(n_q * n_pad))
    port.scatter_lanes_plain(*full, port.build_ranked_chunks(
        starts, lens, idfs, qofs, n_pad, "cpu"), docs_t, cfac_t)
    win = (torch.zeros(n_q * width), torch.zeros(n_q * width))
    if layout == "rank-major":
        port.scatter_lanes_plain(*win, port.build_ranked_chunks(
            starts, lens, idfs, qofs, width, "cpu"), docs_t, cfac_t,
            doc_lo, doc_hi)
    else:
        port.scatter_lanes(*win, port.build_query_chunks(
            starts, lens, idfs, qofs, n_q, width, "cpu"), docs_t, cfac_t,
            doc_lo, doc_hi)
    return ([t.view(n_q, n_pad)[:, doc_lo:doc_hi] for t in full],
            [t.view(n_q, width) for t in win])


@pytest.mark.parametrize("layout", ["rank-major", "query-major"])
@pytest.mark.parametrize("doc_lo,doc_hi", [(0, 1000), (1000, 2001),
                                           (0, 3001), (2992, 3001)])
def test_windowed_scatter_equals_columns_of_the_full_scatter(layout, doc_lo,
                                                             doc_hi):
    """A document shard's scatter (keys query * width + doc - doc_lo,
    lanes of other docs skipped) gives that shard's columns of the whole
    axis' scatter, bit for bit, on both layouts."""
    want, got = _window_cells(3, layout, doc_lo, doc_hi)
    assert torch.equal(got[0].view(torch.int32),
                       want[0].contiguous().view(torch.int32))
    assert torch.equal(got[1], want[1])
    assert (got[1] > 0).any()


@pytest.mark.gpu
@pytest.mark.parametrize("doc_lo,doc_hi", [(0, 1000), (1000, 2001),
                                           (2992, 3001)])
def test_cuda_windowed_kernel_matches_plain_version(doc_lo, doc_hi):
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    docs, cfac, starts, lens, idfs, qofs, n_q, _ = _tables(3, 30, 5, True)
    width = doc_hi - doc_lo
    dev = torch.device("cuda")
    qc = port.build_query_chunks(starts, lens, idfs, qofs, n_q, width, dev)
    docs_t = torch.from_numpy(docs).to(dev)
    cfac_t = torch.from_numpy(cfac).to(dev)
    out = []
    for fn, table in ((port.scatter_lanes, qc),
                      (port.scatter_lanes_plain, qc.ranked())):
        s = torch.zeros(n_q * width, device=dev)
        c = torch.zeros(n_q * width, device=dev)
        fn(s, c, table, docs_t, cfac_t, doc_lo, doc_hi)
        out.append((s.cpu().view(torch.int32), c.cpu()))
    assert torch.equal(out[0][0], out[1][0])
    assert torch.equal(out[0][1], out[1][1])
