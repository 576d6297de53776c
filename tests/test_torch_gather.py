"""The coverage block's gather of the port
(infidex_tpu_torch/ops/coverage_kernel.py ``gather_block``).

* ``gather_block_plain`` against the gather ``_coverage_block`` built
  inline before it became a function (kept below as ``inline_gather``):
  every field of the same dtype, shape and contiguity, equal bool for
  bool, on tables with codes of -1 inside a doc's token count, token
  counts below and above D, and words of 13-24 chars in an L-12 block;
* the kernel's per-slot code (csrc/coverage_gather_cell.cuh, the header
  csrc/coverage_gather.cu includes), compiled for the host with g++ behind
  the kernel's C interface and driven through the port's own argument
  marshalling (``_kernels.bind``, ``_kernels.gather_call``), against
  ``gather_block_plain``: every field equal, and every output element
  written;
* the arguments the engine hands the gather on the CPU (the serving
  layout and 2 shards, after appends) are what the kernel takes
  (``_kernels.gather_dims``: dtypes, shapes, contiguity), and the host
  build equals the plain version on them;
* ``_coverage_block`` with the gather a function call gives the same bits
  as with the inline gather;
* on a card, the kernel against the plain version: the same.

Inputs are made with numpy from a seed.
"""

import numpy as np
import pytest
import torch

import bench
import infidex_tpu_torch as it
from tests.test_torch_coverage_lcs import compile_cell
from infidex_tpu_torch import runtime
from infidex_tpu_torch.ops import _kernels
from infidex_tpu_torch.ops import coverage_kernel as ck

runtime.set_device("cpu")
# the suite runs in several worker processes on shared cores; one intra-op
# thread each keeps torch from oversubscribing them
torch.set_num_threads(1)

#: (Q, FQ, L, D) of the blocks the pipeline runs, and one of each other
#: width
SHAPES = {"small": (4, 4, 12, 8), "narrow": (16, 16, 24, 16),
          "wide": (16, 16, 24, 64), "q4_wide": (4, 8, 24, 64),
          "q16_small": (16, 4, 12, 8)}
#: the doc tables' widths (the coverage program's L_MAX and D_MAX)
L_MAX, D_MAX = 24, 64


def inline_gather(tables, queries, text_ids, qsel, L, D):
    """The lines ``_coverage_block`` ran before the gather became a
    function, as they stood."""
    (word_chars, word_chars_rev, word_lens, doc_tokens, doc_tok_offsets,
     doc_tok_count, doc_adj_ws, doc_text_len) = tables
    (q_chars, q_chars_rev, q_lens, q_idf, q_word_idf, q_count, q_sorted,
     fq_chars, fq_chars_rev, fq_lens, fq_count, fq_last_is_alpha,
     query_len) = queries
    dev = doc_tokens.device
    qc3 = q_chars[qsel].permute(1, 2, 0).contiguous()          # [Q,L,C]
    qr3 = q_chars_rev[qsel].permute(1, 2, 0).contiguous()
    qlens2 = q_lens[qsel].T.contiguous()                       # [Q,C]
    qcount = q_count[qsel]                                     # [C]
    qsorted2 = q_sorted[qsel].T.contiguous()                   # [Q,C]
    fqc3 = fq_chars[qsel].permute(1, 2, 0).contiguous()        # [FQ,L,C]
    fqr3 = fq_chars_rev[qsel].permute(1, 2, 0).contiguous()
    fqlens2 = fq_lens[qsel].T.contiguous()                     # [FQ,C]
    codes = doc_tokens[text_ids][:, :D].T.contiguous()          # [D,C]
    tok_count = doc_tok_count[text_ids]                         # [C]
    offsets = doc_tok_offsets[text_ids][:, :D].T.contiguous()   # [D,C]
    adj_ws = doc_adj_ws[text_ids][:, :D].T.contiguous()         # [D,C]
    text_len = doc_text_len[text_ids]                           # [C]
    safe_codes = torch.clamp_min(codes, 0).long()
    chars_t = word_chars[safe_codes][:, :, :L].permute(2, 0, 1)     # [L,D,C]
    chars_rev_t = word_chars_rev[safe_codes][:, :, :L].permute(2, 0, 1)
    lens = torch.where(codes >= 0, word_lens[safe_codes], 0)        # [D,C]
    d_iota = torch.arange(D, dtype=torch.int32, device=dev)
    all_valid = (codes >= 0) & (d_iota[:, None] < tok_count[None])  # [D,C]
    chars_t = torch.where(all_valid[None], chars_t, 0).contiguous()
    chars_rev_t = torch.where(all_valid[None], chars_rev_t, 0).contiguous()
    lens = torch.where(all_valid, lens, 0)
    first_char = chars_t[0]                          # [D,C]
    return (qc3, qr3, qlens2, qcount, qsorted2, fqc3, fqr3, fqlens2, codes,
            tok_count, offsets, adj_ws, text_len, chars_t, chars_rev_t, lens,
            all_valid, first_char)


def make_block(seed, Q, FQ, L, D, n_docs=60, n_words=40, B=6, C=300):
    """Doc tables at the coverage program's widths (words of 1-24 chars,
    docs of 0-64 tokens, some codes -1 inside the count) and B queries of
    Q and FQ tokens; C candidates drawn from them. Returns (tables,
    queries, text_ids, qsel)."""
    rng = np.random.default_rng(seed)
    word_lens = rng.integers(1, L_MAX + 1, n_words).astype(np.int32)
    word_lens[:4] = (13, 18, 24, 12)                  # past an L-12 block
    word_chars = np.zeros((n_words, L_MAX), np.int32)
    word_rev = np.zeros((n_words, L_MAX), np.int32)
    for w, n in enumerate(word_lens):
        chars = rng.integers(97, 123, n)
        word_chars[w, :n], word_rev[w, :n] = chars, chars[::-1]
    tok_count = rng.integers(0, D_MAX + 1, n_docs).astype(np.int32)
    tok_count[:3] = (0, D, D_MAX)
    tok_count[3:20] = rng.integers(0, D + 1, 17)      # at most D
    doc_tokens = np.full((n_docs, D_MAX), -1, np.int32)
    for n, k in enumerate(tok_count):
        doc_tokens[n, :k] = rng.integers(0, n_words, k)
        doc_tokens[n, :k][rng.random(k) < 0.1] = -1   # tokens without a word
    offsets = rng.integers(0, 500, (n_docs, D_MAX)).astype(np.int32)
    adj = rng.random((n_docs, D_MAX)) < 0.5
    text_len = rng.integers(0, 300, n_docs).astype(np.int32)
    tables = tuple(torch.from_numpy(x) for x in (
        word_chars, word_rev, word_lens, doc_tokens, offsets, tok_count, adj,
        text_len))

    def chars(*shape):
        return torch.from_numpy(rng.integers(0, 123, shape).astype(np.int32))

    q_lens = rng.integers(0, L + 1, (B, Q)).astype(np.int32)
    q_sorted = np.argsort(-q_lens, axis=1, kind="stable").astype(np.int32)
    queries = (chars(B, Q, L), chars(B, Q, L), torch.from_numpy(q_lens),
               torch.from_numpy(rng.random((B, Q), np.float32)),
               torch.from_numpy(rng.random((B, Q), np.float32)),
               torch.from_numpy(rng.integers(0, Q + 1, B).astype(np.int32)),
               torch.from_numpy(q_sorted), chars(B, FQ, L), chars(B, FQ, L),
               torch.from_numpy(rng.integers(0, L + 1, (B, FQ))
                                .astype(np.int32)),
               torch.from_numpy(rng.integers(0, FQ + 1, B).astype(np.int32)),
               torch.from_numpy(rng.random(B) < 0.5),
               torch.from_numpy(rng.integers(1, 80, B).astype(np.int32)))
    text_ids = torch.from_numpy(rng.integers(0, n_docs, C))
    text_ids[:3] = torch.tensor([0, 1, 2])
    qsel = torch.from_numpy(rng.integers(0, B, C))
    return tables, queries, text_ids, qsel


def assert_same_fields(got, want):
    """Every field of the same dtype, shape and contiguity, and equal."""
    assert len(got) == len(want) == len(ck.GatheredBlock._fields)
    for name, g, w in zip(ck.GatheredBlock._fields, got, want):
        assert g.dtype == w.dtype, name
        assert g.shape == w.shape, name
        assert g.is_contiguous() == w.is_contiguous(), name
        bad = (g != w).nonzero()
        assert bad.numel() == 0, (name, bad[:4].tolist())


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("shape", list(SHAPES))
def test_plain_gather_equals_the_inline_gather(shape, seed):
    Q, FQ, L, D = SHAPES[shape]
    args = make_block(10 * seed + list(SHAPES).index(shape), Q, FQ, L, D)
    got = ck.gather_block_plain(*args, L, D)
    assert isinstance(got, ck.GatheredBlock)
    assert_same_fields(got, inline_gather(*args, L, D))
    # the dispatcher takes the plain version for CPU tensors
    assert_same_fields(ck.gather_block(*args, L, D), got)
    # the inputs reach what they are meant to: a code of -1 inside a doc's
    # count, counts below and above D, words longer than L
    tables, _, text_ids, _ = args
    count = tables[5][text_ids]
    assert (count < D).any() and ((count > D).any() or D == D_MAX)
    inside = torch.arange(D)[:, None] < count[None]
    assert ((got.codes < 0) & inside).any()
    assert (got.lens > L).any() == (L == 12)
    assert got.all_valid.any() and not got.all_valid.all()


_HOST_LOOP = r"""
#include "coverage_gather_cell.cuh"
// The kernel's C interface on the host: every slot of every candidate.
extern "C" int coverage_gather(GATHER_C_PARAMS, void* stream) {
  (void)stream;
  if (n_c <= 0) return 0;
  const gather::Args a = GATHER_ARGS;
  if (!gather::widths_ok(a, n_l)) return 1;
  for (int s = 0; s < gather::n_slots(a); ++s) {
    for (int c = 0; c < n_c; ++c) {
      if (n_l == 12) gather::slot_of<12>(a, s, c);
      else gather::slot_of<24>(a, s, c);
    }
  }
  return 0;
}
"""


@pytest.fixture(scope="module")
def host_gather(tmp_path_factory):
    """csrc/coverage_gather_cell.cuh behind the kernel's C interface,
    bound by ``_kernels.bind`` and called through ``_kernels.gather_call``;
    the outputs start as 0x7f bytes, so an element no slot wrote shows."""
    lib = _kernels.bind(compile_cell(tmp_path_factory, "gather_cell",
                                     _HOST_LOOP))

    def run(tables, queries, text_ids, qsel, L, D):
        n = _kernels.gather_dims(tables, queries, text_ids, qsel, L, D)
        want = ck.gather_block_plain(tables, queries, text_ids, qsel, L, D)
        outs = [torch.full_like(w, 0x7f) if w.dtype != torch.bool
                else torch.empty_like(w).view(torch.uint8).fill_(0x7f)
                .view(torch.bool) for w in want[:-1]]
        rc = _kernels.gather_call(lib, tables, queries, text_ids, qsel, L, D,
                                  n, outs, None)
        assert rc == 0
        for o in outs:
            if o.dtype == torch.bool:
                assert (o.view(torch.uint8) <= 1).all()
        return (*outs, outs[13][0])

    return run


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("shape", list(SHAPES))
def test_gather_cell_code_equals_the_plain_version(host_gather, shape, seed):
    Q, FQ, L, D = SHAPES[shape]
    args = make_block(100 + 10 * seed + list(SHAPES).index(shape), Q, FQ, L,
                      D)
    assert_same_fields(host_gather(*args, L, D),
                       ck.gather_block_plain(*args, L, D))


def test_gather_of_no_candidates(host_gather):
    tables, queries, _, _ = make_block(5, 4, 4, 12, 8)
    none = torch.zeros(0, dtype=torch.int64)
    got = ck.gather_block_plain(tables, queries, none, none, 12, 8)
    assert all(t.shape[-1] == 0 for t in got)
    assert_same_fields(host_gather(tables, queries, none, none, 12, 8), got)


def test_widths_the_kernel_does_not_take_raise():
    tables, queries, text_ids, qsel = make_block(6, 4, 4, 12, 8)
    with pytest.raises(ValueError):          # CPU tensors
        _kernels.coverage_gather(tables, queries, text_ids, qsel, 12, 8)
    with pytest.raises(ValueError):          # D past the doc tables
        _kernels.gather_dims(tables, queries, text_ids, qsel, 12, 65)
    with pytest.raises(TypeError):           # int32 ids
        _kernels.gather_dims(tables, queries, text_ids.int(), qsel, 12, 8)
    with pytest.raises(ValueError):          # a strided table
        _kernels.gather_dims((tables[0][:, :12], *tables[1:]), queries,
                             text_ids, qsel, 12, 8)


@pytest.mark.parametrize("bad", ["id_past_n", "id_negative",
                                 "qsel_past_b"])
def test_batch_rows_outside_the_tables_raise(bad):
    """``coverage_fusion_batch`` holds the engine's host row ids to the
    tables before the gather reads them unchecked."""
    tables, queries, _, _ = make_block(8, 4, 4, 12, 8)
    N, B = tables[3].shape[0], queries[0].shape[0]
    text_ids = np.arange(4, dtype=np.int32)
    qsel = np.zeros(4, np.int32)
    if bad == "id_past_n":
        text_ids[2] = N
    elif bad == "id_negative":
        text_ids[0] = -1
    else:
        qsel[3] = B
    zeros = np.zeros(4, np.float32)
    with pytest.raises(IndexError):
        ck.coverage_fusion_batch(*tables, text_ids, qsel, *queries[:-1],
                                 zeros, zeros, queries[-1],
                                 config=ck.CoverageConfig(d_cap=8))
    ok = ck.coverage_fusion_batch(*tables, np.arange(4, dtype=np.int32),
                                  np.zeros(4, np.int32), *queries[:-1],
                                  zeros, zeros, queries[-1],
                                  config=ck.CoverageConfig(d_cap=8))
    assert ok.shape == (3, 4)


def _engine_blocks(monkeypatch, sharded):
    """The gather's arguments of every coverage block of two batches
    served on the CPU by a 1,000-doc engine (after 50 appends), on one
    index or on 2 shards."""
    titles = bench.make_corpus(1000)
    queries = bench.make_queries(titles, 64)
    eng = it.SearchEngine.create_default()
    eng.index_documents([it.Document(i, t) for i, t in enumerate(titles)])
    for i, t in enumerate(bench.make_corpus(50)):
        eng.index_document(it.Document(1000 + i, t + " appended"))
    eng.calculate_weights()
    if sharded:
        eng.enable_sharded_serving(n_devices=2)
    seen = []
    plain = ck.gather_block

    def spy(*args):
        seen.append(args)
        return plain(*args)

    monkeypatch.setattr(ck, "gather_block", spy)
    for lo in (0, 32):
        eng.search_batch([it.Query(q, 10) for q in queries[lo:lo + 32]])
    return seen


@pytest.mark.parametrize("sharded", [False, True])
def test_engine_blocks_are_what_the_kernel_takes(monkeypatch, host_gather,
                                                 sharded):
    blocks = _engine_blocks(monkeypatch, sharded)
    assert blocks
    for args in blocks:
        _kernels.gather_dims(*args)
        assert_same_fields(host_gather(*args), ck.gather_block_plain(*args))


@pytest.mark.parametrize("shape", list(SHAPES))
def test_coverage_block_unchanged(monkeypatch, shape):
    """``_coverage_block`` gives the same bits with the inline gather in
    place of ``gather_block``, in both layouts."""
    Q, FQ, L, D = SHAPES[shape]
    tables, queries, text_ids, qsel = make_block(
        7 + list(SHAPES).index(shape), Q, FQ, L, D, C=64)
    config = ck.CoverageConfig(d_cap=D)
    C, B, N = text_ids.shape[0], queries[0].shape[0], tables[3].shape[0]
    rng = np.random.default_rng(3)
    lcs_vals = torch.from_numpy(rng.integers(0, 6, C).astype(np.float32))
    base = torch.from_numpy(rng.random(C).astype(np.float32))
    lcs = (torch.from_numpy(rng.integers(97, 100, (N, 64)).astype(np.int32)),
           torch.ones(N, dtype=torch.bool),
           torch.from_numpy(rng.integers(97, 100, (B, 16)).astype(np.int32)),
           torch.full((B,), 5, dtype=torch.int32),
           torch.ones(B, dtype=torch.int32), torch.ones(B, dtype=torch.bool))
    for layout in (lcs, None):
        args = (tables, queries, layout, text_ids, qsel, lcs_vals, base)
        got = ck._coverage_block(*args, config=config)
        with monkeypatch.context() as m:
            m.setattr(ck, "gather_block", lambda *a: ck.GatheredBlock(
                *inline_gather(*a)))
            want = ck._coverage_block(*args, config=config)
        assert got.shape == want.shape == (2 if layout else 3, C)
        assert torch.equal(got.view(torch.int32), want.view(torch.int32))


@pytest.mark.gpu
@pytest.mark.parametrize("shape", list(SHAPES))
def test_cuda_kernel_matches_plain_version(shape):
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    Q, FQ, L, D = SHAPES[shape]
    tables, queries, text_ids, qsel = make_block(
        200 + list(SHAPES).index(shape), Q, FQ, L, D, C=3000)
    want = ck.gather_block_plain(tables, queries, text_ids, qsel, L, D)
    on_card = (tuple(t.cuda() for t in tables),
               tuple(t.cuda() for t in queries), text_ids.cuda(),
               qsel.cuda())
    n0 = _kernels.launch_counts["coverage_gather"]
    got = [ck.gather_block(*on_card, L, D) for _ in range(2)]
    torch.cuda.synchronize()
    assert _kernels.launch_counts["coverage_gather"] == n0 + 2
    for g in got:
        assert_same_fields(tuple(t.cpu() for t in g), want)
    # the plain version on the card gives the same as on the CPU
    assert_same_fields(tuple(t.cpu() for t in ck.gather_block_plain(
        *on_card, L, D)), want)
