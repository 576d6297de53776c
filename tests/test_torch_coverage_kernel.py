"""Port coverage + fusion program and edit distances
(infidex_tpu_torch/ops/{coverage_kernel,editdistance_multi}.py) vs the
reference's jitted versions.

Inputs are those of tests/test_coverage_kernel.py (word-soup corpora with
exact, typo, prefix, joined and single-char-last queries, multi-query
batches), tests/test_device_lcs.py (device fake-LCS) and the multi-query
part of tests/test_editdistance_device.py, over all three shape buckets
(small: d_cap 8 at 12 chars, narrow: d_cap 16, wide: full width).

The program reaches its hand-written kernels' dispatchers
(``gather_block``, ``coverage_pair_block``, ``coverage_cascade``) once per
block; on
the CPU those take the plain versions, so every comparison here holds the
plain versions to the reference (tests/test_torch_cascade.py and
tests/test_torch_editdistance.py hold the kernels' code to the plain
versions).

Held exactly: tiebreaker, word hits and LCS (every integer output) and all
edit distances. The f32 fusion score may differ by 1 ulp on a few rows:
XLA's CPU backend contracts multiply-adds of the fusion arithmetic into
FMAs, while the port rounds every operation (the host oracle's
semantics); the test bounds the difference at 1 ulp.
"""

import random
import string

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests import test_coverage_kernel as T
from tests import test_editdistance_device as E
from infidex_tpu.coverage.engine import CoverageEngine
from infidex_tpu.coverage.setup import CoverageSetup
from infidex_tpu.index.vector_model import DocumentMetadata
from infidex_tpu.ops import coverage_kernel as ref
from infidex_tpu.ops import editdistance_multi as ref_ed
from infidex_tpu.utils.metrics import lcs as lcs_host
from infidex_tpu_torch import convert, runtime
from infidex_tpu_torch.ops import _kernels
from infidex_tpu_torch.ops import coverage_kernel as port
from infidex_tpu_torch.ops import editdistance_multi as port_ed

runtime.set_device("cpu")
# the suite runs in several worker processes on shared cores; one intra-op
# thread each keeps torch from oversubscribing them
torch.set_num_threads(1)

BUCKETS = {"small": (ref.D_CAP_SMALL, ref.L_CAP_SMALL),
           "narrow": (ref.D_CAP_NARROW, None), "wide": (0, None)}


def _tables(j):
    return (j.word_chars, j.word_chars_rev, j.word_lens, j.doc_tokens,
            j.doc_tok_offsets, j.doc_tok_count, j.doc_adj_ws, j.doc_text_len)


def _setup(seed, n_docs=30, n_queries=8, first_queries=()):
    rng = random.Random(seed)
    tok = T.make_tokenizer()
    setup = CoverageSetup.create_default()
    eng = CoverageEngine(tok, setup)
    texts = T.make_corpus(rng, n_docs)
    lower = [t.lower() for t in texts]
    eng.set_word_idf_cache({w: round(rng.uniform(0.1, 3.0), 3)
                            for w in T.WORDS})
    delims = tok.tokenizer_setup.delimiter_set
    meta = []
    for t in lower:
        toks = T._split(t, delims)
        meta.append(DocumentMetadata(toks[0] if toks else "", len(toks)))
    eng.set_document_metadata_cache(meta)
    encs = [e for e in (T._encode_query(eng, q.lower(), delims)
                        for q in T.make_queries(rng, 2 * n_queries)) if e]
    encs = [T._encode_query(eng, q, delims) for q in first_queries] + encs
    # a fixed batch width keeps one compiled reference program per bucket
    encs = (encs * n_queries)[:n_queries]
    jt = ref.CoverageTables.build(lower, delims)
    return rng, setup, lower, encs, jt, convert.coverage_tables_from_reference(jt)


def _args(rng, encs, n_docs, l_cap):
    B = len(encs)
    text_ids = np.tile(np.arange(n_docs, dtype=np.int32), B)
    qsel = np.repeat(np.arange(B), n_docs).astype(np.int32)
    perm = np.random.RandomState(rng.randrange(1 << 30)).permutation(qsel.size)
    lcs = np.array([rng.randrange(0, 6) for _ in qsel], np.float32)
    base = np.array([rng.random() for _ in qsel], np.float32)
    stk = lambda k: np.stack([e[k] for e in encs])
    chars = (lambda a: a[:, :, :l_cap]) if l_cap else (lambda a: a)
    vec = lambda k, dt: np.array([e[k] for e in encs], dt)
    return (text_ids[perm], qsel[perm], chars(stk("q_chars")),
            chars(stk("q_rev")), stk("q_lens"), stk("q_idf"), stk("q_widf"),
            vec("q_count", np.int32), stk("q_sorted"), chars(stk("fq_chars")),
            chars(stk("fq_rev")), stk("fq_lens"), vec("fq_count", np.int32),
            vec("last_alpha", np.bool_), lcs[perm], base[perm],
            vec("query_len", np.int32))


def _lcs_args(rng, B):
    qs = [ref.encode_query_lcs(" ".join(rng.sample(T.WORDS, 2)))
          for _ in range(B)]
    return (np.stack([q[0] for q in qs]), np.array([q[1] for q in qs],
                                                   np.int32),
            np.array([rng.randrange(0, 3) for _ in qs], np.int32),
            np.array([q[2] for q in qs]))


def _assert_close(a, b, rows_ok):
    """Integer rows exact; score row within 1 ulp (see module doc)."""
    a, b = np.asarray(a)[:, rows_ok], np.asarray(b)[:, rows_ok]
    for r in range(1, a.shape[0]):
        assert np.array_equal(a[r], b[r]), r
    ulps = np.abs(a[0].view(np.int32).astype(np.int64)
                  - b[0].view(np.int32).astype(np.int64))
    assert ulps.max(initial=0) <= 1


#: the serving layout (device LCS, [2, C]) in every bucket, and the
#: 3-row layout once
CASES = [(b, True) for b in sorted(BUCKETS)] + [("wide", False)]


@pytest.mark.parametrize("seed", [1, 2, 3])
@pytest.mark.parametrize("bucket,with_lcs", CASES)
def test_coverage_fusion_batch_matches_reference(seed, bucket, with_lcs):
    rng, setup, lower, encs, jt, pt = _setup(
        seed, n_queries=4 if bucket == "wide" else 8)
    d_cap, l_cap = BUCKETS[bucket]
    config = ref.CoverageConfig.from_setup(setup)._replace(d_cap=d_cap)
    args = _args(rng, encs, len(lower), l_cap)
    extra_j = extra_p = ()
    if with_lcs:
        la = _lcs_args(rng, len(encs))
        extra_j = (jt.text_chars, jt.lcs_ok) + la
        extra_p = (pt.text_chars, pt.lcs_ok) + la
    want = ref.coverage_fusion_batch(*_tables(jt), *args, *extra_j,
                                     config=config)
    got = port.coverage_fusion_batch(*_tables(pt), *args, *extra_p,
                                     config=config)
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    _assert_close(want, got.numpy(), ~jt.overflow[args[0]])


#: words of 13-24 chars, which an L-12 block holds only in part
LONG_WORDS = ["thirteenchars", "redemptionshawshank", "abcdefghijklmnopqrstuvwx"]


@pytest.mark.parametrize("seed", [1, 2])
@pytest.mark.parametrize("bucket", ["small", "narrow"])
def test_coverage_fusion_batch_matches_reference_on_edge_inputs(seed, bucket):
    """The edges of the coverage block's gather, in both packages from the
    same numpy inputs: docs of up to 12 tokens (more than the small
    block's 8), words of 13-24 chars (an L-12 block reads their first 12),
    and codes of -1 inside a doc's token count (tokens without a word),
    set in both packages' doc tables alike."""
    rng, setup, lower, encs, jt, pt = _setup(
        seed, first_queries=("redemptionshawshank star", "thirteenchar"))
    rng_docs = random.Random(seed)
    texts = [" ".join(rng_docs.choice(T.WORDS + LONG_WORDS)
                      for _ in range(rng_docs.randint(1, 12)))
             for _ in range(40)]
    lower = [t.lower() for t in texts]
    delims = T.make_tokenizer().tokenizer_setup.delimiter_set
    jt = ref.CoverageTables.build(lower, delims)
    pt = convert.coverage_tables_from_reference(jt)
    tokens = np.asarray(jt.doc_tokens).copy()
    count = np.asarray(jt.doc_tok_count)
    for n in range(0, len(lower), 3):          # a token without a word
        if count[n] > 1:
            tokens[n, rng_docs.randrange(count[n])] = -1
    jt_tables = list(_tables(jt))
    pt_tables = list(_tables(pt))
    jt_tables[3] = jnp.asarray(tokens)
    pt_tables[3] = torch.from_numpy(tokens)
    d_cap, l_cap = BUCKETS[bucket]
    config = ref.CoverageConfig.from_setup(setup)._replace(d_cap=d_cap)
    args = _args(rng, encs, len(lower), l_cap)
    la = _lcs_args(rng, len(encs))
    want = ref.coverage_fusion_batch(*jt_tables, *args, jt.text_chars,
                                     jt.lcs_ok, *la, config=config)
    got = port.coverage_fusion_batch(*pt_tables, *args, pt.text_chars,
                                     pt.lcs_ok, *la, config=config)
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    _assert_close(want, got.numpy(), ~jt.overflow[args[0]])
    # the inputs hold what they are meant to
    assert (count > 8).any() and (count < 8).any()
    assert (np.asarray(jt.word_lens) > 12).any()
    inside = np.arange(tokens.shape[1])[None] < count[:, None]
    assert ((tokens < 0) & inside).any()
    assert (np.asarray(got[1]) > 0).any()        # word hits


#: settings other than the default that the matcher cascade branches on
VARIANTS = {
    "one_typo": dict(num_typos=1),
    "no_typos": dict(num_typos=0),
    "long_words_only": dict(min_word_size=3, levenshtein_max_word_size=6,
                            min_length_one_typo=4, min_length_two_typos=6),
    "no_whole_no_joined": dict(cover_whole_words=False,
                               cover_joined_words=False),
    "no_prefix_no_fuzzy": dict(cover_prefix_suffix=False,
                               cover_fuzzy_words=False),
    "min_word_size_0": dict(min_word_size=0),
}


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_coverage_fusion_batch_matches_reference_under_other_settings(variant):
    """The cascade's branches on the typo budget, the matcher flags and the
    word-size limits, held to the reference in the small bucket (the plain
    cascade is what tests/test_torch_cascade.py holds the kernel's code
    to, under these same settings)."""
    rng, setup, lower, encs, jt, pt = _setup(
        1, first_queries=("shewshenk", "star novimbar"))   # two typos each
    d_cap, l_cap = BUCKETS["small"]
    default = ref.CoverageConfig.from_setup(setup)._replace(d_cap=d_cap)
    config = default._replace(**VARIANTS[variant])
    args = _args(rng, encs, len(lower), l_cap)
    la = _lcs_args(rng, len(encs))
    want = ref.coverage_fusion_batch(*_tables(jt), *args, jt.text_chars,
                                     jt.lcs_ok, *la, config=config)
    got = port.coverage_fusion_batch(*_tables(pt), *args, pt.text_chars,
                                     pt.lcs_ok, *la, config=config)
    ok = ~jt.overflow[args[0]]
    _assert_close(want, got.numpy(), ok)
    # the setting changes what these inputs give: its branch was taken
    usual = port.coverage_fusion_batch(*_tables(pt), *args, pt.text_chars,
                                       pt.lcs_ok, *la, config=default)
    assert not torch.equal(got[:, ok], usual[:, ok])


def test_multi_query_batch_equals_single_calls():
    rng, setup, lower, encs, jt, pt = _setup(7, n_docs=24)
    config = ref.CoverageConfig.from_setup(setup)._replace(
        d_cap=ref.D_CAP_NARROW)
    args = _args(rng, encs, len(lower), None)
    batched = port.coverage_fusion_batch(*_tables(pt), *args,
                                         config=config).numpy()
    text_ids, qsel = args[0], args[1]
    for b in range(len(encs)):
        rows = np.flatnonzero(qsel == b)
        single = list(args)
        single[0], single[1] = text_ids[rows], np.zeros(rows.size, np.int32)
        for i in range(2, 15):
            if i not in (13,):
                single[i] = args[i][b:b + 1]
        single[13] = args[13][b:b + 1]
        single[14], single[15] = args[14][rows], args[15][rows]
        single[16] = args[16][b:b + 1]
        one = port.coverage_fusion_batch(*_tables(pt), *single,
                                         config=config).numpy()
        assert np.array_equal(one, batched[:, rows])


def test_row_blocks_do_not_change_results(monkeypatch):
    rng, setup, lower, encs, jt, pt = _setup(2)
    config = ref.CoverageConfig.from_setup(setup)._replace(
        d_cap=ref.D_CAP_SMALL)
    args = _args(rng, encs, len(lower), ref.L_CAP_SMALL)
    la = _lcs_args(rng, len(encs))
    full = port.coverage_fusion_batch(*_tables(pt), *args, pt.text_chars,
                                      pt.lcs_ok, *la, config=config)
    monkeypatch.setattr(port, "ROW_BLOCK", 37)
    blocked = port.coverage_fusion_batch(*_tables(pt), *args, pt.text_chars,
                                         pt.lcs_ok, *la, config=config)
    assert torch.equal(full, blocked)


@pytest.mark.parametrize("bucket", sorted(BUCKETS))
def test_block_goes_through_the_kernels_dispatchers(monkeypatch, bucket):
    """Per row block: one gather call, then one pair-block call (the
    coverage query tokens' words with distances and the fusion query
    tokens' without, the plain version called once for each on the CPU),
    one cascade call over the first set of words; the eager gather, the
    relations and the eager cascade are reached through the plain
    versions only."""
    rng, setup, lower, encs, jt, pt = _setup(5)
    d_cap, l_cap = BUCKETS[bucket]
    config = ref.CoverageConfig.from_setup(setup)._replace(d_cap=d_cap)
    args = _args(rng, encs, len(lower), l_cap)
    want = port.coverage_fusion_batch(*_tables(pt), *args, config=config)
    calls = []
    pair_block, cascade = port.coverage_pair_block, port.coverage_cascade
    plain_pairs = port.coverage_pairs_plain
    gather, plain_gather = port.gather_block, port.gather_block_plain

    def gather_spy(*a):
        out = gather(*a)
        calls.append(("gather", out))
        return out

    def plain_gather_spy(*a):
        calls.append(("plain gather",))
        return plain_gather(*a)

    def pair_block_spy(*a):
        out = pair_block(*a)
        calls.append(("pair block", out))
        return out

    def cascade_spy(*a):
        calls.append(("cascade", a[0], a[-1], a[1]))
        return cascade(*a)

    def plain_pairs_spy(*a):
        calls.append(("plain pairs", a[-1]))
        return plain_pairs(*a)

    monkeypatch.setattr(port, "coverage_pair_block", pair_block_spy)
    monkeypatch.setattr(port, "coverage_cascade", cascade_spy)
    monkeypatch.setattr(port, "coverage_pairs_plain", plain_pairs_spy)
    monkeypatch.setattr(port, "gather_block", gather_spy)
    monkeypatch.setattr(port, "gather_block_plain", plain_gather_spy)
    monkeypatch.setattr(port, "ROW_BLOCK", 100)
    n_blocks = -(-args[0].size // 100)
    got = port.coverage_fusion_batch(*_tables(pt), *args, config=config)
    assert torch.equal(got, want)
    # the spied dispatchers are the only callers of the plain versions here
    assert [c[0] for c in calls] == ["plain gather", "gather", "plain pairs",
                                     "plain pairs", "pair block",
                                     "cascade"] * n_blocks
    for i in range(0, len(calls), 6):
        (_, (_, g), (_, with_dist), (_, f_dist), (_, (words, f_words)),
         (_, seen, cfg, lens)) = calls[i:i + 6]
        assert isinstance(g, port.GatheredBlock) and lens is g.lens
        assert with_dist is True and f_dist is False
        assert seen is words and cfg == config
        assert words.dtype == torch.int32 and (words >> 16).any()
        assert f_words.dtype == torch.int32 and not (f_words >> 16).any()
    assert all(n == 0 for n in _kernels.launch_counts.values())


def test_pair_words_round_trip():
    """``pack_pairs`` / ``unpack_relations`` / ``unpack_distances`` are
    inverse on every field's whole range."""
    g = torch.Generator().manual_seed(3)
    shape = (4, 8, 50)
    rels = tuple(torch.randint(0, 2, shape, generator=g).bool()
                 for _ in range(6))
    prefix = torch.randint(0, 25, shape, generator=g, dtype=torch.int32)
    dists = tuple(torch.randint(0, 5, shape, generator=g, dtype=torch.int32)
                  for _ in range(5))
    words = port.pack_pairs(rels, prefix, dists)
    assert words.dtype == torch.int32 and (words >= 0).all()
    *got_rels, got_prefix = port.unpack_relations(words)
    assert all(torch.equal(a, b) for a, b in zip(got_rels, rels))
    assert torch.equal(got_prefix, prefix)
    assert all(torch.equal(a, b)
               for a, b in zip(port_ed.unpack_distances(words), dists))
    bare = port.pack_pairs(rels, prefix)
    assert torch.equal(bare, words & 0xFFFF)


@pytest.mark.gpu
@pytest.mark.parametrize("bucket,with_lcs", CASES)
def test_cuda_program_equals_cpu_program(bucket, with_lcs):
    """The whole program on the card (gather, pair and cascade kernels)
    against the CPU (plain versions): bit-identical, one gather, one
    cascade and one pair launch per row block."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    rng, setup, lower, encs, jt, pt = _setup(
        4, n_queries=4 if bucket == "wide" else 8)
    d_cap, l_cap = BUCKETS[bucket]
    config = ref.CoverageConfig.from_setup(setup)._replace(d_cap=d_cap)
    args = _args(rng, encs, len(lower), l_cap)
    extra = ()
    if with_lcs:
        extra = (pt.text_chars, pt.lcs_ok) + _lcs_args(rng, len(encs))
    want = port.coverage_fusion_batch(*_tables(pt), *args, *extra,
                                      config=config)
    on_card = [t.cuda() if isinstance(t, torch.Tensor) else t
               for t in _tables(pt) + args + extra]
    _kernels.reset_launch_counts()
    got = port.coverage_fusion_batch(*on_card, config=config)
    assert got.is_cuda and torch.equal(got.cpu().view(torch.int32),
                                       want.view(torch.int32))
    assert _kernels.launch_counts["coverage_gather"] == 1
    assert _kernels.launch_counts["coverage_cascade"] == 1
    assert _kernels.launch_counts["coverage_pairs"] == 1


def test_tables_match_reference_tables():
    _, _, lower, _, jt, _ = _setup(3)
    pt = port.CoverageTables.build(lower, T.make_tokenizer()
                                   .tokenizer_setup.delimiter_set)
    for name in ("word_chars", "word_chars_rev", "word_lens", "doc_tokens",
                 "doc_tok_offsets", "doc_tok_count", "doc_adj_ws",
                 "doc_text_len", "text_chars", "lcs_ok"):
        assert np.array_equal(getattr(pt, name).numpy(),
                              np.asarray(getattr(jt, name))), name
    for name in ("overflow", "tok_count_host", "max_wlen_host",
                 "lcs_ok_host"):
        assert np.array_equal(getattr(pt, name), getattr(jt, name)), name
    assert (pt.n_docs, pt.n_words) == (jt.n_docs, jt.n_words)
    # an append writes the reference's rows (tests/test_torch_append.py
    # holds every table after several appends)
    start = jt.n_docs
    assert jt.append_texts(["new doc"], {" "}, start)
    assert pt.append_texts(["new doc"], {" "}, start)
    assert np.array_equal(pt.doc_tokens.numpy(), np.asarray(jt.doc_tokens))
    assert (pt.n_docs, pt.n_words) == (jt.n_docs, jt.n_words)


def test_device_lcs_matches_host_lcs():
    """tests/test_device_lcs.py's random strings through the whole
    program: the packed LCS byte equals utils/metrics.lcs on eligible
    (doc, query) pairs, and the reference's byte everywhere."""
    rng = random.Random(7)
    alpha = string.ascii_lowercase[:6] + " "
    texts = ["".join(rng.choice(alpha) for _ in range(rng.randrange(1, 40)))
             for _ in range(28)]
    texts += ["dark knight rises", "zelena skola", "abc", ""]
    queries = ["dark", "dark kni", "zelena", "ab", "q",
               "".join(rng.choice(alpha) for _ in range(5)), "knight",
               "zelena sk", "abc d"]
    jt = ref.CoverageTables.build(texts, {" "})
    pt = convert.coverage_tables_from_reference(jt)
    tok = T.make_tokenizer()
    eng = CoverageEngine(tok, CoverageSetup.create_default())
    queries = [q for q in queries if T._encode_query(eng, q, {" "})][:8]
    encs = [T._encode_query(eng, q, {" "}) for q in queries]
    assert len(encs) == 8
    config = ref.CoverageConfig.from_setup(CoverageSetup.create_default())
    for tol in (0, 1, 2):
        args = list(_args(rng, encs, len(texts), None))
        args[14] = np.zeros_like(args[14])      # host LCS 0: device fills
        qa = [ref.encode_query_lcs(q) for q in queries]
        la = (np.stack([q[0] for q in qa]),
              np.array([q[1] for q in qa], np.int32),
              np.full(len(qa), tol, np.int32), np.array([q[2] for q in qa]))
        want = np.asarray(ref.coverage_fusion_batch(
            *_tables(jt), *args, jt.text_chars, jt.lcs_ok, *la,
            config=config))
        got = port.coverage_fusion_batch(*_tables(pt), *args, pt.text_chars,
                                         pt.lcs_ok, *la, config=config).numpy()
        ok = ~jt.overflow[args[0]]
        _assert_close(want, got, ok)
        lcs_byte = got[1].astype(np.int64) & 255
        for r, (d, q) in enumerate(zip(args[0], args[1])):
            if jt.lcs_ok_host[d] and qa[q][2]:
                assert lcs_byte[r] == min(lcs_host(queries[q], texts[d], tol),
                                          255)


@pytest.mark.parametrize("budget", [1, 2, 3])
def test_lev_multi_matches_reference(budget):
    rng = random.Random(10 + budget)
    C, D, Q = 3, 8, 5
    qs = [E.rand_word(rng, 1, 8) for _ in range(Q)]
    words = [E.rand_word(rng) for _ in range(C * D)]
    chars, lens = E.encode(words, C, D)
    q_chars, q_lens = E.encode_q(qs, Q)
    d_chars = chars.transpose(2, 1, 0)
    want = np.asarray(ref_ed.batched_lev_multi(
        q_chars, q_lens, d_chars, lens.T, budget=budget, l_max=E.L))
    got = port_ed.batched_lev_multi(
        torch.from_numpy(q_chars), torch.from_numpy(q_lens),
        torch.from_numpy(np.ascontiguousarray(d_chars)),
        torch.from_numpy(np.ascontiguousarray(lens.T)),
        budget=budget, l_max=E.L)
    assert np.array_equal(got.numpy(), want)
    it = 0
    for c in range(C):
        for d in range(D):
            w = words[it]
            it += 1
            for qi, q in enumerate(qs):
                assert got[qi, d, c] == min(E.levenshtein(q, w), budget + 1)


@pytest.mark.parametrize("max_distance", [1, 2])
def test_damerau_multi_matches_reference(max_distance):
    rng = random.Random(30 + max_distance)
    C, D, Q = 3, 12, 4
    for _ in range(4):
        qs = [E.rand_word(rng, 2, 8) for _ in range(Q)]
        words = []
        for _ in range(C * D):
            w = list(rng.choice(qs))
            if len(w) >= 2 and rng.random() < 0.5:
                i = rng.randrange(len(w) - 1)
                w[i], w[i + 1] = w[i + 1], w[i]
            elif rng.random() < 0.5:
                w[rng.randrange(len(w))] = rng.choice(E.ALPHABET)
            words.append("".join(w))
        chars, lens = E.encode(words, C, D)
        chars_rev, _ = E.encode([w[::-1] for w in words], C, D)
        q_chars, q_lens = E.encode_q(qs, Q)
        q_rev, _ = E.encode_q([q[::-1] for q in qs], Q)
        a = (q_chars, q_lens, chars.transpose(2, 1, 0), lens.T, q_rev,
             chars_rev.transpose(2, 1, 0))
        want = np.asarray(ref_ed.batched_damerau_multi(
            *a, max_distance=max_distance, l_max=E.L))
        got = port_ed.batched_damerau_multi(
            *(torch.from_numpy(np.ascontiguousarray(x)) for x in a),
            max_distance=max_distance, l_max=E.L)
        assert np.array_equal(got.numpy(), want)
