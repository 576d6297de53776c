"""The scorer + fusion program of the port
(infidex_tpu_torch/ops/coverage_kernel.py ``coverage_fusion``).

* the CUDA kernel's per-candidate code (csrc/coverage_fusion_cell.cuh, the
  header csrc/coverage_fusion.cu includes), compiled for the host with g++
  -ffp-contract=off and run as the kernel runs it (each tile of 8
  candidates copied into a scratch, then a group of min(D, 32) lanes per
  candidate, which csrc/lane_group.cuh runs as a loop over its lanes on the
  host), against the plain PyTorch version ``coverage_fusion_plain``: both
  rows of both layouts ([2, C] with the packed LCS, [3, C] without) equal
  bit for bit (tolerance 0), and every fusion signal equal to the plain
  ``_fusion_signals``; at every group width with docs of no tokens and of
  D tokens;
* hand-made candidates for the edge cases: no, one and several fusion
  tokens, no doc tokens, an empty query word, no idf, an empty text, each
  signal on its own, and query-token sums whose last bit depends on their
  order;
* a reach test: on the seeded inputs every fusion signal and every
  precedence bit is set on some candidate and clear on another;
* on a card, the kernel against the plain version: the same.

The plain version is held to the JAX program as a whole by
tests/test_torch_coverage_kernel.py. Inputs are made with numpy from a
seed, at the coverage program's three shape classes with 4 and with 16
query tokens: the doc and coverage query words of tests/test_torch_cascade.py
(five-letter alphabet; copies, edits, prefixes, suffixes, joins, splits),
fusion words derived from them (the same words, one of them, a trailing
letter or short prefix, stems, a contained word and the next word's first
letter, the doc's own words, none), random idfs (some 0), host LCS values,
base scores, adjacency and text lengths; the cascade's state and the pair
words come from the plain versions.
"""

import ctypes

import numpy as np
import pytest
import torch

from tests import test_torch_cascade as TC
from tests.test_torch_coverage_lcs import compile_cell
from infidex_tpu_torch import runtime
from infidex_tpu_torch.ops import _kernels
from infidex_tpu_torch.ops import coverage_kernel as ck

runtime.set_device("cpu")
# the suite runs in several worker processes on shared cores; one intra-op
# thread each keeps torch from oversubscribing them
torch.set_num_threads(1)

#: (Q, FQ, L, D): the small, narrow and wide classes, each with 4 and with
#: 16 query tokens
SHAPES = {f"{cls}_q{q}": (q, q, L, D)
          for cls, (L, D) in (("small", (12, 8)), ("narrow", (24, 16)),
                              ("wide", (24, 64)))
          for q in (4, 16)}
BASE = ck.CoverageConfig()
CONFIGS = dict(TC.CONFIGS, no_whole_query=BASE._replace(
    cover_whole_query=False))
SIGNALS = ("lexical_prefix_last", "is_perfect_doc", "has_stem_evidence",
           "has_anchor_stem", "trailing_density", "single_sim",
           "single_char_boost")
C = 64


class Block:
    """One coverage block's inputs of ``coverage_fusion`` (CPU tensors),
    and the cascade's arguments they came from."""

    def __init__(self, a, fq_words, rng, config, text_len=None,
                 q_idf=None, lcs=None, base=None, last_alpha=None,
                 adj_ws=None):
        Q, L, n_c = a["qc"].shape
        D = a["dl"].shape[0]
        FQ = a["fq_width"]
        t = lambda x: torch.from_numpy(np.array(x))
        args = TC.cascade_args({k: a[k] for k in (
            "qc", "qr", "ql", "qsorted", "qcount", "dc", "dr", "dl", "codes",
            "offsets", "tok_count")})
        pairs, lens, offsets, codes, first_char, tok_count = args[:6]
        valid = (codes >= 0) & (torch.arange(D)[:, None] < tok_count[None])
        chars_t = torch.where(valid[None], t(a["dc"]), 0).contiguous()
        chars_rev_t = torch.where(valid[None], t(a["dr"]), 0).contiguous()
        self.state = ck.coverage_cascade_plain(*args, config)
        self.pairs = pairs
        # the per-query tables: candidate c's query is row qsel[c]
        perm = rng.permutation(n_c)
        self.qsel = t(perm)
        fqc = np.zeros((n_c, FQ, L), np.int32)
        fqr = np.zeros((n_c, FQ, L), np.int32)
        fql = np.zeros((n_c, FQ), np.int32)
        fqn = np.zeros(n_c, np.int32)
        alpha = np.zeros(n_c, bool)
        qlen = np.zeros(n_c, np.int32)
        for c, words in enumerate(fq_words):
            b = perm[c]
            words = [w[:L] for w in words[:FQ]]
            fqn[b] = len(words)
            for f, w in enumerate(words):
                fql[b, f] = len(w)
                fqc[b, f, :len(w)] = w
                fqr[b, f, :len(w)] = w[::-1]
            alpha[b] = bool(words) and len(words[-1]) == 1
            qlen[b] = sum(len(w) for w in words) + max(len(words) - 1, 0)
        if last_alpha is not None:
            alpha[perm] = last_alpha
        if rng.integers(4) == 0:
            qlen[rng.integers(n_c)] = 0
        inv = np.argsort(perm)      # row b -> its candidate
        by_row = lambda x: np.ascontiguousarray(np.moveaxis(x, -1, 0)[inv])
        if q_idf is None:
            q_idf = np.round(rng.uniform(0.1, 3.0, (n_c, Q)), 3)
            q_idf[rng.random((n_c, Q)) < 0.1] = 0.0
        else:
            q_idf = np.broadcast_to(np.asarray(q_idf), (n_c, Q))[inv]
        q_widf = np.round(rng.uniform(0.0, 3.0, (n_c, Q)), 3)
        q_widf[rng.random((n_c, Q)) < 0.1] = 0.0
        self.queries = (t(by_row(a["ql"])), t(q_idf.astype(np.float32)),
                        t(q_widf.astype(np.float32)), t(a["qcount"][inv]),
                        t(fqc), t(fqr), t(fql), t(fqn), t(alpha), t(qlen))
        ends = np.where(a["tok_count"] > 0,
                        a["offsets"].max(axis=0) + a["dl"].max(axis=0), 0)
        text_len = ends if text_len is None else np.broadcast_to(
            np.asarray(text_len, np.int32), (n_c,))
        if adj_ws is None:
            adj_ws = rng.random((D, n_c)) < 0.8
        self.doc = (chars_t, chars_rev_t, lens, t(np.broadcast_to(
            np.asarray(adj_ws, bool), (D, n_c))), valid, tok_count,
            t(text_len.astype(np.int32)))
        # the fusion tokens' relations, as _coverage_block computes them
        sel = self.qsel.long()
        self.fq_pairs = ck.coverage_pairs_plain(
            self.queries[4][sel].permute(1, 2, 0).contiguous(),
            self.queries[5][sel].permute(1, 2, 0).contiguous(),
            self.queries[6][sel].T.contiguous(), chars_t, chars_rev_t, lens,
            valid, False)
        self.lcs = t(np.broadcast_to(np.asarray(
            rng.integers(0, 9, n_c) if lcs is None else lcs, np.float32),
            (n_c,)).copy())
        self.base = t(np.broadcast_to(np.asarray(
            rng.random(n_c) if base is None else base, np.float32),
            (n_c,)).copy())
        self.config = config

    def args(self, packed_lcs):
        return (self.state, self.pairs, self.fq_pairs, self.doc, self.queries,
                self.qsel, self.lcs, self.base, self.config, packed_lcs)

    def plain(self, packed_lcs):
        return ck.coverage_fusion_plain(*self.args(packed_lcs))

    def plain_signals(self):
        """``_fusion_signals`` of the plain version, as in
        ``coverage_fusion_plain``."""
        sel = self.qsel.long()
        q = self.queries
        chars_t, chars_rev_t, lens, adj_ws, valid, tok_count, _ = self.doc
        L, D, n_c = chars_t.shape
        sig = ck._fusion_signals(
            q[4][sel].permute(1, 2, 0).contiguous(),
            q[5][sel].permute(1, 2, 0).contiguous(), q[6][sel].T.contiguous(),
            q[7][sel], q[8][sel], self.fq_pairs,
            (self.pairs[0] >> _kernels.PAIR_DIST_SHIFTS[1]) & 7, chars_t,
            chars_rev_t, lens, adj_ws, valid, tok_count, n_c, D, L,
            q[4].shape[1], self.config)
        return torch.stack([sig[k].to(torch.int32) for k in SIGNALS])


def _fusion_words(rng, qwords, dwords, L):
    """The fusion (unfiltered) query tokens of one candidate."""
    kind = rng.integers(9)
    letter = lambda: [int(97 + rng.integers(5))]
    if kind == 0 or (not dwords and kind >= 2):
        return list(qwords)
    if kind == 1:                                         # one token
        return list(qwords[:1]) or [TC._word(rng, 3, 8)]
    if kind == 2:                                         # a trailing letter
        return list(qwords) + [[dwords[rng.integers(len(dwords))][0]]]
    if kind == 3:                                         # the doc's words
        words = [list(w) for w in dwords]
        if rng.integers(2):
            words[-1] = words[-1][:int(rng.integers(1, 3))]
        return words
    if kind == 4:                                         # stems
        return [w[:max(2, len(w) - 2)] + TC._word(rng, 1, 3) for w in qwords]
    if kind == 5:                                         # no tokens
        return []
    if kind == 6:                                         # a short last word
        words = list(qwords) or [TC._word(rng, 3, 8)]
        return words + [dwords[rng.integers(len(dwords))][:int(
            rng.integers(1, 3))]]
    if kind == 7 and len(dwords) >= 2:   # contained words, the next's letter
        j = int(rng.integers(len(dwords) - 1))
        w = dwords[j]
        i = int(rng.integers(len(w)))
        return [w[i:i + int(rng.integers(1, len(w) - i + 1))],
                [dwords[j + 1][0]]]
    return list(qwords) + [letter()]


def _set_query(a, c, words):
    """Candidate c's coverage query tokens become ``words``."""
    for k in ("qc", "qr", "ql"):
        a[k][..., c] = 0
    for q, w in enumerate(words):
        a["ql"][q, c] = len(w)
        a["qc"][q, :len(w), c] = w
        a["qr"][q, :len(w), c] = w[::-1]
    a["qcount"][c] = len(words)
    a["qsorted"][:, c] = len(words)
    a["qsorted"][:len(words), c] = sorted(range(len(words)),
                                          key=lambda i: -len(words[i]))


def _extreme_docs(a, rng, L, D):
    """Every third candidate loses its doc tokens (tok_count 0) and every
    third gets all D, its query words taken from its last six tokens: at D
    64, tokens that a group's lanes reach in their second round."""
    Q, n_c = a["ql"].shape
    vocab, base = {}, int(a["codes"].max()) + 1
    for c in range(n_c):
        if c % 3 == 2:
            continue
        for k in ("dc", "dr"):
            a[k][..., c] = 0
        a["dl"][:, c] = 0
        a["codes"][:, c] = -1
        a["offsets"][:, c] = 0
        a["tok_count"][c] = 0
        if c % 3 == 0:
            continue
        words = [TC._word(rng, 1, min(L, 9)) for _ in range(D)]
        pos = 0
        for d, w in enumerate(words):
            a["offsets"][d, c] = pos
            pos += len(w) + 1
            a["codes"][d, c] = vocab.setdefault(tuple(w), base + len(vocab))
            a["dl"][d, c] = len(w)
            a["dc"][:len(w), d, c] = w
            a["dr"][:len(w), d, c] = w[::-1]
        a["tok_count"][c] = D
        tail = np.arange(max(D - 6, 0), D)
        picks = np.sort(rng.choice(tail, int(rng.integers(1, min(Q, 6) + 1)),
                                   replace=False))
        qwords = [list(words[d]) for d in picks]
        if rng.integers(2):
            qwords[-1] = qwords[-1][:max(1, len(qwords[-1]) - 1)]
        _set_query(a, c, qwords)


def make_block(seed, Q, FQ, L, D, config=BASE, n_c=C, extremes=False):
    """A seeded block; with ``extremes``, a third of its candidates without
    doc tokens and a third with all D (``_extreme_docs``)."""
    rng = np.random.default_rng(seed)
    a = TC.make_inputs(seed, Q, L, D, n_c)
    a["fq_width"] = FQ
    if extremes:
        _extreme_docs(a, rng, L, D)
    fq_words = []
    for c in range(n_c):
        qwords = [list(a["qc"][q, :a["ql"][q, c], c])
                  for q in range(a["qcount"][c])]
        dwords = [list(a["dc"][:a["dl"][d, c], d, c])
                  for d in range(a["tok_count"][c]) if a["codes"][d, c] >= 0]
        if dwords and rng.integers(4) == 0:
            # a title typed from its start, the last word maybe cut short
            qwords = [list(w) for w in dwords[:int(rng.integers(
                1, min(len(dwords), Q) + 1))]]
            qwords[-1] = qwords[-1][:max(1, len(qwords[-1])
                                         - int(rng.integers(0, 3)))]
            _set_query(a, c, qwords)
            if rng.integers(2):
                a["offsets"][:, c] -= a["offsets"][0, c]   # from the start
                fq_words.append(qwords)
                continue
        fq_words.append(_fusion_words(rng, qwords, dwords, L))
    return Block(a, fq_words, rng, config)


_HOST_LOOP = r"""
#include <cstring>
#include <vector>
#include "coverage_fusion_cell.cuh"
// The kernel's steps for each tile of candidates: the tile's rows copied
// into a scratch that starts out as 0x7f bytes (a row the copy skipped
// reads as that), then each candidate by a group of G lanes (a loop over
// them), from the tile.
template <int L, int D>
static void run(const fusion::Args& a, int* sig) {
  constexpr int G = D < 32 ? D : 32;
  const fusion::Layout y = fusion::layout<D>(a.n_q, a.n_fq);
  std::vector<int> tile((y.bytes + 3) / 4);
  const grp::Group<G> g;
  for (int c0 = 0; c0 < a.n_c; c0 += fusion::kTile) {
    std::memset(tile.data(), 0x7f, 4 * tile.size());
    fusion::stage<D>(a, c0, 0, 1, tile.data());
    for (int t = 0; t < fusion::kTile && c0 + t < a.n_c; ++t) {
      const fusion::In in = fusion::tile_in<L, D>(a, tile.data(), c0, t);
      const int c = c0 + t;
      fusion::candidate<L, D, G>(g, in, a.cfg, a.packed_lcs != 0, a.out + c,
                                 a.n_c);
      const fusion::Signals s = fusion::fusion_signals<L, D, G>(g, in, a.cfg);
      const int v[7] = {s.lexical_prefix_last, s.perfect_doc,
                        s.stem_evidence, s.anchor_stem, s.trailing_density,
                        s.single_sim, s.single_char_boost};
      for (int k = 0; k < 7; ++k) sig[k * a.n_c + c] = v[k];
    }
  }
}
extern "C" int coverage_fusion_host(
    const float* term_matched, const unsigned char* has_whole,
    const unsigned char* has_joined, const unsigned char* has_prefix,
    const int* first_pos, const int* word_hits, const int* cov_count,
    const int* pairs, const int* fq_pairs, const int* chars,
    const int* chars_rev, const int* lens, const unsigned char* adj_ws,
    const unsigned char* valid, const int* tok_count, const int* text_len,
    const int* q_lens, const float* q_idf, const float* q_widf,
    const int* q_count, const int* fq_chars, const int* fq_rev,
    const int* fq_lens, const int* fq_count, const unsigned char* last_alpha,
    const int* query_len, const long long* qsel, const float* lcs,
    const float* base, int n_q, int n_fq, int n_l, int n_d, int n_c,
    const int* cfg, int packed_lcs, float* out, int* sig) {
  const fusion::Args a = {
      term_matched, has_whole, has_joined, has_prefix, first_pos, word_hits,
      cov_count, pairs, fq_pairs, chars, chars_rev, lens, adj_ws, valid,
      tok_count, text_len, q_lens, q_idf, q_widf, q_count, fq_chars, fq_rev,
      fq_lens, fq_count, last_alpha, query_len, qsel, lcs, base, n_q, n_fq,
      n_c, packed_lcs, {cfg[0], cfg[1]}, out};
  if (n_l == 12 && n_d == 8) run<12, 8>(a, sig);
  else if (n_l == 12 && n_d == 16) run<12, 16>(a, sig);
  else if (n_l == 12 && n_d == 64) run<12, 64>(a, sig);
  else if (n_l == 24 && n_d == 8) run<24, 8>(a, sig);
  else if (n_l == 24 && n_d == 16) run<24, 16>(a, sig);
  else if (n_l == 24 && n_d == 64) run<24, 64>(a, sig);
  else return 1;
  return 0;
}
"""


def kernel_order(blk, packed_lcs):
    """The 29 tensors of ``_kernels.coverage_fusion`` in its order."""
    state, pairs, fq_pairs, doc, q, qsel, lcs, base, _, _ = blk.args(
        packed_lcs)
    return (*state, pairs, fq_pairs, *doc, *q, qsel, lcs, base)


@pytest.fixture(scope="module")
def host_fusion(tmp_path_factory):
    """csrc/coverage_fusion_cell.cuh behind a loop over the candidates, in
    the kernel's own addressing; returns the packed rows and the signals
    [7, C] (in ``SIGNALS`` order)."""
    lib = compile_cell(tmp_path_factory, "fusion_cell", _HOST_LOOP)
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.coverage_fusion_host.argtypes = [p] * 29 + [i] * 5 + [p, i, p, p]
    lib.coverage_fusion_host.restype = i

    def run(blk, packed_lcs):
        *tensors, qsel, lcs, base = kernel_order(blk, packed_lcs)
        # int32 where the cascade kernel's outputs are, the int64 qsel
        arrays = [np.ascontiguousarray(
            x.numpy().astype(np.int32) if x.dtype == torch.int64
            else x.numpy()) for x in tensors] + [
                np.ascontiguousarray(x.numpy()) for x in (qsel, lcs, base)]
        n_q, n_d, n_c = blk.pairs.shape
        n_l = blk.doc[0].shape[0]
        n_fq = blk.queries[6].shape[1]
        cfg = np.array([blk.config.min_word_size,
                        blk.config.cover_whole_query], np.int32)
        out = np.full((2 if packed_lcs else 3, n_c), -7.0, np.float32)
        sig = np.full((len(SIGNALS), n_c), -7, np.int32)
        rc = lib.coverage_fusion_host(
            *(x.ctypes.data for x in arrays), n_q, n_fq, n_l, n_d, n_c,
            cfg.ctypes.data, int(packed_lcs), out.ctypes.data,
            sig.ctypes.data)
        assert rc == 0
        return torch.from_numpy(out), torch.from_numpy(sig)

    return run


def assert_bits_equal(got, want):
    assert got.dtype == want.dtype == torch.float32 and got.shape == want.shape
    bad = (got.view(torch.int32) != want.view(torch.int32)).nonzero()
    assert bad.numel() == 0, [(r, c, float(got[r, c]), float(want[r, c]))
                              for r, c in bad[:4].tolist()]


def _seed(shape, config):
    return 100 * list(SHAPES).index(shape) + list(CONFIGS).index(config)


@pytest.mark.parametrize("packed_lcs", [True, False])
@pytest.mark.parametrize("config", list(CONFIGS))
@pytest.mark.parametrize("shape", list(SHAPES))
def test_fusion_cell_code_equals_the_plain_version(host_fusion, shape,
                                                   config, packed_lcs):
    blk = make_block(_seed(shape, config), *SHAPES[shape],
                     config=CONFIGS[config])
    want = blk.plain(packed_lcs)
    got, sig = host_fusion(blk, packed_lcs)
    assert_bits_equal(got, want)
    assert torch.equal(sig, blk.plain_signals())
    # the dispatcher takes the plain version for CPU tensors
    assert_bits_equal(ck.coverage_fusion(*blk.args(packed_lcs)), want)


@pytest.mark.parametrize("shape", list(SHAPES))
def test_inputs_reach_every_signal_and_precedence_bit(host_fusion, shape):
    """Each fusion signal and each precedence bit of the fusion score
    (1<<17, 1<<16, 1<<15, 1<<14, 1<<13 and 8) is set on some candidate and
    clear on another, with the cell equal to the plain version on all."""
    blk = make_block(_seed(shape, "default") + 7, *SHAPES[shape],
                     n_c=6 * C)
    want = blk.plain(True)
    got, sig = host_fusion(blk, True)
    assert_bits_equal(got, want)
    for name, row in zip(SIGNALS, blk.plain_signals()):
        assert (row > 0).any() and (row == 0).any(), name
    precedence = want[0].floor().to(torch.int64)
    for bit in (17, 16, 15, 14, 13, 3):
        on = (precedence >> bit) & 1
        assert on.any() and not on.all(), bit


@pytest.mark.parametrize("shape", list(SHAPES))
def test_lane_groups_at_token_counts_0_and_d(host_fusion, shape):
    """Each group width (8, 16 and 32 lanes at D 8, 16 and 64) with a third
    of the candidates at tok_count 0 and a third at tok_count D whose query
    words are their last tokens: bit-equal to the plain version, every
    signal equal, and signals set on the full docs."""
    Q, FQ, L, D = SHAPES[shape]
    blk = make_block(_seed(shape, "default") + 31, Q, FQ, L, D, n_c=3 * C,
                     extremes=True)
    tok = blk.doc[5]
    assert (tok == 0).sum() >= C and (tok == D).sum() >= C
    for packed_lcs in (True, False):
        got, sig = host_fusion(blk, packed_lcs)
        assert_bits_equal(got, blk.plain(packed_lcs))
    want_sig = blk.plain_signals()
    assert torch.equal(sig, want_sig)
    full = tok == D
    for name in ("lexical_prefix_last", "has_anchor_stem"):
        assert want_sig[SIGNALS.index(name), full].any(), name
    assert not want_sig[:, tok == 0].any()                 # no doc: none


# --- hand-made candidates -----------------------------------------------------


def _candidate(doc_words, query_words, fusion_words, config=BASE, **kw):
    """One candidate (Q = FQ = 4, L 12, D 8) from words given as strings."""
    a = TC._candidate(doc_words, query_words)
    a["fq_width"] = 4
    words = [list(w.encode()) for w in fusion_words]
    return Block(a, [words], np.random.default_rng(0), config, **kw)


KNOWN = {
    # no fusion tokens: no signal (the tiebreaker counts the query tokens)
    "fq_count_0": (["alpha", "beta"], ["alpha", "beta"], [], {}, {}),
    # one fusion token: a prefix of a doc word, whose similarity is 1
    "fq_count_1": (["shawshank", "redemption"], ["shaw"], ["shaw"], {},
                   dict(lexical_prefix_last=1, has_anchor_stem=1,
                        single_sim=255)),
    "fq_count_2": (["alpha", "beta", "gamma"], ["alpha", "gam"],
                   ["alpha", "gam"], {}, dict(lexical_prefix_last=1,
                                              has_anchor_stem=1)),
    "tok_count_0": ([], ["alpha"], ["alpha"], {}, {}),
    # an empty token starts every doc word: the doc is "perfect"
    "empty_query_word": (["alpha", "beta"], ["", "alpha"], ["", "alpha"], {},
                         dict(is_perfect_doc=1)),
    "total_idf_0": (["alpha", "beta"], ["alpha", "bet"], ["alpha", "bet"],
                    dict(q_idf=0.0), dict(lexical_prefix_last=1,
                                          is_perfect_doc=1,
                                          has_anchor_stem=1)),
    "text_len_0": (["alpha", "beta"], ["alpha", "beta"], ["alpha", "beta"],
                   dict(text_len=0), dict(lexical_prefix_last=1,
                                          is_perfect_doc=1,
                                          has_anchor_stem=1)),
    # "runner" matches no doc word, and shares a stem with "running"
    "stem_evidence": (["running", "fast"], ["runner", "fast"],
                      ["runner", "fast"], {}, dict(has_stem_evidence=1,
                                                   has_anchor_stem=1)),
    # a one-letter last token: 2 of 3 doc tokens start with it
    "trailing_density": (["star", "wall", "saga"], ["star", "s"],
                         ["star", "s"], {},
                         dict(lexical_prefix_last=1, has_anchor_stem=1,
                              trailing_density=int(np.float32(2) / np.float32(
                                  3) * np.float32(255)))),
    # "york" is in doc token 1, "c" starts the adjacent next token
    "single_char_boost": (["new", "york", "city"], ["york", "c"],
                          ["york", "c"], dict(adj_ws=True),
                          dict(lexical_prefix_last=1, has_anchor_stem=1,
                               trailing_density=85,
                               single_char_boost=8 + 15)),
    "single_char_boost_not_adjacent": (["new", "york", "city"],
                                       ["york", "c"], ["york", "c"],
                                       dict(adj_ws=False),
                                       dict(lexical_prefix_last=1,
                                            has_anchor_stem=1,
                                            trailing_density=85)),
    # a typo in a single-term query: the similarity from its distance
    "single_term_typo": (["shawshank"], ["shawshenk"], ["shawshenk"], {},
                         dict(has_anchor_stem=1,
                              single_sim=int(np.float32(8) / np.float32(9)
                                             * np.float32(255)))),
    # the two-segment heuristic: the query's first and last three letters
    # start and end two different doc words
    "two_segments": (["abcxyz", "qqqdef"], ["abcdef"], ["abcdef"], {},
                     dict(has_anchor_stem=1, single_sim=255)),
}


@pytest.mark.parametrize("case", list(KNOWN))
def test_known_candidates(host_fusion, case):
    docs, queries, fusion, kw, want = KNOWN[case]
    blk = _candidate(docs, queries, fusion, **kw)
    sig = dict(zip(SIGNALS, blk.plain_signals()[:, 0].tolist()))
    for packed_lcs in (True, False):
        got, cell_sig = host_fusion(blk, packed_lcs)
        assert_bits_equal(got, blk.plain(packed_lcs))
        assert cell_sig[:, 0].tolist() == list(sig.values())
    for name in SIGNALS:
        assert sig[name] == want.get(name, 0), (name, sig)
    out = blk.plain(False)
    n_tokens = len(fusion) or len(queries)
    if kw.get("text_len") == 0 or n_tokens < 2:
        assert out[1, 0] == 0                     # no tiebreaker
    assert np.isfinite(out.numpy()).all()


def test_query_token_sums_keep_their_order(host_fusion):
    """One fusion token of two chars and four query tokens, covered
    0, 1, 1 and 1/3 (term_matched 0, 5, 4, 2 of 4, 5, 4, 6 chars), nothing
    strict or prefix: the score is sum_ci / 4 / 2 exactly. Summed from 0 in
    token order, sum_ci is 2.3333333; in reverse order, or as a pairwise
    tree, 2.3333335. The cell's score is the plain version's, the
    in-order one."""
    blk = _candidate(["alphabet", "omega", "beta", "gamma"],
                     ["zzzz", "omega", "beta", "gammaa"], ["om"],
                     q_idf=1.0, base=0.0)
    f32 = np.float32
    tm = torch.tensor([[0.0], [5.0], [4.0], [2.0]])
    flags = torch.zeros((4, 1), dtype=torch.bool)
    state = list(blk.state)
    state[:5] = [tm, flags, flags, flags, torch.full((4, 1), -1, dtype=torch.int32)]
    blk.state = tuple(state)
    ci = [f32(0), f32(1), f32(1), f32(2) / f32(6)]
    in_order = f32(0)
    for x in ci:
        in_order = f32(in_order + x)
    reverse = f32(0)
    for x in ci[::-1]:
        reverse = f32(reverse + x)
    tree = f32(f32(ci[0] + ci[1]) + f32(ci[2] + ci[3]))
    assert in_order != reverse and in_order != tree
    want = blk.plain(True)
    assert want[0, 0].item() == float(in_order / f32(4) / f32(2))
    for packed_lcs in (True, False):
        got, _ = host_fusion(blk, packed_lcs)
        assert_bits_equal(got, blk.plain(packed_lcs))


def test_cpu_tensors_never_reach_the_kernel_wrapper(monkeypatch):
    blk = _candidate(["alpha"], ["alpha"], ["alpha"])
    with pytest.raises(ValueError):
        _kernels.coverage_fusion(*blk.args(True))

    def refuse(*a):
        raise AssertionError("the kernel wrapper was called for CPU tensors")

    monkeypatch.setattr(_kernels, "coverage_fusion", refuse)
    assert_bits_equal(ck.coverage_fusion(*blk.args(True)), blk.plain(True))


@pytest.mark.gpu
@pytest.mark.parametrize("config", list(CONFIGS))
@pytest.mark.parametrize("shape", list(SHAPES))
def test_cuda_kernel_matches_plain_version(shape, config):
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    blk = make_block(2000 + _seed(shape, config), *SHAPES[shape],
                     config=CONFIGS[config], n_c=300)
    for packed_lcs in (True, False):
        want = blk.plain(packed_lcs)
        on_card = [v.cuda() if isinstance(v, torch.Tensor)
                   else tuple(x.cuda() for x in v) if i in (0, 3, 4) else v
                   for i, v in enumerate(blk.args(packed_lcs))]
        # the kernel takes the cascade kernel's int32 cov_count
        on_card[0] = on_card[0][:6] + (on_card[0][6].to(torch.int32),)
        n0 = _kernels.launch_counts["coverage_fusion"]
        got = [ck.coverage_fusion(*on_card) for _ in range(2)]
        torch.cuda.synchronize()
        assert _kernels.launch_counts["coverage_fusion"] == n0 + 2
        for g in got:
            assert_bits_equal(g.cpu(), want)
        # the plain version on the card gives the same bits as on the CPU
        assert_bits_equal(ck.coverage_fusion_plain(*on_card).cpu(), want)
    # a doc-token width the kernel is not built for raises
    with pytest.raises(ValueError):
        bad = list(on_card)
        bad[1] = bad[1][:, :5].contiguous()
        ck.coverage_fusion(*bad)
