"""The Stage-2 matcher cascade of the port
(infidex_tpu_torch/ops/coverage_kernel.py ``coverage_cascade``).

* the CUDA kernel's per-candidate code (csrc/coverage_cascade_cell.cuh, the
  header csrc/coverage_cascade.cu includes), compiled for the host with g++
  and run over every candidate, against the plain PyTorch version
  ``coverage_cascade_plain``: every integer output equal, ``term_matched``
  bit for bit (tolerance 0);
* hand-made candidates for each line of the plain version that is easy to
  get wrong: a miss (index 0 must not leak), an empty query word, the
  padding of the length-sorted order, the two-letter rule, the doc-joined
  pick, the order of the prefix/suffix pick and 0, 1 or 2 typos;
* on a card, the kernel against the plain version: the same.

The plain version is held to the JAX program as a whole by
tests/test_torch_coverage_kernel.py, at the default settings in every shape
class and at each of the other settings below in the small one. Inputs are made with numpy from a
seed: doc words over a five-letter alphabet, query words derived from their
candidate's doc words (copies, edits, prefixes, suffixes, substrings, two
words joined, one word split), at the coverage program's three shape
classes; the pair words come from ``coverage_pairs_plain``.
"""

import ctypes

import numpy as np
import pytest
import torch

from tests.test_torch_coverage_lcs import compile_cell
from infidex_tpu_torch import runtime
from infidex_tpu_torch.ops import _kernels
from infidex_tpu_torch.ops import coverage_kernel as ck

runtime.set_device("cpu")
# the suite runs in several worker processes on shared cores; one intra-op
# thread each keeps torch from oversubscribing them
torch.set_num_threads(1)

#: (Q, L, D) of the coverage program's small, narrow and wide classes
SHAPES = {"small": (4, 12, 8), "narrow": (16, 24, 16), "wide": (16, 24, 64)}
BASE = ck.CoverageConfig()
CONFIGS = {
    "default": BASE,
    "one_typo": BASE._replace(num_typos=1),
    "no_typos": BASE._replace(num_typos=0),
    "long_words_only": BASE._replace(min_word_size=3,
                                     levenshtein_max_word_size=6,
                                     min_length_one_typo=4,
                                     min_length_two_typos=6),
    "no_whole_no_joined": BASE._replace(cover_whole_words=False,
                                        cover_joined_words=False),
    "no_prefix_no_fuzzy": BASE._replace(cover_prefix_suffix=False,
                                        cover_fuzzy_words=False),
    "min_word_size_0": BASE._replace(min_word_size=0),
}
OUT_NAMES = ("term_matched", "term_has_whole", "term_has_joined",
             "term_has_prefix", "term_first_pos", "word_hits", "cov_count")
C = 48


def _word(rng, lo, hi):
    return [int(x) for x in 97 + rng.integers(5, size=rng.integers(lo, hi + 1))]


def _edit(rng, w):
    w = list(w)
    kind = rng.integers(4)
    if kind == 0 and w:
        w[rng.integers(len(w))] = int(97 + rng.integers(5))
    elif kind == 1 and len(w) > 1:
        del w[rng.integers(len(w))]
    elif kind == 2:
        w.insert(rng.integers(len(w) + 1), int(97 + rng.integers(5)))
    elif len(w) >= 2:
        i = rng.integers(len(w) - 1)
        w[i], w[i + 1] = w[i + 1], w[i]
    return w


def _query_words(rng, docs, n, L):
    """``n`` query words derived from the candidate's doc words."""
    out = []
    while len(out) < n:
        kind = rng.integers(12)
        src = docs[rng.integers(len(docs))] if docs else _word(rng, 1, 6)
        if kind == 0:
            w = list(src)                                   # whole word
        elif kind in (1, 2):
            w = _edit(rng, src)                             # one typo
        elif kind == 3:
            w = _edit(rng, _edit(rng, src))                 # two typos
        elif kind == 4:
            w = src[:max(1, len(src) - int(rng.integers(1, 4)))]   # prefix
        elif kind == 5:
            w = src[int(rng.integers(1, 3)):] or src        # suffix
        elif kind == 6 and len(src) >= 6:
            w = src[1:-1]                                   # contained
        elif kind == 7 and len(docs) >= 2:
            i = rng.integers(len(docs) - 1)                 # two doc words
            w = docs[i] + docs[i + 1]
        elif kind == 8 and len(src) >= 2 and len(out) + 2 <= n:
            cut = int(rng.integers(1, len(src)))            # one word split
            out.append(src[:cut][:L])
            w = src[cut:]
        elif kind == 9:
            w = (src + _word(rng, 1, 3))                    # doc word ends it
            w = w[-(len(src) + 1):] if rng.integers(2) else _word(rng, 1, 2) + src
        elif kind == 10:
            w = src[:2] if rng.integers(2) else [src[0], int(97 + rng.integers(5))]
        else:
            w = [] if rng.integers(3) == 0 else _word(rng, 1, 8)
        out.append(w[:L])
    return out[:n]


def make_inputs(seed, Q, L, D, n_c=C):
    """numpy inputs of ``coverage_cascade`` (before the pair words) in the
    coverage program's layout, as ``_coverage_block`` gathers them."""
    rng = np.random.default_rng(seed)
    vocab = {}
    qc = np.zeros((Q, L, n_c), np.int32)
    qr = np.zeros((Q, L, n_c), np.int32)
    ql = np.zeros((Q, n_c), np.int32)
    qsorted = np.zeros((Q, n_c), np.int32)
    qcount = np.zeros(n_c, np.int32)
    dc = np.zeros((L, D, n_c), np.int32)
    dr = np.zeros((L, D, n_c), np.int32)
    dl = np.zeros((D, n_c), np.int32)
    codes = np.full((D, n_c), -1, np.int32)
    offsets = np.zeros((D, n_c), np.int32)
    tok_count = np.zeros(n_c, np.int32)
    for c in range(n_c):
        n_tok = int(rng.integers(0, min(D, 10) + 1))
        if rng.integers(6) == 0:
            n_tok = int(rng.integers(0, D + 1))
        docs = []
        for d in range(n_tok):
            if docs and rng.integers(6) == 0:
                docs.append(list(docs[rng.integers(len(docs))]))  # a repeat
            else:
                docs.append(_word(rng, 1, min(L, 9) if rng.integers(5)
                                  else L))
        tok_count[c] = n_tok
        pos = int(rng.integers(3))
        for d, w in enumerate(docs):
            offsets[d, c] = pos
            pos += len(w) + int(rng.integers(1, 3))
            if rng.integers(20) == 0:
                continue                       # a token without a word
            codes[d, c] = vocab.setdefault(tuple(w), len(vocab))
            dl[d, c] = len(w)
            dc[:len(w), d, c] = w
            dr[:len(w), d, c] = w[::-1]
        n_q = int(rng.integers(0, Q + 1))
        words = _query_words(rng, docs, n_q, L)
        qcount[c] = n_q
        for q, w in enumerate(words):
            ql[q, c] = len(w)
            qc[q, :len(w), c] = w
            qr[q, :len(w), c] = w[::-1]
        order = sorted(range(n_q), key=lambda i: -len(words[i]))
        qsorted[:, c] = n_q if rng.integers(2) else Q + int(rng.integers(3))
        qsorted[:n_q, c] = order
    return dict(qc=qc, qr=qr, ql=ql, qsorted=qsorted, qcount=qcount, dc=dc,
                dr=dr, dl=dl, codes=codes, offsets=offsets,
                tok_count=tok_count)


def cascade_args(a):
    """The arguments of ``coverage_cascade`` as tensors: validity, masked
    lengths and the pair words as ``_coverage_block`` derives them."""
    t = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in a.items()}
    D = t["dl"].shape[0]
    valid = (t["codes"] >= 0) & (torch.arange(D)[:, None] < t["tok_count"][None])
    chars_t = torch.where(valid[None], t["dc"], 0).contiguous()
    chars_rev_t = torch.where(valid[None], t["dr"], 0).contiguous()
    lens = torch.where(valid, t["dl"], 0)
    pairs = ck.coverage_pairs_plain(t["qc"], t["qr"], t["ql"], chars_t,
                                    chars_rev_t, lens, valid, True)
    return (pairs, lens, t["offsets"], t["codes"], chars_t[0].contiguous(),
            t["tok_count"], t["ql"], t["qsorted"], t["qc"], t["qcount"])


_HOST_LOOP = r"""
#include <cstring>
#include <vector>
#include "coverage_cascade_cell.cuh"
// The kernel's steps for each tile of candidates: the tile's rows copied
// into a scratch that starts out as 0x7f bytes (a row the copy skipped
// reads as that), then each candidate by a group of G = min(D, 32) lanes
// (a loop over them), from the tile.
template <int D>
static void run(const cascade::Args& a) {
  constexpr int G = D < 32 ? D : 32;
  std::vector<int> tile(cascade::layout<D>(a.n_q).ints);
  const grp::Group<G> g;
  for (int c0 = 0; c0 < a.n_c; c0 += cascade::kTile) {
    std::memset(tile.data(), 0x7f, 4 * tile.size());
    cascade::stage<D>(a, c0, 0, 1, tile.data());
    for (int t = 0; t < cascade::kTile && c0 + t < a.n_c; ++t) {
      const cascade::In in = cascade::tile_in<D>(a, tile.data(), c0, t);
      cascade::candidate<D, G>(g, in, a, c0 + t);
    }
  }
}
extern "C" int coverage_cascade_host(const int* pairs, const int* lens,
    const int* offsets, const int* codes, const int* first_char,
    const int* tok_count, const int* qlens, const int* qsorted, const int* qc,
    const int* qcount, int n_q, int n_l, int n_d, int n_c, const int* cfg,
    float* term_matched, unsigned char* whole, unsigned char* joined,
    unsigned char* prefix, int* first_pos, int* word_hits, int* cov_count) {
  const cascade::Args a = {
      pairs, lens, offsets, codes, first_char, tok_count, qlens, qsorted, qc,
      qcount, n_q, n_l, n_c,
      {cfg[0], cfg[1], cfg[2], cfg[3], cfg[4], cfg[5], cfg[6], cfg[7],
       cfg[8]},
      term_matched, whole, joined, prefix, first_pos, word_hits, cov_count};
  if (n_d == 8) run<8>(a);
  else if (n_d == 16) run<16>(a);
  else if (n_d == 64) run<64>(a);
  else return 1;
  return 0;
}
"""


@pytest.fixture(scope="module")
def host_cascade(tmp_path_factory):
    """csrc/coverage_cascade_cell.cuh compiled with g++ behind the kernel's
    steps (tiles of candidates, a group of lanes per candidate); returns
    the seven outputs as tensors (``cov_count`` int32)."""
    lib = compile_cell(tmp_path_factory, "cascade_cell", _HOST_LOOP)
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.coverage_cascade_host.argtypes = [p] * 10 + [i] * 4 + [p] * 8
    lib.coverage_cascade_host.restype = i

    def run(args, config):
        arrays = [np.ascontiguousarray(t.numpy(), np.int32) for t in args]
        n_q, n_d, n_c = arrays[0].shape
        n_l = arrays[8].shape[1]
        cfg = np.array([config.min_word_size,
                        config.levenshtein_max_word_size, config.num_typos,
                        config.min_length_one_typo,
                        config.min_length_two_typos, config.cover_whole_words,
                        config.cover_joined_words, config.cover_prefix_suffix,
                        config.cover_fuzzy_words], np.int32)
        outs = [np.full((n_q, n_c), -7, np.float32)] + [
            np.full((n_q, n_c), 7, np.uint8) for _ in range(3)] + [
            np.full((n_q, n_c), -7, np.int32), np.full(n_c, -7, np.int32),
            np.full(n_c, -7, np.int32)]
        rc = lib.coverage_cascade_host(
            *(a.ctypes.data for a in arrays), n_q, n_l, n_d, n_c,
            cfg.ctypes.data, *(o.ctypes.data for o in outs))
        assert rc == 0
        assert all(o.max(initial=0) <= 1 for o in outs[1:4])
        return [torch.from_numpy(o.astype(bool) if o.dtype == np.uint8 else o)
                for o in outs]

    return run


def assert_same_state(got, want):
    """Every output equal; ``term_matched`` compared by its bits."""
    for name, g, w in zip(OUT_NAMES, got, want):
        assert g.shape == w.shape, name
        if name == "term_matched":
            g, w = g.view(torch.int32), w.view(torch.int32)
        elif name == "cov_count":
            g, w = g.to(torch.int64), w.to(torch.int64)
        else:
            assert g.dtype == w.dtype, name
        bad = (g != w).nonzero()
        assert bad.numel() == 0, (name, bad[:4].tolist())


def _seed(shape, config):
    return 100 * list(SHAPES).index(shape) + list(CONFIGS).index(config)


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("config", list(CONFIGS))
@pytest.mark.parametrize("shape", list(SHAPES))
def test_cascade_cell_code_equals_the_plain_version(host_cascade, shape,
                                                    config, seed):
    args = cascade_args(make_inputs(1000 * seed + _seed(shape, config),
                                    *SHAPES[shape]))
    want = ck.coverage_cascade_plain(*args, CONFIGS[config])
    got = host_cascade(args, CONFIGS[config])
    assert_same_state(got, want)
    # the dispatcher takes the plain version for CPU tensors
    same = ck.coverage_cascade(*args, CONFIGS[config])
    assert_same_state(same, want)


@pytest.mark.parametrize("shape", list(SHAPES))
def test_inputs_reach_every_matcher(shape):
    """The seeded inputs exercise what they are meant to: each matcher
    fires, tokens stay unmatched, the length-sorted order is padded both
    ways, empty query words and repeated doc words occur."""
    a = make_inputs(_seed(shape, "default"), *SHAPES[shape], n_c=4 * C)
    args = cascade_args(a)
    Q = SHAPES[shape][0]
    tm, whole, joined, prefix, first_pos, hits, cov = \
        ck.coverage_cascade_plain(*args, BASE)
    assert whole.any() and joined.any() and (prefix & ~whole & ~joined).any()
    real = torch.arange(Q)[:, None] < args[9][None]
    assert (real & (first_pos == -1)).any() and (first_pos >= 0).any()
    frac = tm[(tm > 0)] % 1
    assert (frac > 0).any()                # a 0.6 * len or a 0.1 credit
    ql, qsorted, qcount = a["ql"], a["qsorted"], a["qcount"]
    assert ((ql == 0) & (np.arange(Q)[:, None] < qcount[None])).any()
    assert (qsorted >= Q).any() and ((qsorted == qcount[None])
                                     & (qsorted < Q)).any()
    assert (hits.numpy() < a["tok_count"]).any()
    unique = [len({c for c in col[:n] if c >= 0})
              for col, n in zip(a["codes"].T, a["tok_count"])]
    assert (np.array(unique) < cov.numpy()).any()   # a repeated doc word
    # without the fuzzy matcher fewer words are hit: its rounds fired
    no_fuzzy = ck.coverage_cascade_plain(
        *args, BASE._replace(cover_fuzzy_words=False))
    assert (no_fuzzy[5] < hits).any()


# --- hand-made candidates -----------------------------------------------------


def _candidate(doc_words, query_words, L=12, Q=4, D=8, qsorted_pad=None,
               offsets=None):
    """One candidate's inputs from words given as strings."""
    a = dict(qc=np.zeros((Q, L, 1), np.int32), qr=np.zeros((Q, L, 1), np.int32),
             ql=np.zeros((Q, 1), np.int32), qsorted=np.zeros((Q, 1), np.int32),
             qcount=np.array([len(query_words)], np.int32),
             dc=np.zeros((L, D, 1), np.int32), dr=np.zeros((L, D, 1), np.int32),
             dl=np.zeros((D, 1), np.int32), codes=np.full((D, 1), -1, np.int32),
             offsets=np.zeros((D, 1), np.int32),
             tok_count=np.array([len(doc_words)], np.int32))
    vocab, pos = {}, 0
    for d, w in enumerate(doc_words):
        b = list(w.encode())
        a["codes"][d, 0] = vocab.setdefault(w, len(vocab))
        a["dl"][d, 0] = len(b)
        a["dc"][:len(b), d, 0], a["dr"][:len(b), d, 0] = b, b[::-1]
        a["offsets"][d, 0] = pos if offsets is None else offsets[d]
        pos += len(b) + 1
    for q, w in enumerate(query_words):
        b = list(w.encode())
        a["ql"][q, 0] = len(b)
        a["qc"][q, :len(b), 0], a["qr"][q, :len(b), 0] = b, b[::-1]
    order = sorted(range(len(query_words)), key=lambda i: -len(query_words[i]))
    a["qsorted"][:, 0] = len(query_words) if qsorted_pad is None else qsorted_pad
    a["qsorted"][:len(order), 0] = order
    return a


KNOWN = {
    # query words that match nothing: index 0 of a miss must not leak
    "miss": (["alpha", "beta"], ["zzzz", "qq"], {}, dict(
        term_matched=[0.0, 0.0, 0.0, 0.0], term_first_pos=[-1, -1, -1, -1],
        word_hits=0, cov_count=2)),
    # whole word, found at its token's offset
    "whole": (["alpha", "beta"], ["beta"], {}, dict(
        term_matched=[4.0, 0, 0, 0], term_has_whole=[True, False, False, False],
        term_first_pos=[6, -1, -1, -1], word_hits=1)),
    # an empty query word inside the count is a prefix of the longest
    # doc word still active, for a credit of 0 (reference behaviour)
    "empty_query_word": (["alpha", "beta"], ["", "alpha"], {}, dict(
        term_matched=[0.0, 5.0, 0, 0], term_first_pos=[6, 0, -1, -1],
        term_has_prefix=[True, True, False, False], word_hits=2)),
    # two query words joined by one doc word: two hits, both positions
    "query_joined": (["xx", "alphabeta"], ["alpha", "beta"], {}, dict(
        term_matched=[5.0, 4.0, 0, 0], term_has_joined=[True, True, False, False],
        term_has_prefix=[True, False, False, False],
        term_first_pos=[3, 3, -1, -1], word_hits=2)),
    # two adjacent ACTIVE doc words joined by one query word: "new" is
    # consumed by the whole-word matcher first, so "york"+"city" join
    "doc_joined": (["new", "york", "city"], ["new", "yorkcity"], {}, dict(
        term_matched=[3.0, 8.0, 0, 0], term_has_joined=[False, True, False, False],
        term_first_pos=[0, 4, -1, -1], word_hits=2)),
    # prefix: the longest doc word wins, then the first
    "prefix_order": (["alp", "alphabet", "alphabex", "alpha"], ["alph"], {},
                     dict(term_matched=[4.0, 0, 0, 0],
                          term_has_prefix=[True, False, False, False],
                          term_first_pos=[4, -1, -1, -1], word_hits=1)),
    # suffix credits half the query word, contained 0.6 of it
    "suffix": (["xxbeta"], ["beta"], {}, dict(
        term_matched=[2.0, 0, 0, 0], term_has_prefix=[False] * 4, word_hits=1)),
    "contained": (["xbetax"], ["beta"], {}, dict(
        term_matched=[float(np.float32(4.0) * np.float32(0.6)), 0, 0, 0],
        word_hits=1)),
    # the doc word ends the longer query word: its own length
    "doc_word_ends_query": (["beta"], ["xxbeta"], {}, dict(
        term_matched=[4.0, 0, 0, 0], word_hits=1)),
    # the two-letter rule: one typo for a two-letter word, same first char
    "two_letter_rule": (["ax", "ba"], ["ab"], {}, dict(
        term_matched=[1.0, 0, 0, 0], term_first_pos=[0, -1, -1, -1],
        word_hits=1)),
    "two_letter_rule_off": (["ax", "ba"], ["ab"], dict(num_typos=0), dict(
        term_matched=[0.0, 0, 0, 0], word_hits=0)),
    # fuzzy: one typo in a seven-letter word; none allowed with num_typos 0
    "one_typo": (["shawshank"], ["shawshenk"], {}, dict(
        term_matched=[8.0, 0, 0, 0], word_hits=1)),
    "two_typos": (["shawshank"], ["shewshenk"], {}, dict(
        term_matched=[7.0, 0, 0, 0], word_hits=1)),
    "two_typos_one_allowed": (["shawshank"], ["shewshenk"],
                              dict(num_typos=1), dict(
        term_matched=[0.0, 0, 0, 0], word_hits=0)),
    # a repeated doc word is coverable twice and matchable once
    "repeated_doc_word": (["beta", "beta"], ["beta", "beta"], {}, dict(
        term_matched=[4.0, 0.0, 0, 0], word_hits=1, cov_count=2)),
    # the doc-joined walk: "ab"+"cd" takes the first query word and both
    # tokens, so "cd"+"ef" is never a pair; "cdef" is then ended by "ef"
    "doc_joined_chain": (["ab", "cd", "ef"], ["abcd", "cdef"], {}, dict(
        term_matched=[4.0, 2.0, 0, 0],
        term_has_joined=[True, False, False, False],
        term_has_prefix=[True, False, False, False],
        term_first_pos=[0, 6, -1, -1], word_hits=2)),
    # two doc-joined pairs, each taking its own query word
    "doc_joined_two_pairs": (["ab", "cd", "abc", "de"], ["abcd", "abcde"],
                             {}, dict(
        term_matched=[4.0, 5.0, 0, 0],
        term_has_joined=[True, True, False, False],
        term_first_pos=[0, 6, -1, -1], word_hits=2)),
}

#: Each query token takes at most one credit (single consumption), so no
#: term_matched is a sum of several; what its bits pin is that each credit
#: is rounded once, in f32, as the plain version rounds it. The
#: "contained" credit of a 7-char word, 0.6 x 7 in f32, differs in its
#: last bit from the product rounded from f64 (4.2000003 against 4.2).
KNOWN["contained_one_rounding"] = (["xbetagamx"], ["betagam"], {}, dict(
    term_matched=[float(np.float32(7) * np.float32(0.6)), 0, 0, 0],
    term_has_prefix=[False] * 4, term_first_pos=[0, -1, -1, -1],
    word_hits=1))
assert np.float32(7) * np.float32(0.6) != np.float32(7 * 0.6)


@pytest.mark.parametrize("case", list(KNOWN))
def test_known_candidates(host_cascade, case):
    docs, queries, cfg, want = KNOWN[case]
    config = BASE._replace(**cfg)
    for pad in (None, 9):                      # both paddings of qsorted2
        args = cascade_args(_candidate(docs, queries, qsorted_pad=pad))
        plain = ck.coverage_cascade_plain(*args, config)
        assert_same_state(host_cascade(args, config), plain)
        state = dict(zip(OUT_NAMES, plain))
        for name, value in want.items():
            got = state[name].reshape(-1).tolist()
            assert got == (value if isinstance(value, list) else [value]), \
                (name, got)


def _full_docs(seed, Q, L, D, n_c):
    """``make_inputs`` with a third of the candidates at tok_count 0 and a
    third at tok_count D whose query words come from their last tokens, so
    that matches fall on the last lanes (and, at D 64, on the second token
    of a lane)."""
    a = make_inputs(seed, Q, L, D, n_c)
    rng = np.random.default_rng(seed + 1)
    vocab = {}
    for c in range(n_c):
        if c % 3 == 0:
            a["tok_count"][c] = 0
            continue
        if c % 3 == 2:
            continue
        docs = [_word(rng, 2, min(L, 9)) for _ in range(D)]
        for k in rng.integers(D // 2, D, size=2):
            docs[k] = list(docs[D - 1 - int(rng.integers(2))])   # repeats
        a["tok_count"][c] = D
        a["codes"][:, c] = -1
        a["dc"][:, :, c] = a["dr"][:, :, c] = 0
        a["dl"][:, c] = 0
        for d, w in enumerate(docs):
            a["codes"][d, c] = vocab.setdefault(tuple(w), len(vocab))
            a["dl"][d, c] = len(w)
            a["dc"][:len(w), d, c] = w
            a["dr"][:len(w), d, c] = w[::-1]
            a["offsets"][d, c] = 10 * d
        words = _query_words(rng, docs[-3:], Q, L)
        a["qcount"][c] = Q
        a["ql"][:, c] = 0
        a["qc"][:, :, c] = a["qr"][:, :, c] = 0
        for q, w in enumerate(words):
            a["ql"][q, c] = len(w)
            a["qc"][q, :len(w), c] = w
            a["qr"][q, :len(w), c] = w[::-1]
        a["qsorted"][:, c] = sorted(range(Q), key=lambda i: -len(words[i]))
    return a


@pytest.mark.parametrize("config", ["default", "no_whole_no_joined"])
@pytest.mark.parametrize("shape", list(SHAPES))
def test_lane_groups_at_token_counts_0_and_d(host_cascade, shape, config):
    """Each group width the kernel runs (8, 16 and 32 lanes at D 8, 16 and
    64; two tokens a lane at D 64) with a third of the candidates at
    tok_count 0 and a third at tok_count D: equal to the plain version,
    with matches on tokens of the last lanes."""
    Q, L, D = SHAPES[shape]
    args = cascade_args(_full_docs(_seed(shape, config) + 31, Q, L, D,
                                   3 * C))
    want = ck.coverage_cascade_plain(*args, CONFIGS[config])
    assert_same_state(host_cascade(args, CONFIGS[config]), want)
    first_pos, hits, tok = want[4], want[5], args[5]
    full = tok == D
    assert (tok == 0).sum() >= C and full.sum() >= C
    assert (hits[tok == 0] == 0).all()
    # the queries of full docs hit their last three tokens (offsets 10 d)
    assert (first_pos[:, full] >= 10 * (D - 3)).any()


_MAX_INT = r"""
#include "lane_group.cuh"
// grp::max_int over each row of G values: one group per row
template <int G>
static void run(const int* vals, int n_rows, int* out) {
  const grp::Group<G> g;
  for (int r = 0; r < n_rows; ++r) {
    out[r] = grp::max_int(g, [&](int l) { return vals[r * G + l]; });
  }
}
extern "C" int max_int_host(const int* vals, int g, int n_rows, int* out) {
  if (g == 1) run<1>(vals, n_rows, out);
  else if (g == 8) run<8>(vals, n_rows, out);
  else if (g == 16) run<16>(vals, n_rows, out);
  else if (g == 32) run<32>(vals, n_rows, out);
  else return 1;
  return 0;
}
"""


@pytest.mark.parametrize("lanes", [1, 8, 16, 32])
def test_lane_group_max_int(tmp_path_factory, lanes):
    """``grp::max_int`` (csrc/lane_group.cuh), the collective of the
    cascade's longest-then-first picks, in its host build: the largest of
    each group's values, negatives and ties included."""
    lib = compile_cell(tmp_path_factory, f"max_int_{lanes}", _MAX_INT)
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.max_int_host.argtypes = [p, i, i, p]
    lib.max_int_host.restype = i
    rng = np.random.default_rng(lanes)
    vals = rng.integers(-5, 3, size=(64, lanes)).astype(np.int32)
    vals[0] = -1
    out = np.full(64, 99, np.int32)
    assert lib.max_int_host(vals.ctypes.data, lanes, 64, out.ctypes.data) == 0
    assert (out == vals.max(axis=1)).all()


def test_cpu_tensors_never_reach_the_kernel_wrapper():
    args = cascade_args(_candidate(["alpha"], ["alpha"]))
    with pytest.raises(ValueError):
        _kernels.coverage_cascade(*args, BASE)


@pytest.mark.gpu
@pytest.mark.parametrize("config", list(CONFIGS))
@pytest.mark.parametrize("shape", list(SHAPES))
def test_cuda_kernel_matches_plain_version(shape, config):
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    args = cascade_args(make_inputs(2000 + _seed(shape, config),
                                    *SHAPES[shape], n_c=300))
    want = ck.coverage_cascade_plain(*args, CONFIGS[config])
    cuda = [t.cuda() for t in args]
    n0 = _kernels.launch_counts["coverage_cascade"]
    got = [ck.coverage_cascade(*cuda, CONFIGS[config]) for _ in range(2)]
    torch.cuda.synchronize()
    assert _kernels.launch_counts["coverage_cascade"] == n0 + 2
    for outs in got:
        assert_same_state([o.cpu() for o in outs], want)
    # the plain version on the card gives the same bits as on the CPU
    assert_same_state([o.cpu() for o in ck.coverage_cascade_plain(
        *cuda, CONFIGS[config])], want)
    # a doc-token width the kernel is not built for raises, it does not
    # fall back
    with pytest.raises(ValueError):
        ck.coverage_cascade(cuda[0][:, :5].contiguous(),
                            *(t[:5].contiguous() for t in cuda[1:5]),
                            *cuda[5:], CONFIGS[config])
