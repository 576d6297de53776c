"""The Stage-2 edit distances of the port
(infidex_tpu_torch/ops/editdistance_multi.py ``coverage_distances_plain``)
and the pair words that carry them beside the word relations
(infidex_tpu_torch/ops/coverage_kernel.py ``coverage_pairs``) against the
reference.

* ``coverage_distances_plain`` against the JAX composition (the functions of
  infidex_tpu/ops/editdistance_multi.py called as
  infidex_tpu/ops/coverage_kernel.py:640-662 calls them, on the CPU): all
  five tensors exactly equal (integers, tolerance 0);
* the CUDA kernel's block code (``pairs::block`` of
  csrc/edit_distances_cell.cuh, the header csrc/coverage_pairs.cu includes),
  compiled for the host with g++ -ffp-contract=off behind the kernel's C
  interfaces and called through the port's wrappers (``lib=``), blocks in
  turn over shared memory filled with 0x7f, at several tile sizes: its
  distance fields against the plain distances, and its whole pair words,
  with and without distances and for a coverage block's two sets of query
  tokens in one call, against ``coverage_pairs_plain``: exactly equal;
* its bit-parallel distances against the band route (``pair_cell``, the
  plain version's banded sweeps cell by cell) and the plain version on
  every pair of words of up to 5 chars over 3 letters and on 100,000
  seeded pairs of up to 24 chars (past L at L 12): exactly equal;
* the plain word relations (``_pairwise_primitives``, ``_q_startswith_d_t``)
  against the JAX functions of the same names, and the pair word's
  packing: exactly equal;
* on a card, the kernel against the plain version: exactly equal;
* the single-token functions of ops/editdistance.py
  (``batched_levenshtein``, ``batched_damerau``, ``_batched_lev_pairwise``,
  ``_propagate_insertions``) against the JAX functions of the same names,
  edges included (empty words, doc lengths past L, L below the query
  width), and against the scalar oracles of ``utils.metrics``: exactly
  equal.

Inputs are made with numpy from a seed: words over a five-letter alphabet,
query words derived from their candidate's doc words by edits, at the
coverage program's three shape classes.
"""

import ctypes
import itertools
import shutil
import subprocess

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from infidex_tpu.ops import coverage_kernel as ref_ck
from infidex_tpu.ops import editdistance as ref_single
from infidex_tpu.ops import editdistance_multi as ref_ed
from infidex_tpu_torch import runtime
from infidex_tpu_torch.ops import _kernels
from infidex_tpu_torch.ops import coverage_kernel as port_ck
from infidex_tpu_torch.ops import editdistance as port_single
from infidex_tpu_torch.ops import editdistance_multi as port_ed
from infidex_tpu_torch.utils.metrics import calculate_damerau, levenshtein

runtime.set_device("cpu")
# the suite runs in several worker processes on shared cores; one intra-op
# thread each keeps torch from oversubscribing them
torch.set_num_threads(1)

#: (Q, D, L) of the coverage program's small, narrow and wide classes
SHAPES = [(4, 8, 12), (16, 16, 24), (16, 64, 24)]
CASES = ["random", "empty_query_rows", "empty_doc_tokens", "equal_words",
         "one_transposition", "length_difference", "full_length_words"]
C = 24
NAMES = ("dam1", "dam2", "pdam1", "pdam2", "pdam3")


def _edit(rng, w, n_edits):
    w = list(w)
    for _ in range(n_edits):
        kind = rng.integers(4)
        if kind == 0 and w:                         # substitute
            w[rng.integers(len(w))] = 97 + rng.integers(5)
        elif kind == 1 and w:                       # delete
            del w[rng.integers(len(w))]
        elif kind == 2:                             # insert
            w.insert(rng.integers(len(w) + 1), 97 + rng.integers(5))
        elif len(w) >= 2:                           # transpose
            i = rng.integers(len(w) - 1)
            w[i], w[i + 1] = w[i + 1], w[i]
    return w


def _inputs(seed, Q, D, L, case):
    """numpy inputs of ``coverage_distances_plain`` in the coverage
    program's layout: chars zero-padded, reversed copies, lengths."""
    rng = np.random.default_rng(seed)

    def word(lo, hi):
        return list(97 + rng.integers(5, size=rng.integers(lo, hi + 1)))

    docs = [[word(0, L) for _ in range(C)] for _ in range(D)]
    queries = []
    for q in range(Q):
        row = []
        for c in range(C):
            src = docs[rng.integers(D)][c]
            if case == "equal_words":
                w = list(src)
            elif case == "one_transposition":
                w = list(src)
                if len(w) >= 2:
                    i = rng.integers(len(w) - 1)
                    w[i], w[i + 1] = w[i + 1], w[i]
            elif case == "length_difference":
                w = list(src)
                for _ in range(rng.integers(1, 4)):
                    if rng.integers(2) and w:
                        del w[rng.integers(len(w))]
                    else:
                        w.insert(rng.integers(len(w) + 1),
                                 97 + rng.integers(5))
            elif rng.integers(4) == 0:
                w = word(0, L)
            else:
                w = _edit(rng, src, rng.integers(4))
            row.append(w[:L])
        queries.append(row)
    if case == "empty_query_rows":
        for q in range(Q // 2, Q):
            queries[q] = [[] for _ in range(C)]
        queries[0][::3] = [[] for _ in queries[0][::3]]
    if case == "empty_doc_tokens":
        for d in range(D // 2, D):
            docs[d] = [[] for _ in range(C)]
        docs[0][::3] = [[] for _ in docs[0][::3]]
    if case == "full_length_words":
        for d in range(0, D, 2):
            docs[d] = [word(L, L) for _ in range(C)]
        for q in range(0, Q, 2):
            queries[q] = [_edit(rng, docs[0][c], rng.integers(3))[:L]
                          for c in range(C)]
        queries[1] = [list(docs[0][c]) for c in range(C)]

    qc = np.zeros((Q, L, C), np.int32)
    qr = np.zeros((Q, L, C), np.int32)
    ql = np.zeros((Q, C), np.int32)
    dc = np.zeros((L, D, C), np.int32)
    dr = np.zeros((L, D, C), np.int32)
    dl = np.zeros((D, C), np.int32)
    for q in range(Q):
        for c in range(C):
            w = queries[q][c]
            ql[q, c] = len(w)
            qc[q, :len(w), c] = w
            qr[q, :len(w), c] = w[::-1]
    for d in range(D):
        for c in range(C):
            w = docs[d][c]
            dl[d, c] = len(w)
            dc[:len(w), d, c] = w
            dr[:len(w), d, c] = w[::-1]
    return qc, qr, ql, dc, dr, dl


def _reference(qc3, qr3, qlens2, chars_t, chars_rev_t, lens):
    """The JAX composition of infidex_tpu/ops/coverage_kernel.py:640-662."""
    qc3, qr3, qlens2, chars_t, chars_rev_t, lens = (
        jnp.asarray(a) for a in (qc3, qr3, qlens2, chars_t, chars_rev_t,
                                 lens))
    L, D, _ = chars_t.shape
    eq_al, eq_qd1, eq_q1d, rev_eq = ref_ed.alignment_tensors(
        qc3, chars_t, qr3, chars_rev_t)
    lev3 = ref_ed.batched_lev_multi(qc3, qlens2, chars_t, lens, budget=3,
                                    l_max=L)
    dam1 = ref_ed.damerau_rescue(jnp.minimum(lev3, 3), eq_al, eq_qd1, eq_q1d,
                                 qlens2, lens, max_distance=1)
    dam2 = ref_ed.damerau_rescue(lev3, eq_al, eq_qd1, eq_q1d, qlens2, lens,
                                 max_distance=2, rev_eq=rev_eq)
    ql_b = qlens2[:, None, :]
    dl1 = jnp.minimum(lens[None], ql_b)
    dl2 = jnp.minimum(lens[None], ql_b + 1)
    dl3 = jnp.minimum(lens[None], jnp.maximum(ql_b - 1, 0))
    chars3 = jnp.concatenate([chars_t, chars_t, chars_t], axis=1)
    dl_stack = jnp.concatenate([dl1, dl2, dl3], axis=1)
    lev_p = ref_ed.batched_lev_multi(qc3, qlens2, chars3, dl_stack, budget=2,
                                     l_max=L)
    pdam1 = ref_ed.damerau_rescue(lev_p[:, :D], eq_al, eq_qd1, eq_q1d,
                                  qlens2, dl1, max_distance=1)
    pdam2 = ref_ed.damerau_rescue(lev_p[:, D:2 * D], eq_al, eq_qd1, eq_q1d,
                                  qlens2, dl2, max_distance=1)
    pdam3 = ref_ed.damerau_rescue(lev_p[:, 2 * D:], eq_al, eq_qd1, eq_q1d,
                                  qlens2, dl3, max_distance=1)
    return [np.asarray(x) for x in (dam1, dam2, pdam1, pdam2, pdam3)]


def _pairs(fn, arrays):
    """``fn`` (``coverage_pairs`` or its plain version) with distances on
    ``_inputs`` arrays (or tensors), every doc token valid."""
    tensors = [torch.as_tensor(a) for a in arrays]
    return fn(*tensors, torch.ones_like(tensors[5], dtype=torch.bool), True)


def _plain(arrays):
    return [t.numpy() for t in port_ed.coverage_distances_plain(
        *(torch.from_numpy(a) for a in arrays))]


def _seed(shape, case):
    return 100 * SHAPES.index(shape) + CASES.index(case)


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_plain_distances_equal_the_reference(shape, case):
    arrays = _inputs(_seed(shape, case), *shape, case)
    want = _reference(*arrays)
    got = _plain(arrays)
    Q, D, _ = shape
    for name, g, w in zip(NAMES, got, want):
        assert g.dtype == np.int32 and g.shape == (Q, D, C), name
        assert np.array_equal(g, w), name
    # the dispatcher takes the plain version for CPU tensors: its pair
    # words hold these distances
    same = port_ed.unpack_distances(_pairs(port_ck.coverage_pairs, arrays))
    for g, s in zip(got, same):
        assert np.array_equal(g, s.numpy())
    # the case exercises the distances: not every cell is clamped
    if case in ("equal_words", "one_transposition"):
        assert (got[1] <= 1).any()


def test_known_distances():
    """Hand-checked cells: 'abcde' against a transposition, itself, one
    char more, one less, a substitution and empty doc tokens; and an empty
    query row."""
    L, Q, D = 12, 4, 8
    qc = np.zeros((Q, L, 1), np.int32)
    qr, dc = qc.copy(), np.zeros((L, D, 1), np.int32)
    dr = dc.copy()
    ql, dl = np.zeros((Q, 1), np.int32), np.zeros((D, 1), np.int32)
    q, words = b"abcde", [b"abdce", b"abcde", b"abcdef", b"abcd", b"xbcde"]
    qc[0, :5, 0], qr[0, :5, 0], ql[0, 0] = list(q), list(q[::-1]), 5
    for d, w in enumerate(words):
        dc[:len(w), d, 0], dr[:len(w), d, 0] = list(w), list(w[::-1])
        dl[d, 0] = len(w)
    dam1, dam2, pdam1, pdam2, pdam3 = _plain((qc, qr, ql, dc, dr, dl))
    assert dam1[0, :, 0].tolist() == [1, 0, 1, 1, 1, 2, 2, 2]
    # the rescue only applies at max_distance + 1: a transposition whose
    # Levenshtein distance is 2 stays 2 at max distance 2 (reference
    # behaviour)
    assert dam2[0, :, 0].tolist() == [2, 0, 1, 1, 1, 3, 3, 3]
    assert pdam1[0, :, 0].tolist() == [1, 0, 0, 1, 1, 2, 2, 2]  # 5-char prefix
    assert pdam2[0, :, 0].tolist() == [1, 0, 1, 1, 1, 2, 2, 2]  # 6-char
    assert pdam3[0, :, 0].tolist() == [2, 1, 1, 1, 2, 2, 2, 2]  # 4-char
    # an empty query row: the doc token's (clipped) length, clamped
    assert dam1[1, :, 0].tolist() == [2, 2, 2, 2, 2, 0, 0, 0]
    assert dam2[1, :, 0].tolist() == [3, 3, 3, 3, 3, 0, 0, 0]
    assert pdam2[1, :, 0].tolist() == [1, 1, 1, 1, 1, 0, 0, 0]


# --- the kernel's block code, compiled for the host -----------------------

_HOST = r"""
#include <cstring>
#include <vector>
#include "edit_distances_cell.cuh"
// csrc/coverage_pairs.cu's C interfaces on the host: the kernel's blocks
// in turn (last to first), each block's shared memory filled with 0x7f
// bytes first, one thread running the block's steps; tiles sized for
// g_blocks blocks. coverage_pairs_band: the band route (pair_cell), cell
// by cell, in the kernel's addressing.
static int g_blocks = 7;
extern "C" void set_tile_blocks(int b) { g_blocks = b; }
template <int L>
static int run_blocks(const pairs::Args& a) {
  const int t = pairs::tile_candidates(L, a.n_s + a.n_f, a.n_d, a.n_c,
                                       g_blocks);
  if (t == 0) return 1;
  int lt = 0;
  while ((1 << lt) < t) ++lt;
  std::vector<int> smem(pairs::layout(L, a.n_s + a.n_f, a.n_d, t).ints);
  for (int b = (a.n_c + t - 1) / t - 1; b >= 0; --b) {
    std::memset(smem.data(), 0x7f, smem.size() * sizeof(int));
    pairs::block<L>(a, lt, b * t, 0, 1, smem.data());
  }
  return 0;
}
static int run(const pairs::Args& a, int n_l) {
  if (a.n_c <= 0 || a.n_d <= 0 || a.n_s + a.n_f <= 0) return 0;
  if (n_l == 12) return run_blocks<12>(a);
  if (n_l == 24) return run_blocks<24>(a);
  return 1;
}
extern "C" int coverage_pairs(const int* qc, const int* qr, const int* ql,
    const int* dc, const int* dr, const int* dl, const unsigned char* valid,
    int n_s, int n_l, int n_d, int n_c, int with_distances, int* out,
    void*) {
  const pairs::Args a{qc, qr, ql, nullptr, nullptr, nullptr, dc, dr, dl,
                      valid, n_s, 0, n_d, n_c, with_distances != 0, out,
                      nullptr};
  return run(a, n_l);
}
extern "C" int coverage_pair_block(const int* qc, const int* qr,
    const int* ql, int n_s, const int* fqc, const int* fqr, const int* fql,
    int n_f, const int* dc, const int* dr, const int* dl,
    const unsigned char* valid, int n_l, int n_d, int n_c, int* out,
    int* fout, void*) {
  const pairs::Args a{qc, qr, ql, fqc, fqr, fql, dc, dr, dl, valid,
                      n_s, n_f, n_d, n_c, 1, out, fout};
  return run(a, n_l);
}
template <int L, bool DIST>
static void band(const int* qc, const int* qr, const int* ql, const int* dc,
                 const int* dr, const int* dl, const unsigned char* valid,
                 int n_q, int n_d, int n_c, int* out) {
  for (int q = 0; q < n_q; ++q)
    for (int d = 0; d < n_d; ++d)
      for (int c = 0; c < n_c; ++c) {
        const long long q_at = (long long)q * L * n_c + c;
        const long long d_at = (long long)d * n_c + c;
        out[((long long)q * n_d + d) * n_c + c] = edit::pair_cell<L, DIST>(
            qc + q_at, qr + q_at, n_c, dc + d_at, dr + d_at,
            (long long)n_d * n_c, ql[(long long)q * n_c + c], dl[d_at],
            valid[d_at] != 0);
      }
}
extern "C" int coverage_pairs_band(const int* qc, const int* qr,
    const int* ql, const int* dc, const int* dr, const int* dl,
    const unsigned char* valid, int n_q, int n_l, int n_d, int n_c,
    int with_distances, int* out) {
  if (n_l == 12 && with_distances)
    band<12, true>(qc, qr, ql, dc, dr, dl, valid, n_q, n_d, n_c, out);
  else if (n_l == 12)
    band<12, false>(qc, qr, ql, dc, dr, dl, valid, n_q, n_d, n_c, out);
  else if (n_l == 24 && with_distances)
    band<24, true>(qc, qr, ql, dc, dr, dl, valid, n_q, n_d, n_c, out);
  else if (n_l == 24)
    band<24, false>(qc, qr, ql, dc, dr, dl, valid, n_q, n_d, n_c, out);
  else return 1;
  return 0;
}
"""


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    """csrc/edit_distances_cell.cuh compiled with g++ -ffp-contract=off
    behind csrc/coverage_pairs.cu's C interfaces (the kernel's block code)
    and beside the band route, bound as the port binds the card's
    library."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("no g++")
    tmp = tmp_path_factory.mktemp("pair_cell")
    src, so = tmp / "pairs.cpp", tmp / "libpair_host.so"
    src.write_text(_HOST)
    subprocess.run([gxx, "-O1", "-std=c++17", "-ffp-contract=off", "-shared",
                    "-fPIC", "-I", _kernels._CSRC, "-o", str(so), str(src)],
                   check=True, capture_output=True, text=True)
    lib = _kernels.bind(ctypes.CDLL(str(so)))
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.coverage_pairs_band.argtypes = [p] * 7 + [i] * 5 + [p]
    lib.coverage_pairs_band.restype = i
    lib.set_tile_blocks.argtypes = [i]
    lib.set_tile_blocks.restype = None
    return lib


def _host_pairs(lib, arrays, distances, blocks=7):
    """The kernel's block code on the host through the port's wrapper
    (``lib=``): the pair words of ``_pair_inputs``-like arrays."""
    lib.set_tile_blocks(blocks)
    return _kernels.coverage_pairs(
        *(torch.from_numpy(np.ascontiguousarray(a)) for a in arrays),
        distances, lib=lib).numpy()


def _band_pairs(lib, arrays, distances):
    """The band route's pair words, cell by cell."""
    arrays = [np.ascontiguousarray(a, np.uint8 if a.dtype == bool
                                   else np.int32) for a in arrays]
    n_q, n_l, n_c = arrays[0].shape
    n_d = arrays[3].shape[1]
    out = np.full((n_q, n_d, n_c), -7, np.int32)
    assert lib.coverage_pairs_band(*(a.ctypes.data for a in arrays), n_q,
                                   n_l, n_d, n_c, int(distances),
                                   out.ctypes.data) == 0
    return out


@pytest.fixture(scope="module")
def host_cell(host_lib):
    """The kernel's block code, every doc token valid: the five distance
    fields of its pair words."""

    def run(qc, qr, ql, dc, dr, dl):
        arrays = [np.ascontiguousarray(a, np.int32)
                  for a in (qc, qr, ql, dc, dr, dl)]
        valid = np.ones(arrays[5].shape, bool)
        out = _host_pairs(host_lib, arrays + [valid], True)
        assert (out >= 0).all()
        return [t.numpy() for t in
                port_ed.unpack_distances(torch.from_numpy(out))]

    return run


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_kernel_cell_code_equals_the_plain_version(host_cell, shape, case):
    arrays = _inputs(1000 + _seed(shape, case), *shape, case)
    for name, g, w in zip(NAMES, host_cell(*arrays), _plain(arrays)):
        assert np.array_equal(g, w), name


def test_kernel_cell_code_with_lengths_past_the_table(host_cell):
    """Lengths larger than L (no table writes one, but the plain version is
    defined there: rows never freeze, offsets leave the band)."""
    arrays = list(_inputs(7, 4, 8, 12, "random"))
    rng = np.random.default_rng(8)
    arrays[2] = arrays[2] + rng.integers(0, 3, arrays[2].shape,
                                         dtype=np.int32) * 6
    arrays[5] = arrays[5] + rng.integers(0, 3, arrays[5].shape,
                                         dtype=np.int32) * 6
    for name, g, w in zip(NAMES, host_cell(*arrays), _plain(arrays)):
        assert np.array_equal(g, w), name


def _word_pairs(qs, ds, L):
    """One cell per (query word, doc word) pair: arrays of
    ``_pair_inputs``' layout with S = D = 1, C pairs, words longer than L
    stored as the tables store them (their first L chars, and reversed
    their last L), every doc token valid."""
    n = len(qs)
    qc = np.zeros((1, L, n), np.int32)
    qr, ql = qc.copy(), np.zeros((1, n), np.int32)
    dc = np.zeros((L, 1, n), np.int32)
    dr, dl = dc.copy(), np.zeros((1, n), np.int32)
    for c, (q, d) in enumerate(zip(qs, ds)):
        ql[0, c], dl[0, c] = len(q), len(d)
        qc[0, :min(len(q), L), c] = q[:L]
        qr[0, :min(len(q), L), c] = q[::-1][:L]
        dc[:min(len(d), L), 0, c] = d[:L]
        dr[:min(len(d), L), 0, c] = d[::-1][:L]
    return qc, qr, ql, dc, dr, dl, np.ones((1, n), bool)


def _small_words():
    """Every word of 0-5 chars over a three-letter alphabet (364)."""
    words = [[]]
    for n in range(1, 6):
        words += [list(w) for w in itertools.product((97, 98, 99), repeat=n)]
    return words


@pytest.mark.parametrize("L", [12, 24])
def test_bit_parallel_distances_equal_the_band_sweep_exhaustively(host_lib,
                                                                  L):
    """Every pair of words of up to 5 chars over 3 letters (132,496
    cells): the kernel's words (bit-parallel distances, one equality mask
    a doc char) equal the band route's bit for bit, with and without
    distances, and the plain version's."""
    words = _small_words()
    qs = [q for q in words for _ in words]
    ds = [d for _ in words for d in words]
    arrays = _word_pairs(qs, ds, L)
    for distances in (True, False):
        got = _host_pairs(host_lib, arrays, distances, blocks=97)
        band = _band_pairs(host_lib, arrays, distances)
        bad = np.argwhere(got != band)
        assert bad.size == 0, [(qs[c], ds[c]) for _, _, c in bad[:3]]
        if distances:
            want = _pairs_plain(arrays, True).numpy()
            assert np.array_equal(got, want)
            # the pairs reach every value of every distance
            for k, shift in enumerate(_kernels.PAIR_DIST_SHIFTS):
                assert set(np.unique((got >> shift) & 7)) == (
                    {0, 1, 2, 3, 4} if k == 1 else {0, 1, 2, 3}), NAMES[k]


@pytest.mark.parametrize("L,max_len", [(24, 24), (12, 12), (12, 24)],
                         ids=["L24", "L12", "L12_past_the_table"])
def test_bit_parallel_distances_on_random_pairs(host_lib, L, max_len):
    """100,000 seeded pairs of 0-``max_len`` chars (over 3 letters and over
    26, a third of them one substitution apart; past L where ``max_len``
    exceeds it): the kernel's words equal the band route's bit for bit,
    and the plain version's (past L: their distances)."""
    rng = np.random.default_rng(L * 100 + max_len)
    n = 100_000

    def word(k):
        return list(97 + rng.integers(3 if k % 2 else 26,
                                      size=rng.integers(0, max_len + 1)))

    qs = [word(k) for k in range(n)]
    ds = [word(k) for k in range(n)]
    for k in range(0, n, 3):
        d = list(qs[k])
        if d and rng.integers(2):
            d[rng.integers(len(d))] = 97 + rng.integers(3)
        ds[k] = d
    arrays = _word_pairs(qs, ds, L)
    for distances in (True, False):
        got = _host_pairs(host_lib, arrays, distances, blocks=41)
        assert np.array_equal(got, _band_pairs(host_lib, arrays, distances))
        want = _pairs_plain(arrays, distances).numpy()
        if max_len > L:
            # past the table the relations are not defined (the tables
            # write lengths of at most L); the distances are
            got, want = got >> 16, want >> 16
        assert np.array_equal(got, want)


def test_cpu_tensors_never_reach_the_kernel_wrapper():
    z = torch.zeros((1, 12, 1), dtype=torch.int32)
    zt = z.permute(1, 0, 2).contiguous()
    with pytest.raises(ValueError):
        _kernels.coverage_pairs(z, z, z[:, 0], zt, zt, z[:, 0], z[:, 0] > 0,
                                True)
    with pytest.raises(ValueError):
        _kernels.coverage_pair_block((z, z, z[:, 0]), (z, z, z[:, 0]), zt, zt,
                                     z[:, 0], z[:, 0] > 0)


# --- one query token against [C, D] doc tokens (ops/editdistance.py) -------


def _single_inputs(seed, L, lq):
    """A query of up to ``lq`` chars and [4, 6] doc words over three
    letters (edits of the query among them), zero-padded to ``L`` chars;
    some doc lengths run past L (their chars cut at L), some words are
    empty."""
    rng = np.random.default_rng(seed)
    ql = int(rng.integers(0, lq + 1))
    q = list(97 + rng.integers(0, 3, ql))
    words = []
    for i in range(24):
        w = (_edit(rng, q, int(rng.integers(1, 3))) if i % 2
             else list(97 + rng.integers(0, 3, int(rng.integers(0, L + 3)))))
        words.append(w)
    chars = np.zeros((4, 6, L), np.int32)
    lens = np.zeros((4, 6), np.int32)
    for i, w in enumerate(words):
        lens.flat[i] = len(w)
        chars[i // 6, i % 6, :min(len(w), L)] = w[:L]
    q_arr = np.zeros(lq, np.int32)
    q_arr[:ql] = q[:lq]
    return q_arr, np.int32(ql), chars, lens, q, words


#: (L, Lq): the reference test's shape, and L below and above the query
#: width
SINGLE_SHAPES = [(16, 16), (6, 12), (12, 8)]


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("shape", SINGLE_SHAPES,
                         ids=lambda s: "L%d_lq%d" % s)
def test_single_token_distances_equal_the_reference(shape, seed):
    L, lq = shape
    q_arr, ql, chars, lens, q, words = _single_inputs(
        10 * seed + SINGLE_SHAPES.index(shape), L, lq)
    for budget in (0, 1, 2, 3):
        got = port_single.batched_levenshtein(q_arr, ql, chars, lens,
                                              budget=budget, l_max=L)
        want = ref_single.batched_levenshtein(q_arr, ql, chars, lens,
                                              budget=budget, l_max=L)
        assert got.dtype == torch.int32 and got.shape == (4, 6)
        assert np.array_equal(got.numpy(), np.asarray(want))
    for md in (0, 1, 2, 3):
        got = port_single.batched_damerau(q_arr, ql, chars, lens,
                                          max_distance=md, l_max=L)
        want = ref_single.batched_damerau(q_arr, ql, chars, lens,
                                          max_distance=md, l_max=L)
        assert np.array_equal(got.numpy(), np.asarray(want)), md
    # both sides per pair: each doc word against the reversed next one
    rev = np.ascontiguousarray(chars[:, :, ::-1])
    for budget in (0, 2):
        got = port_single._batched_lev_pairwise(chars, lens, rev, lens,
                                                budget=budget, l_max=L)
        want = ref_single._batched_lev_pairwise(
            jnp.asarray(chars), jnp.asarray(lens), jnp.asarray(rev),
            jnp.asarray(lens), budget=budget, l_max=L)
        assert np.array_equal(got.numpy(), np.asarray(want))


def test_single_token_distances_equal_the_scalar_oracles():
    """Words of at most L chars: Levenshtein clamped at budget + 1 equals
    ``levenshtein``; Damerau agrees with ``calculate_damerau`` on every
    pair within the max distance (both clamp differently above it)."""
    L, lq = 16, 16
    hits = 0
    for seed in range(6):
        q_arr, ql, chars, lens, q, words = _single_inputs(100 + seed, L, lq)
        qs = "".join(map(chr, q))
        ws = ["".join(map(chr, w[:L])) for w in words]
        lens = np.minimum(lens, L)
        lev = port_single.batched_levenshtein(q_arr, ql, chars, lens,
                                              budget=3, l_max=L).numpy()
        dam = port_single.batched_damerau(q_arr, ql, chars, lens,
                                          max_distance=2, l_max=L).numpy()
        for i, w in enumerate(ws):
            assert lev.flat[i] == min(levenshtein(qs, w), 4), (qs, w)
            want = calculate_damerau(qs, w, 2)
            assert (dam.flat[i] <= 2) == (want <= 2), (qs, w)
            if want <= 2:
                assert dam.flat[i] == want, (qs, w)
                hits += 1
    assert hits > 20


def test_propagate_insertions_equals_the_reference():
    rng = np.random.default_rng(3)
    row = rng.integers(0, 9, (3, 5, 17)).astype(np.int32)
    got = port_single._propagate_insertions(torch.from_numpy(row))
    want = ref_single._propagate_insertions(jnp.asarray(row))
    assert np.array_equal(got.numpy(), np.asarray(want))


# --- pair words: the relations beside the distances ------------------------

REL_NAMES = ("EQ", "D_SW_Q", "D_EW_Q", "Q_EW_D", "D_CONT_Q", "Q_SW_D",
             "common_prefix")


def _pair_inputs(seed, Q, D, L, case):
    """``_inputs`` plus the doc tokens' validity: a quarter invalid, and
    (as in the coverage program) every empty doc token of the
    ``empty_doc_tokens`` case."""
    arrays = _inputs(seed, Q, D, L, case)
    rng = np.random.default_rng(seed + 5)
    valid = rng.integers(4, size=arrays[5].shape) > 0
    if case == "empty_doc_tokens":
        valid &= arrays[5] > 0
    return arrays + (valid,)


def _pairs_plain(arrays, distances):
    return port_ck.coverage_pairs_plain(
        *(torch.from_numpy(a) for a in arrays), distances)


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_plain_relations_equal_the_reference(shape, case):
    """``_pairwise_primitives`` and ``_q_startswith_d_t`` against the JAX
    functions, and the pair word's fields against both."""
    arrays = _pair_inputs(3000 + _seed(shape, case), *shape, case)
    qc, qr, ql, dc, dr, dl, valid = (jnp.asarray(a) for a in arrays)
    want = list(ref_ck._pairwise_primitives(qc, ql, qr, dc, dr, dl, valid))
    want.insert(5, ref_ck._q_startswith_d_t(qc, ql, dc, dl, valid))
    pairs = _pairs_plain(arrays, True)
    assert pairs.dtype == torch.int32 and (pairs >= 0).all()
    got = port_ck.unpack_relations(pairs)
    for name, g, w in zip(REL_NAMES, got, want):
        assert np.array_equal(g.numpy(), np.asarray(w)), name
    for name, g, w in zip(NAMES, port_ed.unpack_distances(pairs),
                          _plain(arrays[:6])):
        assert np.array_equal(g.numpy(), w), name
    # without distances: the same relation fields, no distance bits
    bare = _pairs_plain(arrays, False)
    assert torch.equal(bare, pairs & 0xFFFF)
    # the dispatcher takes the plain version for CPU tensors
    assert torch.equal(pairs, port_ck.coverage_pairs(
        *(torch.from_numpy(a) for a in arrays), True))
    if case in ("equal_words", "one_transposition"):
        assert got[0].any() and got[4].any()


@pytest.mark.parametrize("distances", [True, False],
                         ids=["with_distances", "relations_only"])
@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_pair_cell_code_equals_the_plain_version(host_lib, shape, case,
                                                 distances):
    arrays = _pair_inputs(4000 + _seed(shape, case), *shape, case)
    want = _pairs_plain(arrays, distances).numpy()
    for blocks in (1, 7, 1000):     # tiles of up to 16, 2 and 1 candidates
        got = _host_pairs(host_lib, arrays, distances, blocks)
        bad = np.argwhere(got != want)
        assert bad.size == 0, (blocks, bad[:5], got[tuple(bad[0])],
                               want[tuple(bad[0])])


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_pair_block_code_equals_the_plain_version(host_lib, shape, case):
    """One launch for a coverage block's two sets of query tokens: the Q
    tokens' words with distances and the fusion tokens' (other words, a
    different count) without, each equal to its plain call."""
    arrays = _pair_inputs(6000 + _seed(shape, case), *shape, case)
    Q, D, L = shape
    fq = _pair_inputs(7000 + _seed(shape, case), Q // 2 + 1, D, L, case)
    q_set = [torch.from_numpy(a) for a in arrays[:3]]
    fq_set = [torch.from_numpy(a) for a in fq[:3]]
    doc = [torch.from_numpy(a) for a in arrays[3:]]
    host_lib.set_tile_blocks(5)
    got, f_got = _kernels.coverage_pair_block(q_set, fq_set, *doc,
                                              lib=host_lib)
    assert torch.equal(got, _pairs_plain(arrays, True))
    assert torch.equal(f_got, _pairs_plain(fq[:3] + arrays[3:], False))
    assert torch.equal(got, torch.from_numpy(
        _host_pairs(host_lib, arrays, True)))
    # the CPU dispatcher: the plain version twice
    want = port_ck.coverage_pair_block(q_set, fq_set, *doc)
    assert torch.equal(want[0], got) and torch.equal(want[1], f_got)


def test_known_relations():
    """Hand-checked pairs: 'abcd' against itself, a longer word that
    starts with it, one that ends with it, one that contains it, its own
    prefix and suffix, an unrelated word, an empty doc token and an
    invalid one; and an empty query word."""
    L, Q, D = 12, 4, 16
    qc = np.zeros((Q, L, 1), np.int32)
    qr, dc = qc.copy(), np.zeros((L, D, 1), np.int32)
    dr = dc.copy()
    ql, dl = np.zeros((Q, 1), np.int32), np.zeros((D, 1), np.int32)
    valid = np.ones((D, 1), bool)
    q = b"abcd"
    words = [b"abcd", b"abcdxy", b"xyabcd", b"xabcdy", b"ab", b"cd", b"wxyz",
             b"", b"abcd"]
    valid[8] = False
    qc[0, :4, 0], qr[0, :4, 0], ql[0, 0] = list(q), list(q[::-1]), 4
    for d, w in enumerate(words):
        dc[:len(w), d, 0], dr[:len(w), d, 0] = list(w), list(w[::-1])
        dl[d, 0] = len(w)
    valid[len(words):] = False
    eq, d_sw_q, d_ew_q, q_ew_d, d_cont_q, q_sw_d, cp = (
        t.numpy()[:, :len(words), 0] for t in port_ck.unpack_relations(
            _pairs_plain((qc, qr, ql, dc, dr, dl, valid), False)))
    t, f = True, False
    assert eq[0].tolist() == [t, f, f, f, f, f, f, f, f]
    assert d_sw_q[0].tolist() == [t, t, f, f, f, f, f, f, f]
    assert d_ew_q[0].tolist() == [t, f, t, f, f, f, f, f, f]
    assert q_ew_d[0].tolist() == [t, f, f, f, f, t, f, t, f]
    assert d_cont_q[0].tolist() == [t, t, t, t, f, f, f, f, f]
    assert q_sw_d[0].tolist() == [t, f, f, f, t, f, f, t, f]
    assert cp[0].tolist() == [4, 4, 0, 0, 2, 0, 0, 0, 4]
    # the empty query word: starts, ends and is contained in every valid
    # doc word, equals the empty one
    assert eq[1].tolist() == [f, f, f, f, f, f, f, t, f]
    assert d_sw_q[1].tolist() == d_cont_q[1].tolist() == [t] * 8 + [f]
    assert q_sw_d[1].tolist() == [f] * 7 + [t, f]
    assert not cp[1].any()


@pytest.mark.gpu
@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_cuda_kernel_matches_plain_version(shape, case):
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    arrays = _inputs(2000 + _seed(shape, case), *shape, case)
    want = _plain(arrays)
    cuda = [torch.from_numpy(a).cuda() for a in arrays]
    n0 = _kernels.launch_counts["coverage_pairs"]
    got = [port_ed.unpack_distances(_pairs(port_ck.coverage_pairs, cuda))
           for _ in range(2)]
    torch.cuda.synchronize()
    assert _kernels.launch_counts["coverage_pairs"] == n0 + 2
    for outs in got:
        for name, g, w in zip(NAMES, outs, want):
            assert np.array_equal(g.cpu().numpy(), w), name
    # a char width the kernel is not built for raises, it does not fall back
    bad = [t[:, :8].contiguous() if t.dim() == 3 and t.shape[1] in (12, 24)
           else (t[:8].contiguous() if t.dim() == 3 else t) for t in cuda]
    with pytest.raises(ValueError):
        _pairs(port_ck.coverage_pairs, bad)


@pytest.mark.gpu
@pytest.mark.parametrize("distances", [True, False],
                         ids=["with_distances", "relations_only"])
@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_cuda_pair_kernel_matches_plain_version(shape, case, distances):
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    arrays = _pair_inputs(5000 + _seed(shape, case), *shape, case)
    want = _pairs_plain(arrays, distances)
    cuda = [torch.from_numpy(a).cuda() for a in arrays]
    n0 = _kernels.launch_counts["coverage_pairs"]
    got = [port_ck.coverage_pairs(*cuda, distances) for _ in range(2)]
    torch.cuda.synchronize()
    assert _kernels.launch_counts["coverage_pairs"] == n0 + 2
    for g in got:
        assert torch.equal(g.cpu(), want)


@pytest.mark.gpu
@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_cuda_pair_block_matches_plain_version(shape, case):
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    arrays = _pair_inputs(8000 + _seed(shape, case), *shape, case)
    Q, D, L = shape
    fq = _pair_inputs(9000 + _seed(shape, case), Q // 2 + 1, D, L, case)
    want = (_pairs_plain(arrays, True),
            _pairs_plain(fq[:3] + arrays[3:], False))
    q_set = [torch.from_numpy(a).cuda() for a in arrays[:3]]
    fq_set = [torch.from_numpy(a).cuda() for a in fq[:3]]
    doc = [torch.from_numpy(a).cuda() for a in arrays[3:]]
    n0 = _kernels.launch_counts["coverage_pairs"]
    got = port_ck.coverage_pair_block(q_set, fq_set, *doc)
    torch.cuda.synchronize()
    assert _kernels.launch_counts["coverage_pairs"] == n0 + 1
    assert torch.equal(got[0].cpu(), want[0])
    assert torch.equal(got[1].cpu(), want[1])
