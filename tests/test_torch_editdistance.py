"""The Stage-2 edit distances of the port
(infidex_tpu_torch/ops/editdistance_multi.py ``coverage_distances_plain``)
and the pair words that carry them beside the word relations
(infidex_tpu_torch/ops/coverage_kernel.py ``coverage_pairs``) against the
reference.

* ``coverage_distances_plain`` against the JAX composition (the functions of
  infidex_tpu/ops/editdistance_multi.py called as
  infidex_tpu/ops/coverage_kernel.py:640-662 calls them, on the CPU): all
  five tensors exactly equal (integers, tolerance 0);
* the CUDA kernel's per-cell code (``pair_cell`` of
  csrc/edit_distances_cell.cuh, the header csrc/coverage_pairs.cu includes),
  compiled for the host with g++ and run over every cell, its distance
  fields against the plain distances: exactly equal;
* the plain word relations (``_pairwise_primitives``, ``_q_startswith_d_t``)
  against the JAX functions of the same names, and the pair word's
  packing: exactly equal;
* the same code's whole pair word, with and without distances, against
  ``coverage_pairs_plain``: exactly equal;
* on a card, the kernel against the plain version: exactly equal.

Inputs are made with numpy from a seed: words over a five-letter alphabet,
query words derived from their candidate's doc words by edits, at the
coverage program's three shape classes.
"""

import ctypes
import os
import shutil
import subprocess

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from infidex_tpu.ops import coverage_kernel as ref_ck
from infidex_tpu.ops import editdistance_multi as ref_ed
from infidex_tpu_torch import runtime
from infidex_tpu_torch.ops import _kernels
from infidex_tpu_torch.ops import coverage_kernel as port_ck
from infidex_tpu_torch.ops import editdistance_multi as port_ed

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


# --- the kernel's per-cell code, compiled for the host ---------------------

_HOST_LOOP = r"""
#include "edit_distances_cell.cuh"
template <int L, bool DIST>
static void run_pairs(const int* qc, const int* qr, const int* ql,
                      const int* dc, const int* dr, const int* dl,
                      const unsigned char* valid, int n_q, int n_d, int n_c,
                      int* out) {
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
extern "C" int coverage_pairs_host(const int* qc, const int* qr,
    const int* ql, const int* dc, const int* dr, const int* dl,
    const unsigned char* valid, int n_q, int n_l, int n_d, int n_c,
    int with_distances, int* out) {
  if (n_l == 12 && with_distances)
    run_pairs<12, true>(qc, qr, ql, dc, dr, dl, valid, n_q, n_d, n_c, out);
  else if (n_l == 12)
    run_pairs<12, false>(qc, qr, ql, dc, dr, dl, valid, n_q, n_d, n_c, out);
  else if (n_l == 24 && with_distances)
    run_pairs<24, true>(qc, qr, ql, dc, dr, dl, valid, n_q, n_d, n_c, out);
  else if (n_l == 24)
    run_pairs<24, false>(qc, qr, ql, dc, dr, dl, valid, n_q, n_d, n_c, out);
  else return 1;
  return 0;
}
"""


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    """csrc/edit_distances_cell.cuh compiled with g++ behind loops over
    the cells in the kernels' own addressing."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("no g++")
    tmp = tmp_path_factory.mktemp("pair_cell")
    src, so = tmp / "cells.cpp", tmp / "libpair_cell.so"
    src.write_text(_HOST_LOOP)
    subprocess.run([gxx, "-O1", "-std=c++17", "-shared", "-fPIC", "-I",
                    os.path.join(os.path.dirname(_kernels.__file__), "..",
                                 "csrc"), "-o", str(so), str(src)],
                   check=True, capture_output=True, text=True)
    lib = ctypes.CDLL(str(so))
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.coverage_pairs_host.argtypes = [p] * 7 + [i] * 5 + [p]
    lib.coverage_pairs_host.restype = i
    return lib


@pytest.fixture(scope="module")
def host_cell(host_lib):
    """``pair_cell`` over every cell, every doc token valid: the five
    distance fields of its pair words."""
    lib = host_lib

    def run(qc, qr, ql, dc, dr, dl):
        arrays = [np.ascontiguousarray(a, np.int32)
                  for a in (qc, qr, ql, dc, dr, dl)]
        n_q, n_l, n_c = arrays[0].shape
        n_d = arrays[3].shape[1]
        valid = np.ones((n_d, n_c), np.uint8)
        out = np.full((n_q, n_d, n_c), -7, np.int32)
        rc = lib.coverage_pairs_host(*(a.ctypes.data for a in arrays),
                                     valid.ctypes.data, n_q, n_l, n_d, n_c, 1,
                                     out.ctypes.data)
        assert rc == 0 and (out >= 0).all()
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


def test_cpu_tensors_never_reach_the_kernel_wrapper():
    z = torch.zeros((1, 12, 1), dtype=torch.int32)
    with pytest.raises(ValueError):
        _kernels.coverage_pairs(z, z, z[:, 0], z.permute(1, 0, 2).contiguous(),
                                z.permute(1, 0, 2).contiguous(), z[:, 0],
                                z[:, 0] > 0, True)


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


@pytest.fixture(scope="module")
def host_pairs(host_lib):
    """``pair_cell`` over every cell: the pair words."""

    def run(arrays, distances):
        arrays = [np.ascontiguousarray(a, np.uint8 if a.dtype == bool
                                       else np.int32) for a in arrays]
        n_q, n_l, n_c = arrays[0].shape
        n_d = arrays[3].shape[1]
        out = np.full((n_q, n_d, n_c), -7, np.int32)
        rc = host_lib.coverage_pairs_host(
            *(a.ctypes.data for a in arrays), n_q, n_l, n_d, n_c,
            int(distances), out.ctypes.data)
        assert rc == 0
        return out

    return run


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
def test_pair_cell_code_equals_the_plain_version(host_pairs, shape, case,
                                                 distances):
    arrays = _pair_inputs(4000 + _seed(shape, case), *shape, case)
    got = host_pairs(arrays, distances)
    want = _pairs_plain(arrays, distances).numpy()
    bad = np.argwhere(got != want)
    assert bad.size == 0, (bad[:5], got[tuple(bad[0])], want[tuple(bad[0])])


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
