"""The device fake-LCS of the port
(infidex_tpu_torch/ops/coverage_kernel.py ``coverage_lcs``).

* the CUDA kernel's per-candidate code (csrc/coverage_lcs_cell.cuh, the
  header csrc/coverage_lcs.cu includes), compiled for the host with g++ and
  run over every candidate by a group of lanes (the kernel's warp of 32,
  and groups of 8 and 1; csrc/lane_group.cuh runs a group as a loop over
  its lanes on the host), against the plain PyTorch version
  ``coverage_lcs_plain``: equal on every candidate (integers until the last
  cast, tolerance 0), the host value kept where the doc or the query is not
  eligible; also on hand-made candidates whose containments and first
  mismatches lie past lane 31;
* the same code against the JAX package's host LCS (utils/metrics.py
  ``lcs``) and its device program (tests/test_device_lcs.py) on every
  eligible (doc, query) pair;
* on a card, the kernel against the plain version: the same.

Inputs are made from a seed: texts over a six-letter alphabet and spaces, a
few real titles, an empty text and one with a surrogate pair; queries cut
from the texts (contained), edited (a shared prefix) or drawn at random, at
the pipeline's two query widths (16 and 64 code units) and three text
widths (the 64, 192 and 256 buckets).
"""

import ctypes
import os
import random
import shutil
import subprocess

import numpy as np
import pytest
import torch

from tests import test_device_lcs as ref_lcs
from infidex_tpu.utils.metrics import lcs as lcs_host
from infidex_tpu_torch import runtime
from infidex_tpu_torch.ops import _kernels
from infidex_tpu_torch.ops import coverage_kernel as ck

runtime.set_device("cpu")
# the suite runs in several worker processes on shared cores; one intra-op
# thread each keeps torch from oversubscribing them
torch.set_num_threads(1)

CSRC = os.path.join(os.path.dirname(_kernels.__file__), "..", "csrc")
ALPHA = "abcdef "


def compile_cell(tmp_path_factory, name: str, source: str):
    """``source`` (C++ that includes a cell header of csrc/) built with g++
    -ffp-contract=off into a shared library; skips without g++."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("no g++")
    tmp = tmp_path_factory.mktemp(name)
    src, so = tmp / f"{name}.cpp", tmp / f"lib{name}.so"
    src.write_text(source)
    subprocess.run([gxx, "-O1", "-std=c++17", "-ffp-contract=off", "-shared",
                    "-fPIC", "-I", CSRC, "-o", str(so), str(src)],
                   check=True, capture_output=True, text=True)
    return ctypes.CDLL(str(so))


_HOST_LOOP = r"""
#include <vector>
#include "coverage_lcs_cell.cuh"
// a unit of the scratch that the group did not copy reads as this: no char
template <int G>
static void run(const int* text_chars, const unsigned char* lcs_ok,
    const int* q_text, const int* q_text_len, const int* q_tol,
    const unsigned char* q_ok, const long long* text_ids,
    const long long* qsel, const int* text_len, const float* lcs_in,
    int t_cap, int qt_cap, int n_c, float* out) {
  std::vector<int> scratch(lcs::scratch_ints(t_cap, qt_cap));
  const grp::Group<G> g;
  for (int c = 0; c < n_c; ++c) {
    scratch.assign(scratch.size(), 0x7f7f7f7f);
    out[c] = lcs::candidate(g, scratch.data(), text_chars, lcs_ok, q_text,
                            q_text_len, q_tol, q_ok, text_ids, qsel,
                            text_len, lcs_in, t_cap, qt_cap, c);
  }
}
extern "C" int coverage_lcs_host(const int* text_chars,
    const unsigned char* lcs_ok, const int* q_text, const int* q_text_len,
    const int* q_tol, const unsigned char* q_ok, const long long* text_ids,
    const long long* qsel, const int* text_len, const float* lcs_in, int t_cap,
    int qt_cap, int n_c, float* out, int lanes) {
#define LCS_RUN(G) run<G>(text_chars, lcs_ok, q_text, q_text_len, q_tol, \
    q_ok, text_ids, qsel, text_len, lcs_in, t_cap, qt_cap, n_c, out)
  if (lanes == 32) LCS_RUN(32);
  else if (lanes == 8) LCS_RUN(8);
  else if (lanes == 1) LCS_RUN(1);
  else return 1;
  return 0;
}
"""

#: lanes of the kernel's group (a warp), and two other group sizes the host
#: build runs the same code with
KERNEL_LANES = 32
LANES = (KERNEL_LANES, 8, 1)


@pytest.fixture(scope="module")
def host_lcs(tmp_path_factory):
    """csrc/coverage_lcs_cell.cuh behind a loop over the candidates, in the
    kernel's own addressing, a group of ``lanes`` lanes (a loop over them)
    per candidate; takes ``coverage_lcs``'s arguments."""
    lib = compile_cell(tmp_path_factory, "lcs_cell", _HOST_LOOP)
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.coverage_lcs_host.argtypes = [p] * 10 + [i] * 3 + [p, i]
    lib.coverage_lcs_host.restype = i

    def run(args, lanes=KERNEL_LANES):
        arrays = [np.ascontiguousarray(t.numpy()) for t in args]
        n_t, n_qt, n_c = arrays[0].shape[1], arrays[2].shape[1], len(arrays[6])
        out = np.full(n_c, -7.0, np.float32)
        rc = lib.coverage_lcs_host(*(a.ctypes.data for a in arrays), n_t,
                                   n_qt, n_c, out.ctypes.data, lanes)
        assert rc == 0
        return torch.from_numpy(out)

    return run


def _texts(rng, n, longest):
    texts = ["".join(rng.choice(ALPHA) for _ in range(rng.randrange(1, longest)))
             for _ in range(n)]
    texts += ["dark knight rises", "zelena skola", "abc", "", "a\U0001F600b"]
    return texts


def _queries(rng, texts, n, cap):
    out = []
    while len(out) < n:
        src = rng.choice([t for t in texts if t] or ["abc"])
        kind = rng.randrange(4)
        if kind == 0:                                     # contained
            i = rng.randrange(len(src))
            q = src[i:i + rng.randrange(1, cap + 1)]
        elif kind == 1:                                   # shared prefix
            q = src[:rng.randrange(1, cap)] + rng.choice(ALPHA)
        elif kind == 2:
            q = "".join(rng.choice(ALPHA) for _ in range(rng.randrange(1, cap)))
        else:
            q = "".join(rng.choice(ALPHA) for _ in range(rng.randrange(cap, 80)))
        out.append(q.strip() or "a")
    return out


def make_block(seed, longest, qt, n_c=400):
    """``coverage_lcs``'s arguments (CPU tensors) for ``n_c`` candidates and
    the texts and queries they were made from."""
    rng = random.Random(seed)
    texts = _texts(rng, 40, longest)
    queries = _queries(rng, texts, 12, qt)
    tables = ck.CoverageTables.build(texts, {" "}, device="cpu")
    enc = [ck.encode_query_lcs(q) for q in queries]
    text_ids = np.array([rng.randrange(len(texts)) for _ in range(n_c)],
                        np.int64)
    qsel = np.array([rng.randrange(len(queries)) for _ in range(n_c)],
                    np.int64)
    host = np.array([rng.randrange(0, 9) for _ in range(n_c)], np.float32)
    t = torch.from_numpy
    args = (tables.text_chars, tables.lcs_ok,
            t(np.stack([e[0][:qt] for e in enc]).astype(np.int32)),
            t(np.array([e[1] if e[1] <= qt else 0 for e in enc], np.int32)),
            t(np.array([rng.randrange(0, 3) for _ in enc], np.int32)),
            t(np.array([e[2] and e[1] <= qt for e in enc])),
            t(text_ids), t(qsel), tables.doc_text_len[t(text_ids)],
            t(host))
    return args, texts, queries


WIDTHS = {"t64": 50, "t192": 170, "t256": 250}


@pytest.mark.parametrize("qt", [16, 64])
@pytest.mark.parametrize("width", list(WIDTHS))
@pytest.mark.parametrize("seed", [0, 1])
def test_lcs_cell_code_equals_the_plain_version(host_lcs, width, qt, seed):
    args, texts, _ = make_block(seed, WIDTHS[width], qt)
    assert args[0].shape[1] == int(width[1:])
    want = ck.coverage_lcs_plain(*args)
    got = host_lcs(args)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    # ineligible candidates keep their host value; some are, some are not
    eligible = args[1][args[6].long()] & args[5][args[7].long()]
    assert torch.equal(got[~eligible], args[9][~eligible])
    assert eligible.any() and (~eligible).any()
    # the dispatcher takes the plain version for CPU tensors
    assert torch.equal(ck.coverage_lcs(*args), want)


def test_lcs_cell_code_equals_the_host_lcs_and_the_jax_program(host_lcs):
    """Every (doc, query) pair of tests/test_device_lcs.py's random strings:
    the cell's value equals utils/metrics.lcs and the JAX device program on
    every eligible pair, at each tolerance."""
    rng = random.Random(7)
    alpha = "abcdef "
    texts = ["".join(rng.choice(alpha) for _ in range(rng.randrange(1, 40)))
             for _ in range(40)]
    texts += ["dark knight rises", "zelena skola", "abc", ""]
    queries = ["dark", "dark kni", "zelena", "ab", "q", "knight", "zelena sk",
               "abc d"] + ["".join(rng.choice(alpha) for _ in range(5))
                           for _ in range(8)]
    lower = [t.lower() for t in texts]
    tables = ck.CoverageTables.build(lower, {" "}, device="cpu")
    enc = [ck.encode_query_lcs(q.lower()) for q in queries]
    for tol in (0, 1, 2):
        pairs, jax_vals, eligible = ref_lcs._device_lcs(texts, queries, tol)
        text_ids = np.array([p[0] for p in pairs], np.int64)
        qsel = np.array([p[1] for p in pairs], np.int64)
        t = torch.from_numpy
        args = (tables.text_chars, tables.lcs_ok,
                t(np.stack([e[0] for e in enc]).astype(np.int32)),
                t(np.array([e[1] for e in enc], np.int32)),
                t(np.full(len(enc), tol, np.int32)),
                t(np.array([e[2] for e in enc])), t(text_ids), t(qsel),
                tables.doc_text_len[t(text_ids)],
                t(np.full(len(pairs), -1.0, np.float32)))
        got = host_lcs(args).numpy()
        assert eligible.sum() > 100
        for r, (d, q) in enumerate(pairs):
            if eligible[r]:
                assert got[r] == jax_vals[r] == lcs_host(queries[q].lower(),
                                                         lower[d], tol)
            else:
                assert got[r] == -1.0


def _units(s):
    return [ord(ch) for ch in s]


def hand_block(t_cap, qt_cap, seed=11):
    """``coverage_lcs``'s arguments for hand-made candidates that make a
    group's lanes loop: containments and first mismatches at offsets past
    lane 31, queries longer than their texts, texts longer than their rows
    (zeros past the row's end), empty texts and queries, ineligible docs
    and queries. Returns the arguments and the case names."""
    rng = random.Random(seed)
    text = lambda n: "".join(rng.choice("abcdef") for _ in range(n))
    long_text = text(t_cap)
    cases = []            # (name, text units, text_len, query units, qtl,
    #                        tol, doc ok, query ok)

    def add(name, t, q, tol=1, doc_ok=True, q_ok=True, t_len=None,
            q_len=None):
        cases.append((name, t, len(t) if t_len is None else t_len, q,
                      len(q) if q_len is None else q_len, tol, doc_ok, q_ok))

    for at in (0, 31, 32, 40, 63, 64, t_cap - 20):
        if at + 12 <= t_cap:
            add(f"contained_at_{at}", _units(long_text),
                _units(long_text[at:at + 12]))
    short = long_text[:50]
    add("contained_at_the_last_offset", _units(short), _units(short[-9:]))
    add("query_longer_than_text", _units("abcab"), _units("abcabcab"))
    add("query_longer_than_text_mismatch", _units("abcab"), _units("abdab"),
        tol=2)
    if qt_cap > 40:
        add("first_mismatch_past_lane_31", _units(long_text[:120]),
            _units(long_text[:37] + "z" + long_text[38:50]), tol=3)
        add("whole_prefix_past_lane_31", _units(long_text[:45]),
            _units(long_text[:44] + "zz"), tol=0)
    add("no_common_prefix", _units(long_text[:60]), _units("zzzz"))
    # the row's last units, then zeros: the text runs on past the row
    tail = _units(long_text[-2:]) + [0, 0]
    add("text_past_the_row", _units(long_text), tail, t_len=t_cap + 9)
    add("empty_text", [], _units("abc"))
    add("empty_query", _units(long_text[:20]), [])
    add("doc_not_eligible", _units(short), _units(short[5:9]), doc_ok=False)
    add("query_not_eligible", _units(short), _units(short[5:9]),
        q_ok=False)
    n = len(cases)
    rows = np.zeros((n, t_cap), np.int32)
    qrows = np.zeros((n, qt_cap), np.int32)
    for r, (_, t, _, q, _, _, _, _) in enumerate(cases):
        rows[r, :min(len(t), t_cap)] = t[:t_cap]
        qrows[r, :min(len(q), qt_cap)] = q[:qt_cap]
    col = lambda k, dt: torch.from_numpy(np.array([c[k] for c in cases], dt))
    args = (torch.from_numpy(rows), col(6, bool), torch.from_numpy(qrows),
            col(4, np.int32), col(5, np.int32), col(7, bool),
            torch.arange(n, dtype=torch.int64),
            torch.arange(n, dtype=torch.int64), col(2, np.int32),
            torch.full((n,), 5.0))
    return args, [c[0] for c in cases]


@pytest.mark.parametrize("lanes", LANES)
@pytest.mark.parametrize("qt", [16, 64])
@pytest.mark.parametrize("t_cap", [64, 256])
def test_lane_groups_equal_the_plain_version(host_lcs, t_cap, qt, lanes):
    """The hand-made candidates with the kernel's group of 32 lanes and
    with groups of 8 and 1: equal to the plain version (tolerance 0)."""
    args, names = hand_block(t_cap, qt)
    want = ck.coverage_lcs_plain(*args)
    got = host_lcs(args, lanes)
    bad = [(n, float(g), float(w)) for n, g, w in zip(names, got, want)
           if g.view(torch.int32) != w.view(torch.int32)]
    assert not bad
    by_name = dict(zip(names, want.tolist()))
    for name, v in by_name.items():
        if name.startswith("contained"):
            assert v == int(args[3][names.index(name)]), name
    assert by_name["text_past_the_row"] == 4
    assert by_name["doc_not_eligible"] == by_name["query_not_eligible"] == 5
    assert by_name["empty_text"] == by_name["empty_query"] == 0
    assert by_name["query_longer_than_text"] == 5
    if qt > 40:
        assert by_name["first_mismatch_past_lane_31"] == 37 + 3
        assert by_name["whole_prefix_past_lane_31"] == 44


@pytest.mark.parametrize("lanes", LANES[1:])
@pytest.mark.parametrize("width", list(WIDTHS))
def test_smaller_groups_equal_the_plain_version(host_lcs, width, lanes):
    """The seeded blocks with groups of 8 and 1 lanes: the same values."""
    args, _, _ = make_block(4, WIDTHS[width], 64)
    assert torch.equal(host_lcs(args, lanes).view(torch.int32),
                       ck.coverage_lcs_plain(*args).view(torch.int32))


def test_cpu_tensors_never_reach_the_kernel_wrapper(monkeypatch):
    args, _, _ = make_block(3, 50, 16, n_c=20)
    with pytest.raises(ValueError):
        _kernels.coverage_lcs(*args)

    def refuse(*a):
        raise AssertionError("the kernel wrapper was called for CPU tensors")

    monkeypatch.setattr(_kernels, "coverage_lcs", refuse)
    assert torch.equal(ck.coverage_lcs(*args), ck.coverage_lcs_plain(*args))


@pytest.mark.gpu
@pytest.mark.parametrize("qt", [16, 64])
@pytest.mark.parametrize("width", list(WIDTHS))
def test_cuda_kernel_matches_plain_version(width, qt):
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    args, _, _ = make_block(5, WIDTHS[width], qt, n_c=3000)
    want = ck.coverage_lcs_plain(*args)
    cuda = [a.cuda() for a in args]
    n0 = _kernels.launch_counts["coverage_lcs"]
    got = [ck.coverage_lcs(*cuda) for _ in range(2)]
    torch.cuda.synchronize()
    assert _kernels.launch_counts["coverage_lcs"] == n0 + 2
    for g in got:
        assert torch.equal(g.cpu().view(torch.int32), want.view(torch.int32))
    # the plain version on the card gives the same bits as on the CPU
    assert torch.equal(ck.coverage_lcs_plain(*cuda).cpu(), want)
    # a query row wider than the text rows raises, it does not fall back
    with pytest.raises(ValueError):
        ck.coverage_lcs(cuda[0][:, :8].contiguous(), *cuda[1:])
