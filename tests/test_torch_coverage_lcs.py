"""The device fake-LCS of the port
(infidex_tpu_torch/ops/coverage_kernel.py ``coverage_lcs``).

* the CUDA kernel's per-candidate code (csrc/coverage_lcs_cell.cuh, the
  header csrc/coverage_lcs.cu includes), compiled for the host with g++ and
  run over every candidate, against the plain PyTorch version
  ``coverage_lcs_plain``: equal on every candidate (integers until the last
  cast, tolerance 0), the host value kept where the doc or the query is not
  eligible;
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
#include "coverage_lcs_cell.cuh"
extern "C" void coverage_lcs_host(const int* text_chars,
    const unsigned char* lcs_ok, const int* q_text, const int* q_text_len,
    const int* q_tol, const unsigned char* q_ok, const long long* text_ids,
    const long long* qsel, const int* text_len, const float* lcs_in, int t_cap,
    int qt_cap, int n_c, float* out) {
  for (int c = 0; c < n_c; ++c) {
    out[c] = lcs::candidate(text_chars, lcs_ok, q_text, q_text_len, q_tol,
                            q_ok, text_ids, qsel, text_len, lcs_in, t_cap,
                            qt_cap, c);
  }
}
"""


@pytest.fixture(scope="module")
def host_lcs(tmp_path_factory):
    """csrc/coverage_lcs_cell.cuh behind a loop over the candidates, in the
    kernel's own addressing; takes ``coverage_lcs``'s arguments."""
    lib = compile_cell(tmp_path_factory, "lcs_cell", _HOST_LOOP)
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.coverage_lcs_host.argtypes = [p] * 10 + [i] * 3 + [p]
    lib.coverage_lcs_host.restype = None

    def run(args):
        arrays = [np.ascontiguousarray(t.numpy()) for t in args]
        n_t, n_qt, n_c = arrays[0].shape[1], arrays[2].shape[1], len(arrays[6])
        out = np.full(n_c, -7.0, np.float32)
        lib.coverage_lcs_host(*(a.ctypes.data for a in arrays), n_t, n_qt,
                              n_c, out.ctypes.data)
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
