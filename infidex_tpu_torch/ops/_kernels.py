"""Loader and wrappers of the port's hand-written CUDA kernels.

Every ``.cu`` source under ``infidex_tpu_torch/csrc`` is compiled on
first use by one ``nvcc`` call for ``sm_90a`` into ONE shared library
with a plain C interface, under ``build/infidex_tpu_torch/`` at the
repository root (named by a hash of all the sources, the headers they
include and the flags, so an edit to any of them rebuilds), and bound
with ``ctypes``. Nothing is
built or imported from CUDA when this module is imported: the CPU tests
import it on machines without ``nvcc``.

Each wrapper checks device, dtype, shape and contiguity, launches on the
current PyTorch stream, raises if the launch fails, and counts its
launches in ``launch_counts``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
import time

import torch

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "infidex_tpu_torch")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC"]

#: vocabulary ids per block of the match kernel's first pass (kTile in
#: ``csrc/fuzzy_match.cu``); sizes the pass-mask scratch
FUZZY_TILE = 512

#: launches per kernel since the last reset (one per kernel launch)
launch_counts = {"stage1_scatter_lanes": 0, "fuzzy_match": 0,
                 "pool_score": 0, "coverage_gather": 0, "coverage_pairs": 0,
                 "coverage_cascade": 0, "coverage_lcs": 0,
                 "coverage_fusion": 0, "stage1_fuzzy": 0, "stage1_epilogue": 0,
                 "stage1_topk": 0, "stage1_lim": 0, "stage1_extras": 0}

#: char widths ``csrc/coverage_pairs.cu`` is compiled for (the coverage
#: program's L_CAP_SMALL and L_MAX)
PAIR_CHAR_WIDTHS = (12, 24)
#: doc-token widths ``csrc/coverage_cascade.cu`` is compiled for
#: (D_CAP_SMALL, D_CAP_NARROW, D_MAX) and its widest query-token axis
CASCADE_DOC_WIDTHS = (8, 16, 64)
CASCADE_Q_MAX = 16

#: The pair word of ``csrc/edit_distances_cell.cuh``: one int32 per (query
#: token, doc token, candidate). Bits 0-5 are the relations EQ, D_SW_Q,
#: D_EW_Q, Q_EW_D, D_CONT_Q, Q_SW_D; then the shift of the 5-bit
#: common-prefix length and the shifts of the five 3-bit distances (dam1,
#: dam2, pdam1, pdam2, pdam3).
PAIR_PREFIX_SHIFT = 8
PAIR_DIST_SHIFTS = (16, 19, 22, 25, 28)

_lib = None
_lock = threading.Lock()
#: what ``nvcc -Xptxas=-v`` reported when ``build(verbose=True)`` compiled
#: the library ("" otherwise)
ptxas_report = ""


def reset_launch_counts() -> None:
    for name in launch_counts:
        launch_counts[name] = 0


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin)")
    return path


def _sources(ext: str = ".cu") -> list:
    """The CUDA sources of the library (or, with ``ext=".cuh"``, the
    headers they include), in a fixed order."""
    return sorted(os.path.join(_CSRC, f) for f in os.listdir(_CSRC)
                  if f.endswith(ext))


def library_path() -> str:
    tag = hashlib.sha1(" ".join(NVCC_FLAGS).encode())
    for src in _sources() + _sources(".cuh"):
        with open(src, "rb") as f:
            tag.update(os.path.basename(src).encode() + b"\0" + f.read())
    return os.path.join(BUILD_DIR,
                        f"libinfidex_kernels.{tag.hexdigest()[:12]}.so")


def bind(lib):
    """Declare the argument and result types of the entry points that
    ``lib`` exports: the library built from ``csrc/``, or one built from
    some of its files (an earlier design with the same C interface).
    Returns ``lib``."""
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    for name, argtypes in (
            ("stage1_scatter_lanes", [p, p, p, p, p, p, p, i, p, p, i, i, p,
                                      p, p]),
            ("fuzzy_match", [p, p, p, p, p, p, p, i, i, i, i, p, p, p]),
            ("pool_score", [p, p, p, p, p, i, i, i, p, ctypes.c_longlong, p,
                            p, p, p, p]),
            ("coverage_pairs", [p, p, p, p, p, p, p, i, i, i, i, i, p, p]),
            ("coverage_pair_block", [p, p, p, i, p, p, p, i, p, p, p, p, i,
                                     i, i, p, p, p]),
            ("coverage_gather", [p] * 3 + [i] * 2 + [p] * 5 + [i] * 2
             + [p] * 5 + [i] * 2 + [p] * 3 + [i] + [p] * 2 + [i] * 3
             + [p] * 18),
            ("coverage_cascade", [p] * 10 + [i] * 4 + [p] * 9),
            ("coverage_lcs", [p] * 10 + [i] * 3 + [p, p]),
            ("coverage_fusion", [p] * 29 + [i] * 5 + [p, i, p, p]),
            ("stage1_fuzzy", [p, p, p, i, ll, p, i, i, p, ll, i, p, p]),
            ("stage1_epilogue", [p, p, ll, i, p, p, ll, p, p, p, p, i, p, p]),
            ("stage1_topk", [p, ll, i, i, i, i, i, p, ll, p, p, p]),
            ("stage1_lim", [p, ll, i, p, p, p, ll, p, p, p, i, ll, i, i, i, i,
                            p, i, i, p, p]),
            ("stage1_extras", [p, p, p, p, p, i, p]),
            ("stage1_topk_clusters", [i, i]),
            ("stage1_lim_clusters", [i])):
        if hasattr(lib, name):
            getattr(lib, name).argtypes = argtypes
            getattr(lib, name).restype = i
    if hasattr(lib, "stage1_error_string"):
        lib.stage1_error_string.argtypes = [i]
        lib.stage1_error_string.restype = ctypes.c_char_p
    return lib


def build(verbose: bool = False) -> float:
    """Compile the kernels if needed and load them; returns the seconds
    spent (0.0 when already loaded). ``verbose``: a compile also prints
    ptxas's resources and keeps them in ``ptxas_report``."""
    global _lib, ptxas_report
    with _lock:
        if _lib is not None:
            return 0.0
        t0 = time.perf_counter()
        so = library_path()
        if not os.path.exists(so):
            os.makedirs(BUILD_DIR, exist_ok=True)
            tmp = f"{so}.{os.getpid()}.tmp"
            cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, *_sources()]
            if verbose:
                cmd.insert(1, "-Xptxas=-v")
            res = subprocess.run(cmd, capture_output=True, text=True)
            if res.returncode != 0:
                raise RuntimeError(f"nvcc failed ({res.returncode}):\n"
                                   f"{res.stdout}\n{res.stderr}")
            if verbose:
                ptxas_report = res.stdout + res.stderr
                print(ptxas_report, flush=True)
            os.replace(tmp, so)
        lib = bind(ctypes.CDLL(so))
        _lib = lib
        return time.perf_counter() - t0


def ptxas_resources(report: str, *kernels) -> dict:
    """Registers, spill bytes and static shared memory of each kernel
    whose name contains one of ``kernels`` in an ``nvcc -Xptxas=-v``
    report, by kernel and template arguments (e.g.
    ``coverage_pairs_kernel<12>``)."""
    out, name = {}, None
    for line in report.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            name = None
            for kernel in kernels:
                if kernel in m.group(1):
                    args = re.findall(r"Li(\d+)E", m.group(1))
                    name = kernel + (f"<{', '.join(args)}>" if args else "")
            continue
        if name is None:
            continue
        row = out.setdefault(name, {})
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            row.update(spill_stores=int(m.group(1)),
                       spill_loads=int(m.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            row["registers"] = int(m.group(1))
            m = re.search(r"(\d+) bytes smem", line)
            row["static_smem"] = int(m.group(1)) if m else 0
    return out


def _check(name: str, t: torch.Tensor, dtype, dev) -> None:
    if t.device != dev:
        raise ValueError(f"{name}: on {t.device}, expected {dev}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if t.dim() != 1 or not t.is_contiguous():
        raise ValueError(f"{name}: must be a contiguous 1-D tensor")


def stage1_scatter_lanes(scores, cnt, qstart, off, vstart, vend, idf, base,
                         rank, postings_docs, cfac, doc_lo: int = 0,
                         doc_hi: int = (1 << 31) - 1) -> None:
    """``csrc/stage1_lanes.cu`` over a query-major chunk table (see
    ``ops/stage1_lanes.py``: rows ``qstart[q]:qstart[q+1]`` are query
    ``q``'s, in term-rank order), in place on ``scores`` and ``cnt``: ONE
    launch, one block per query. Only postings whose doc lies in
    ``[doc_lo, doc_hi)`` scatter, at key ``base + doc - doc_lo`` (by
    default every doc, at ``base + doc``). The caller guarantees that no
    two lanes of one term share a key, that different queries' keys
    differ, and that every key of the window lies inside ``scores``."""
    dev = scores.device
    if dev.type != "cuda":
        raise ValueError("stage1_scatter_lanes: CUDA tensors required")
    i32, f32 = torch.int32, torch.float32
    for name, t, dt in (("scores", scores, f32), ("cnt", cnt, f32),
                        ("qstart", qstart, i32), ("off", off, i32),
                        ("vstart", vstart, i32), ("vend", vend, i32),
                        ("idf", idf, f32), ("base", base, i32),
                        ("rank", rank, i32),
                        ("postings_docs", postings_docs, i32),
                        ("cfac", cfac, f32)):
        _check(name, t, dt, dev)
    if cnt.numel() != scores.numel() or cfac.numel() != postings_docs.numel():
        raise ValueError("stage1_scatter_lanes: mismatched sizes")
    if not (off.numel() == vstart.numel() == vend.numel() == idf.numel()
            == base.numel() == rank.numel()) or qstart.numel() < 1:
        raise ValueError("stage1_scatter_lanes: bad chunk table")
    n_q = qstart.numel() - 1
    if not 0 <= doc_lo <= doc_hi < (1 << 31):
        raise ValueError(f"stage1_scatter_lanes: bad doc window "
                         f"[{doc_lo}, {doc_hi})")
    if n_q == 0 or off.numel() == 0:
        return
    build()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = _lib.stage1_scatter_lanes(
            qstart.data_ptr(), off.data_ptr(), vstart.data_ptr(),
            vend.data_ptr(), idf.data_ptr(), base.data_ptr(),
            rank.data_ptr(), n_q, postings_docs.data_ptr(), cfac.data_ptr(),
            int(doc_lo), int(doc_hi), scores.data_ptr(), cnt.data_ptr(),
            stream)
    if rc != 0:
        raise RuntimeError("stage1_scatter_lanes launch failed: "
                           + _lib.stage1_error_string(rc).decode())
    launch_counts["stage1_scatter_lanes"] += 1


def fuzzy_match(sig, vpop, vlen, elig, qsig, qpop, qlen, cap: int):
    """``csrc/fuzzy_match.cu`` over T token rows and a vocabulary of V ids
    (see ``ops/fuzzy.py``): returns int32 [T, cap], each row the lowest
    ``cap`` passing ids ascending, padded with V. ``sig``/``qsig`` are
    int32 [V, 4] / [T, 4] packed signatures; ``vpop``, ``vlen``, ``qpop``,
    ``qlen`` int32; ``elig`` bool. One call launches the kernel's two
    passes (the vocabulary-tiled pass mask, then the per-row placement)
    and counts one launch."""
    dev = sig.device
    if dev.type != "cuda":
        raise ValueError("fuzzy_match: CUDA tensors required")
    i32 = torch.int32
    for name, t, dt in (("vpop", vpop, i32), ("vlen", vlen, i32),
                        ("elig", elig, torch.bool), ("qpop", qpop, i32),
                        ("qlen", qlen, i32)):
        _check(name, t, dt, dev)
    for name, t in (("sig", sig), ("qsig", qsig)):
        if t.device != dev or t.dtype != i32:
            raise TypeError(f"{name}: expected int32 on {dev}")
        if t.dim() != 2 or t.shape[1] != 4 or not t.is_contiguous():
            raise ValueError(f"{name}: must be a contiguous [n, 4] tensor")
    v_pad, n_rows = sig.shape[0], qsig.shape[0]
    if not (vpop.numel() == vlen.numel() == elig.numel() == v_pad
            and qpop.numel() == qlen.numel() == n_rows):
        raise ValueError("fuzzy_match: mismatched sizes")
    if not 0 < cap <= v_pad:
        raise ValueError(f"fuzzy_match: cap {cap} outside (0, {v_pad}]")
    out = torch.empty((n_rows, cap), dtype=i32, device=dev)
    if n_rows == 0:
        return out
    build()
    # scratch: the pass mask, one bit per (row, vocabulary id), in whole
    # tiles of FUZZY_TILE ids
    words = -(-v_pad // FUZZY_TILE) * (FUZZY_TILE // 32)
    mask = torch.empty((n_rows, words), dtype=i32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = _lib.fuzzy_match(
            sig.data_ptr(), vpop.data_ptr(), vlen.data_ptr(),
            elig.data_ptr(), qsig.data_ptr(), qpop.data_ptr(),
            qlen.data_ptr(), n_rows, v_pad, cap, words, mask.data_ptr(),
            out.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError("fuzzy_match launch failed: "
                           + _lib.stage1_error_string(rc).decode())
    launch_counts["fuzzy_match"] += 1
    return out


def pool_score(pool, pool_valid, term_starts, term_lens, term_idf,
               postings_docs, postings_weights, doc_lengths, avgdl, *,
               lib=None):
    """``csrc/pool_score.cu``: exact BM25+ of B host-selected pools (see
    ``ops/pool_score.py``). ``pool`` int32 [B, Pp] ascending doc ids,
    ``pool_valid`` bool [B, Pp]; ``term_starts``/``term_lens`` int32 and
    ``term_idf`` f32, each [B, T], over the full base CSR of
    ``postings_docs`` (int32) / ``postings_weights`` (uint8);
    ``doc_lengths`` f32 [n_pad] (every pool id below n_pad); ``avgdl`` a
    one-element f32 tensor. Returns f32 scores [B, Pp]. One launch, of
    ``lib``'s kernel when given (as in ``coverage_lcs``), else the
    port's."""
    dev = pool.device
    if dev.type != "cuda":
        raise ValueError("pool_score: CUDA tensors required")
    i32, f32 = torch.int32, torch.float32
    for name, t, dt in (("pool", pool, i32), ("pool_valid", pool_valid,
                                              torch.bool),
                        ("term_starts", term_starts, i32),
                        ("term_lens", term_lens, i32),
                        ("term_idf", term_idf, f32)):
        if t.device != dev or t.dtype != dt:
            raise TypeError(f"{name}: expected {dt} on {dev}")
        if t.dim() != 2 or not t.is_contiguous():
            raise ValueError(f"{name}: must be a contiguous 2-D tensor")
    for name, t, dt in (("postings_docs", postings_docs, i32),
                        ("postings_weights", postings_weights, torch.uint8),
                        ("doc_lengths", doc_lengths, f32),
                        ("avgdl", avgdl, f32)):
        _check(name, t, dt, dev)
    n_jobs, p_pad = pool.shape
    t_pad = term_starts.shape[1]
    if (pool_valid.shape != pool.shape or term_lens.shape != term_starts.shape
            or term_idf.shape != term_starts.shape
            or term_starts.shape[0] != n_jobs
            or postings_weights.numel() != postings_docs.numel()
            or avgdl.numel() != 1 or postings_docs.numel() == 0):
        raise ValueError("pool_score: mismatched sizes")
    if postings_weights.data_ptr() % 4:
        raise ValueError("pool_score: postings_weights must be 4-byte "
                         "aligned (the kernel copies it in words)")
    out = torch.empty((n_jobs, p_pad), dtype=f32, device=dev)
    if out.numel() == 0:
        return out
    build()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = (lib or _lib).pool_score(
            pool.data_ptr(), pool_valid.data_ptr(), term_starts.data_ptr(),
            term_lens.data_ptr(), term_idf.data_ptr(), n_jobs, p_pad, t_pad,
            postings_docs.data_ptr(), postings_docs.numel(),
            postings_weights.data_ptr(), doc_lengths.data_ptr(),
            avgdl.data_ptr(), out.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError("pool_score launch failed: "
                           + _lib.stage1_error_string(rc).decode())
    launch_counts["pool_score"] += 1
    return out


def _check_nd(name: str, t: torch.Tensor, dtype, shape, dev) -> None:
    if t.device != dev or t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype} on {dev}, got {t.dtype} "
                        f"on {t.device}")
    if tuple(t.shape) != tuple(shape) or not t.is_contiguous():
        raise ValueError(f"{name}: must be a contiguous tensor of shape "
                         f"{tuple(shape)}, got {tuple(t.shape)}")


def gather_dims(tables, queries, text_ids, qsel, L: int, D: int) -> dict:
    """The widths of one coverage block's gather (see
    ``coverage_gather``), after checking what the kernel takes: every
    tensor on one device, contiguous, of the dtype and shape below. Raises
    otherwise."""
    (word_chars, word_chars_rev, word_lens, doc_tokens, doc_tok_offsets,
     doc_tok_count, doc_adj_ws, doc_text_len) = tables
    (q_chars, q_chars_rev, q_lens, _, _, q_count, q_sorted, fq_chars,
     fq_chars_rev, fq_lens, _, _, _) = queries
    dev = doc_tokens.device
    n_w, w_cols = word_chars.shape
    n_docs, d_cols = doc_tokens.shape
    n_b, n_q = q_lens.shape
    n_fq = fq_lens.shape[1]
    n_c = text_ids.shape[0]
    i32, i64, b8 = torch.int32, torch.int64, torch.bool
    for name, t, dt, shape in (
            ("word_chars", word_chars, i32, (n_w, w_cols)),
            ("word_chars_rev", word_chars_rev, i32, (n_w, w_cols)),
            ("word_lens", word_lens, i32, (n_w,)),
            ("doc_tokens", doc_tokens, i32, (n_docs, d_cols)),
            ("doc_tok_offsets", doc_tok_offsets, i32, (n_docs, d_cols)),
            ("doc_tok_count", doc_tok_count, i32, (n_docs,)),
            ("doc_adj_ws", doc_adj_ws, b8, (n_docs, d_cols)),
            ("doc_text_len", doc_text_len, i32, (n_docs,)),
            ("q_chars", q_chars, i32, (n_b, n_q, L)),
            ("q_chars_rev", q_chars_rev, i32, (n_b, n_q, L)),
            ("q_lens", q_lens, i32, (n_b, n_q)),
            ("q_count", q_count, i32, (n_b,)),
            ("q_sorted", q_sorted, i32, (n_b, n_q)),
            ("fq_chars", fq_chars, i32, (n_b, n_fq, L)),
            ("fq_chars_rev", fq_chars_rev, i32, (n_b, n_fq, L)),
            ("fq_lens", fq_lens, i32, (n_b, n_fq)),
            ("text_ids", text_ids, i64, (n_c,)),
            ("qsel", qsel, i64, (n_c,))):
        _check_nd(name, t, dt, shape, dev)
    if L not in PAIR_CHAR_WIDTHS or L > w_cols or not 1 <= D <= d_cols:
        raise ValueError(f"coverage_gather: L {L}, D {D} against words of "
                         f"{w_cols} chars and docs of {d_cols} tokens; the "
                         f"kernel is built for L in {PAIR_CHAR_WIDTHS}")
    return dict(n_w=n_w, w_cols=w_cols, n_docs=n_docs, d_cols=d_cols,
                n_b=n_b, n_q=n_q, n_fq=n_fq, n_c=n_c)


def gather_call(lib, tables, queries, text_ids, qsel, L: int, D: int, n,
                outs, stream) -> int:
    """``lib``'s ``coverage_gather`` on arguments that ``gather_dims``
    checked (``n``, its widths) and the seventeen outputs ``outs``
    (``GatheredBlock``'s fields but ``first_char``); returns its code."""
    (word_chars, word_chars_rev, word_lens, doc_tokens, doc_tok_offsets,
     doc_tok_count, doc_adj_ws, doc_text_len) = tables
    (q_chars, q_chars_rev, q_lens, _, _, q_count, q_sorted, fq_chars,
     fq_chars_rev, fq_lens, _, _, _) = queries
    return lib.coverage_gather(
        word_chars.data_ptr(), word_chars_rev.data_ptr(),
        word_lens.data_ptr(), n["n_w"], n["w_cols"], doc_tokens.data_ptr(),
        doc_tok_offsets.data_ptr(), doc_tok_count.data_ptr(),
        doc_adj_ws.data_ptr(), doc_text_len.data_ptr(), n["n_docs"],
        n["d_cols"], q_chars.data_ptr(), q_chars_rev.data_ptr(),
        q_lens.data_ptr(), q_count.data_ptr(), q_sorted.data_ptr(), n["n_b"],
        n["n_q"], fq_chars.data_ptr(), fq_chars_rev.data_ptr(),
        fq_lens.data_ptr(), n["n_fq"], text_ids.data_ptr(), qsel.data_ptr(),
        L, D, n["n_c"], *(o.data_ptr() for o in outs), stream)


def coverage_gather(tables, queries, text_ids, qsel, L: int, D: int):
    """``csrc/coverage_gather.cu``: one coverage block's gather (see
    ``ops/coverage_kernel.py gather_block``). ``tables`` = (``word_chars``,
    ``word_chars_rev`` int32 [W, >= L], ``word_lens`` int32 [W],
    ``doc_tokens``, ``doc_tok_offsets`` int32 [N, >= D], ``doc_tok_count``
    int32 [N], ``doc_adj_ws`` bool [N, >= D], ``doc_text_len`` int32 [N]);
    ``queries`` the thirteen per-query tables of ``_coverage_block``, of
    which it reads q_chars, q_chars_rev int32 [B, Q, L], q_lens, q_sorted
    int32 [B, Q], q_count int32 [B], fq_chars, fq_chars_rev int32
    [B, FQ, L] and fq_lens int32 [B, FQ]; ``text_ids`` and ``qsel`` int64
    [C]; all contiguous (``gather_dims``). The kernel reads rows
    unchecked: text ids must lie in [0, N), qsel in [0, B) and the doc
    token codes in [-1, W) (see ``csrc/coverage_gather.cu``'s C entry for
    where each holds). Returns the eighteen fields of ``GatheredBlock`` in
    its order, with ``first_char`` a view of ``chars_t[0]``. One launch."""
    dev = text_ids.device
    if dev.type != "cuda":
        raise ValueError("coverage_gather: CUDA tensors required")
    n = gather_dims(tables, queries, text_ids, qsel, L, D)
    n_q, n_fq, n_c = n["n_q"], n["n_fq"], n["n_c"]
    i32, b8 = torch.int32, torch.bool

    def empty(*shape, dtype=i32):
        return torch.empty(shape, dtype=dtype, device=dev)

    qc3, qr3 = empty(n_q, L, n_c), empty(n_q, L, n_c)
    qlens2, qcount, qsorted2 = empty(n_q, n_c), empty(n_c), empty(n_q, n_c)
    fqc3, fqr3, fqlens2 = (empty(n_fq, L, n_c), empty(n_fq, L, n_c),
                           empty(n_fq, n_c))
    codes, tok_count, offsets = empty(D, n_c), empty(n_c), empty(D, n_c)
    adj_ws, text_len = empty(D, n_c, dtype=b8), empty(n_c)
    chars_t, chars_rev_t = empty(L, D, n_c), empty(L, D, n_c)
    lens, all_valid = empty(D, n_c), empty(D, n_c, dtype=b8)
    outs = (qc3, qr3, qlens2, qcount, qsorted2, fqc3, fqr3, fqlens2, codes,
            tok_count, offsets, adj_ws, text_len, chars_t, chars_rev_t, lens,
            all_valid)
    if n_c > 0:
        build()
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            rc = gather_call(_lib, tables, queries, text_ids, qsel, L, D, n,
                             outs, stream)
        if rc != 0:
            raise RuntimeError("coverage_gather launch failed: "
                               + _lib.stage1_error_string(rc).decode())
        launch_counts["coverage_gather"] += 1
    return (*outs, chars_t[0])


def _pair_dims(name: str, q_sets, chars_t, chars_rev_t, lens, valid):
    """(L, D, C) of a pair-kernel call after checking what the kernel
    takes: each query set (chars, reversed chars int32 [S, L, C], lengths
    int32 [S, C]) and the doc rows on one device, contiguous, L one of
    ``PAIR_CHAR_WIDTHS``. Raises otherwise."""
    dev = chars_t.device
    n_l, n_d, n_c = chars_t.shape
    i32 = torch.int32
    checks = [("chars_t", chars_t, i32, (n_l, n_d, n_c)),
              ("chars_rev_t", chars_rev_t, i32, (n_l, n_d, n_c)),
              ("lens", lens, i32, (n_d, n_c)),
              ("valid", valid, torch.bool, (n_d, n_c))]
    for k, (qc3, qr3, qlens2) in enumerate(q_sets):
        n_s = qc3.shape[0]
        checks += [(f"qc3[{k}]", qc3, i32, (n_s, n_l, n_c)),
                   (f"qr3[{k}]", qr3, i32, (n_s, n_l, n_c)),
                   (f"qlens2[{k}]", qlens2, i32, (n_s, n_c))]
    for what, t, dt, shape in checks:
        _check_nd(what, t, dt, shape, dev)
    if n_l not in PAIR_CHAR_WIDTHS:
        raise ValueError(f"{name}: {n_l} chars per token, the kernel is "
                         f"built for {PAIR_CHAR_WIDTHS}")
    return n_l, n_d, n_c


def coverage_pairs(qc3, qr3, qlens2, chars_t, chars_rev_t, lens, valid,
                   distances: bool, *, lib=None):
    """``csrc/coverage_pairs.cu``: the pair words of one set of query
    tokens (see ``ops/coverage_kernel.py coverage_pairs``). ``qc3``/``qr3``
    int32 [S, L, C], ``qlens2`` int32 [S, C], ``chars_t``/``chars_rev_t``
    int32 [L, D, C], ``lens`` int32 [D, C], ``valid`` bool [D, C], all
    contiguous, L one of ``PAIR_CHAR_WIDTHS``, lengths at most L. Returns
    int32 [S, D, C]: the relation bits and the common-prefix length, and
    with ``distances`` the five Damerau distances. One launch, of ``lib``'s
    kernel when given (an earlier design with this C interface, or a host
    build, which takes CPU tensors), else the port's."""
    dev = chars_t.device
    n_l, n_d, n_c = _pair_dims("coverage_pairs", [(qc3, qr3, qlens2)],
                               chars_t, chars_rev_t, lens, valid)
    n_s = qc3.shape[0]
    out = torch.empty((n_s, n_d, n_c), dtype=torch.int32, device=dev)
    if out.numel() == 0:
        return out
    _run_kernel("coverage_pairs", lib, dev,
                lambda lb, stream: lb.coverage_pairs(
                    qc3.data_ptr(), qr3.data_ptr(), qlens2.data_ptr(),
                    chars_t.data_ptr(), chars_rev_t.data_ptr(),
                    lens.data_ptr(), valid.data_ptr(), n_s, n_l, n_d, n_c,
                    int(bool(distances)), out.data_ptr(), stream))
    return out


def coverage_pair_block(q_set, fq_set, chars_t, chars_rev_t, lens, valid, *,
                        lib=None):
    """``csrc/coverage_pairs.cu``: one coverage block's pair words in one
    launch, the doc rows read once: ``q_set`` = (``qc3``, ``qr3``,
    ``qlens2``) of the Q tokens, with distances; ``fq_set`` the same of the
    fusion tokens, relations only; the doc rows as in ``coverage_pairs``.
    Returns (int32 [Q, D, C], int32 [FQ, D, C]), each equal to its
    ``coverage_pairs`` call. ``lib`` as in ``coverage_pairs``."""
    dev = chars_t.device
    n_l, n_d, n_c = _pair_dims("coverage_pair_block", [q_set, fq_set],
                               chars_t, chars_rev_t, lens, valid)
    (qc3, qr3, qlens2), (fqc3, fqr3, fqlens2) = q_set, fq_set
    n_s, n_f = qc3.shape[0], fqc3.shape[0]
    out = torch.empty((n_s, n_d, n_c), dtype=torch.int32, device=dev)
    fout = torch.empty((n_f, n_d, n_c), dtype=torch.int32, device=dev)
    if out.numel() + fout.numel() == 0:
        return out, fout
    _run_kernel("coverage_pairs", lib, dev,
                lambda lb, stream: lb.coverage_pair_block(
                    qc3.data_ptr(), qr3.data_ptr(), qlens2.data_ptr(), n_s,
                    fqc3.data_ptr(), fqr3.data_ptr(), fqlens2.data_ptr(), n_f,
                    chars_t.data_ptr(), chars_rev_t.data_ptr(),
                    lens.data_ptr(), valid.data_ptr(), n_l, n_d, n_c,
                    out.data_ptr(), fout.data_ptr(), stream))
    return out, fout


def coverage_cascade(pairs, lens, offsets, codes, first_char, tok_count,
                     qlens2, qsorted2, qc3, qcount, config, *, lib=None):
    """``csrc/coverage_cascade.cu``: the Stage-2 matcher cascade of one
    coverage block (see ``ops/coverage_kernel.py coverage_cascade``).
    ``pairs`` int32 [Q, D, C] pair words with distances; ``lens``,
    ``offsets``, ``codes``, ``first_char`` int32 [D, C]; ``tok_count``,
    ``qcount`` int32 [C]; ``qlens2``, ``qsorted2`` int32 [Q, C]; ``qc3``
    int32 [Q, L, C]; all contiguous, D one of ``CASCADE_DOC_WIDTHS``, Q at
    most ``CASCADE_Q_MAX``. ``config`` is a ``CoverageConfig``. Returns
    ``(term_matched f32 [Q, C], term_has_whole, term_has_joined,
    term_has_prefix bool [Q, C], term_first_pos int32 [Q, C], word_hits,
    cov_count int32 [C])``. One launch, of ``lib``'s kernel when given (as
    in ``coverage_lcs``), else the port's."""
    dev = pairs.device
    if dev.type != "cuda":
        raise ValueError("coverage_cascade: CUDA tensors required")
    n_q, n_d, n_c = pairs.shape
    n_l = qc3.shape[1]
    i32 = torch.int32
    for name, t, shape in (("pairs", pairs, (n_q, n_d, n_c)),
                           ("lens", lens, (n_d, n_c)),
                           ("offsets", offsets, (n_d, n_c)),
                           ("codes", codes, (n_d, n_c)),
                           ("first_char", first_char, (n_d, n_c)),
                           ("tok_count", tok_count, (n_c,)),
                           ("qlens2", qlens2, (n_q, n_c)),
                           ("qsorted2", qsorted2, (n_q, n_c)),
                           ("qc3", qc3, (n_q, n_l, n_c)),
                           ("qcount", qcount, (n_c,))):
        _check_nd(name, t, i32, shape, dev)
    if n_d not in CASCADE_DOC_WIDTHS or not 1 <= n_q <= CASCADE_Q_MAX \
            or n_l < 1:
        raise ValueError(f"coverage_cascade: Q {n_q}, D {n_d}: the kernel is "
                         f"built for D in {CASCADE_DOC_WIDTHS} and Q up to "
                         f"{CASCADE_Q_MAX}")
    term_matched = torch.empty((n_q, n_c), dtype=torch.float32, device=dev)
    flags = [torch.empty((n_q, n_c), dtype=torch.bool, device=dev)
             for _ in range(3)]
    first_pos = torch.empty((n_q, n_c), dtype=i32, device=dev)
    word_hits = torch.empty((n_c,), dtype=i32, device=dev)
    cov_count = torch.empty((n_c,), dtype=i32, device=dev)
    outs = (term_matched, *flags, first_pos, word_hits, cov_count)
    if n_c == 0:
        return outs
    build()
    cfg = (ctypes.c_int * 9)(
        config.min_word_size, config.levenshtein_max_word_size,
        config.num_typos, config.min_length_one_typo,
        config.min_length_two_typos, int(config.cover_whole_words),
        int(config.cover_joined_words), int(config.cover_prefix_suffix),
        int(config.cover_fuzzy_words))
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = (lib or _lib).coverage_cascade(
            pairs.data_ptr(), lens.data_ptr(), offsets.data_ptr(),
            codes.data_ptr(), first_char.data_ptr(), tok_count.data_ptr(),
            qlens2.data_ptr(), qsorted2.data_ptr(), qc3.data_ptr(),
            qcount.data_ptr(), n_q, n_l, n_d, n_c, cfg,
            *(o.data_ptr() for o in outs), stream)
    if rc != 0:
        raise RuntimeError("coverage_cascade launch failed: "
                           + _lib.stage1_error_string(rc).decode())
    launch_counts["coverage_cascade"] += 1
    return outs


def coverage_lcs(text_chars, lcs_ok, q_text, q_text_len, q_lcs_tol, q_lcs_ok,
                 text_ids, qsel, text_len, lcs_vals, *, lib=None):
    """``csrc/coverage_lcs.cu``: the device fake-LCS of one coverage block
    (see ``ops/coverage_kernel.py coverage_lcs``). ``text_chars`` int32
    [N, T], ``lcs_ok`` bool [N]; ``q_text`` int32 [B, QT] (QT <= T, as the
    plain version needs: it compares the query rows with the text rows'
    first QT units), ``q_text_len``, ``q_lcs_tol`` int32 and ``q_lcs_ok``
    bool [B]; ``text_ids`` (each below N) and ``qsel`` (each below B)
    int64, ``text_len`` int32 and ``lcs_vals`` f32 [C]; all contiguous.
    Returns f32 [C]. One launch, of ``lib``'s kernel when given (a library
    of the same C interface, bound by ``bind``), else the port's."""
    dev = text_ids.device
    if dev.type != "cuda":
        raise ValueError("coverage_lcs: CUDA tensors required")
    n_n, n_t = text_chars.shape
    n_b, n_qt = q_text.shape
    n_c = text_ids.numel()
    i32, i64, b8 = torch.int32, torch.int64, torch.bool
    for name, t, dt, shape in (("text_chars", text_chars, i32, (n_n, n_t)),
                               ("lcs_ok", lcs_ok, b8, (n_n,)),
                               ("q_text", q_text, i32, (n_b, n_qt)),
                               ("q_text_len", q_text_len, i32, (n_b,)),
                               ("q_lcs_tol", q_lcs_tol, i32, (n_b,)),
                               ("q_lcs_ok", q_lcs_ok, b8, (n_b,)),
                               ("text_ids", text_ids, i64, (n_c,)),
                               ("qsel", qsel, i64, (n_c,)),
                               ("text_len", text_len, i32, (n_c,)),
                               ("lcs_vals", lcs_vals, torch.float32, (n_c,))):
        _check_nd(name, t, dt, shape, dev)
    if not 1 <= n_qt <= n_t:
        raise ValueError(f"coverage_lcs: {n_qt} query chars against text "
                         f"rows of {n_t}")
    out = torch.empty((n_c,), dtype=torch.float32, device=dev)
    if n_c == 0:
        return out
    build()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = (lib or _lib).coverage_lcs(
            text_chars.data_ptr(), lcs_ok.data_ptr(), q_text.data_ptr(),
            q_text_len.data_ptr(), q_lcs_tol.data_ptr(), q_lcs_ok.data_ptr(),
            text_ids.data_ptr(), qsel.data_ptr(), text_len.data_ptr(),
            lcs_vals.data_ptr(), n_t, n_qt, n_c, out.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError("coverage_lcs launch failed: "
                           + _lib.stage1_error_string(rc).decode())
    launch_counts["coverage_lcs"] += 1
    return out


def coverage_fusion(state, pairs, fq_pairs, doc, queries, qsel, lcs_vals,
                    base_scores, config, packed_lcs: bool, *, lib=None):
    """``csrc/coverage_fusion.cu``: the scorer + fusion program of one
    coverage block and its pack (see ``ops/coverage_kernel.py
    coverage_fusion``). ``state`` is the cascade kernel's result
    (``term_matched`` f32, three bool flag rows, ``term_first_pos`` int32
    [Q, C], ``word_hits``, ``cov_count`` int32 [C]); ``pairs`` int32
    [Q, D, C], ``fq_pairs`` int32 [FQ, D, C]; ``doc`` = (``chars_t``,
    ``chars_rev_t`` int32 [L, D, C], ``lens`` int32, ``adj_ws``,
    ``all_valid`` bool [D, C], ``tok_count``, ``text_len`` int32 [C]);
    ``queries`` the ten per-query tables it reads (q_lens int32, q_idf,
    q_word_idf f32 [B, Q]; q_count int32 [B]; fq_chars, fq_chars_rev int32
    [B, FQ, L]; fq_lens int32 [B, FQ]; fq_count int32, fq_last_is_alpha
    bool, query_len int32 [B]); ``qsel``
    int64 [C], each below B; ``lcs_vals``, ``base_scores`` f32 [C]; all
    contiguous; it is built for the pair kernel's char widths
    (``PAIR_CHAR_WIDTHS``) and the cascade's doc-token and query-token
    widths (``CASCADE_DOC_WIDTHS``, Q and FQ up to ``CASCADE_Q_MAX``).
    Returns f32 [2, C] with ``packed_lcs``, else [3, C]. One launch, of
    ``lib``'s kernel when given (as in ``coverage_lcs``), else the
    port's."""
    dev = pairs.device
    if dev.type != "cuda":
        raise ValueError("coverage_fusion: CUDA tensors required")
    (term_matched, has_whole, has_joined, has_prefix, first_pos, word_hits,
     cov_count) = state
    chars_t, chars_rev_t, lens, adj_ws, all_valid, tok_count, text_len = doc
    (q_lens, q_idf, q_widf, q_count, fq_chars, fq_rev, fq_lens, fq_count,
     last_alpha, query_len) = queries
    n_q, n_d, n_c = pairs.shape
    n_l = chars_t.shape[0]
    n_b, n_fq = fq_lens.shape
    i32, i64, f32, b8 = torch.int32, torch.int64, torch.float32, torch.bool
    for name, t, dt, shape in (
            ("term_matched", term_matched, f32, (n_q, n_c)),
            ("term_has_whole", has_whole, b8, (n_q, n_c)),
            ("term_has_joined", has_joined, b8, (n_q, n_c)),
            ("term_has_prefix", has_prefix, b8, (n_q, n_c)),
            ("term_first_pos", first_pos, i32, (n_q, n_c)),
            ("word_hits", word_hits, i32, (n_c,)),
            ("cov_count", cov_count, i32, (n_c,)),
            ("pairs", pairs, i32, (n_q, n_d, n_c)),
            ("fq_pairs", fq_pairs, i32, (n_fq, n_d, n_c)),
            ("chars_t", chars_t, i32, (n_l, n_d, n_c)),
            ("chars_rev_t", chars_rev_t, i32, (n_l, n_d, n_c)),
            ("lens", lens, i32, (n_d, n_c)),
            ("adj_ws", adj_ws, b8, (n_d, n_c)),
            ("all_valid", all_valid, b8, (n_d, n_c)),
            ("tok_count", tok_count, i32, (n_c,)),
            ("text_len", text_len, i32, (n_c,)),
            ("q_lens", q_lens, i32, (n_b, n_q)),
            ("q_idf", q_idf, f32, (n_b, n_q)),
            ("q_word_idf", q_widf, f32, (n_b, n_q)),
            ("q_count", q_count, i32, (n_b,)),
            ("fq_chars", fq_chars, i32, (n_b, n_fq, n_l)),
            ("fq_chars_rev", fq_rev, i32, (n_b, n_fq, n_l)),
            ("fq_lens", fq_lens, i32, (n_b, n_fq)),
            ("fq_count", fq_count, i32, (n_b,)),
            ("fq_last_is_alpha", last_alpha, b8, (n_b,)),
            ("query_len", query_len, i32, (n_b,)),
            ("qsel", qsel, i64, (n_c,)),
            ("lcs_vals", lcs_vals, f32, (n_c,)),
            ("base_scores", base_scores, f32, (n_c,))):
        _check_nd(name, t, dt, shape, dev)
    if (n_l not in PAIR_CHAR_WIDTHS or n_d not in CASCADE_DOC_WIDTHS
            or not 1 <= n_q <= CASCADE_Q_MAX
            or not 1 <= n_fq <= CASCADE_Q_MAX):
        raise ValueError(f"coverage_fusion: Q {n_q}, FQ {n_fq}, L {n_l}, D "
                         f"{n_d}: the kernel is built for L in "
                         f"{PAIR_CHAR_WIDTHS}, D in {CASCADE_DOC_WIDTHS} and "
                         f"Q, FQ up to {CASCADE_Q_MAX}")
    out = torch.empty((2 if packed_lcs else 3, n_c), dtype=f32, device=dev)
    if n_c == 0:
        return out
    build()
    cfg = (ctypes.c_int * 2)(config.min_word_size,
                             int(config.cover_whole_query))
    args = (*state, pairs, fq_pairs, *doc, *queries, qsel, lcs_vals,
            base_scores)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = (lib or _lib).coverage_fusion(
            *(t.data_ptr() for t in args), n_q, n_fq, n_l, n_d, n_c, cfg,
            int(bool(packed_lcs)), out.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError("coverage_fusion launch failed: "
                           + _lib.stage1_error_string(rc).decode())
    launch_counts["coverage_fusion"] += 1
    return out


# ---- the Stage-1 epilogue (csrc/stage1_*.cu) ----
#
# Each wrapper takes ``lib``: by default the port's library, on CUDA
# tensors only (a launch is counted); a library of the same C interface
# given by the caller (the g++ build of the cell headers in the CPU tests)
# runs on the tensors' own device, CPU included, and is not counted.

#: the size of the top-k kernel's sorted set S at which its select may
#: stop (kSharedKeys in ``csrc/stage1_topk_cell.cuh``)
TOPK_SHARED_KEYS = 16384
#: keys of a block's run that the top-k kernel sorts in shared memory; a
#: larger run takes a region of a global scratch row. At most
#: TOPK_MAX_RUN_KEYS (kRunKeys in ``csrc/stage1_topk_cell.cuh``)
TOPK_RUN_KEYS = 4096
TOPK_MAX_RUN_KEYS = 16384
#: member ids of a block's LIM list kept in shared memory (kListKeys in
#: ``csrc/stage1_lim_cell.cuh``); a larger k2 takes a global scratch
LIM_LIST_KEYS = 1024
#: ids a slice of the top-k and LIM kernels holds at least
SLICE_IDS = 16384
#: the clusters a card holds at once where there is no card to ask (the
#: host build in the tests): an H100's 132 SMs, two blocks each
HOST_BLOCKS = 264


def _run_kernel(name: str, lib, dev, call) -> None:
    """``call(lib, stream)`` on ``lib`` (default: the port's library, which
    needs CUDA tensors); raises on a non-zero code, counts the port's
    launches."""
    own = lib is None
    if own:
        if dev.type != "cuda":
            raise ValueError(f"{name}: CUDA tensors required")
        build()
        lib = _lib
    if dev.type == "cuda":
        with torch.cuda.device(dev):
            rc = call(lib, torch.cuda.current_stream(dev).cuda_stream)
    else:
        rc = call(lib, None)
    if rc != 0:
        why = (_lib.stage1_error_string(rc).decode() if _lib is not None
               else f"code {rc}")
        raise RuntimeError(f"{name} launch failed: {why}")
    if own:
        launch_counts[name] += 1


def _fuzzy_cover(bits, fidf, q_off, q_grp, n_q: int, dev):
    """Checks of the fuzzy groups' tables that the epilogue and LIM
    kernels read (``bits`` None: no fuzzy groups); returns (has_fz, words,
    pointers of bits, fidf, q_off, q_grp)."""
    if bits is None:
        return 0, 0, (None, None, None, None)
    i32 = torch.int32
    if bits.dim() != 2:
        raise ValueError("bits: must be a [n_grp, words] tensor")
    n_grp, words = bits.shape
    _check_nd("bits", bits, i32, (n_grp, words), dev)
    _check_nd("fidf", fidf, torch.float32, (n_grp,), dev)
    _check_nd("q_off", q_off, i32, (n_q + 1,), dev)
    _check("q_grp", q_grp, i32, dev)
    return 1, words, (bits.data_ptr(), fidf.data_ptr(), q_off.data_ptr(),
                      q_grp.data_ptr())


def stage1_fuzzy(postings_docs, starts, group, cum, n_lanes: int,
                 n_grp: int, doc_lo: int, doc_hi: int, *, lib=None):
    """``csrc/stage1_fuzzy.cu``: the presence of ``n_grp`` fuzzy groups
    over the doc window ``[doc_lo, doc_hi)`` (see ``index/device.py
    fuzzy_presence``). ``starts``/``group`` int32 [T] (each group id
    below n_grp), ``cum`` int32 [T + 1] the first lane of each term
    (``cum[T] = n_lanes``), ``postings_docs`` int32, all contiguous, every
    posting read inside it. Returns (bits int32 [n_grp, ceil(width / 32)],
    bit d of a row for doc doc_lo + d; df int32 [n_grp], each row's
    popcount). One launch: the lane that turns a bit on adds one to its
    group's df."""
    dev = postings_docs.device
    i32 = torch.int32
    for name, t in (("postings_docs", postings_docs), ("starts", starts),
                    ("group", group), ("cum", cum)):
        _check(name, t, i32, dev)
    n_terms = starts.numel()
    if group.numel() != n_terms or cum.numel() != n_terms + 1:
        raise ValueError("stage1_fuzzy: mismatched term tables")
    if not 0 <= doc_lo <= doc_hi < (1 << 31) or n_grp < 0:
        raise ValueError(f"stage1_fuzzy: bad window [{doc_lo}, {doc_hi}) "
                         f"or {n_grp} groups")
    words = -(-(doc_hi - doc_lo) // 32)
    # the bitset and the df counters zeroed together, one fill
    zeroed = torch.zeros(n_grp * (words + 1), dtype=i32, device=dev)
    bits = zeroed[:n_grp * words].view(n_grp, words)
    df = zeroed[n_grp * words:]
    if n_grp == 0:
        return bits, df
    _run_kernel("stage1_fuzzy", lib, dev, lambda lb, stream: lb.stage1_fuzzy(
        starts.data_ptr(), group.data_ptr(), cum.data_ptr(), n_terms,
        int(n_lanes), postings_docs.data_ptr(), int(doc_lo), int(doc_hi),
        bits.data_ptr(), words, n_grp, df.data_ptr(), stream))
    return bits, df


def stage1_extras(scores, docs, off, idf, doc_fac, *, lib=None):
    """``csrc/stage1_extras.cu``, in place on ``scores`` (f32 [width]; see
    ``index/device.py stage1_extras``): a single query's extra postings
    in the doc-major table ``extras_table`` builds: ``docs`` int32 [U]
    distinct, each below width; ``off`` int32 [U + 1], doc u's extras
    ``idf[off[u]:off[u + 1]]`` (f32, in their array order); ``doc_fac``
    f32 [width]. Each doc's cell gains ``idf * doc_fac[doc]`` per extra,
    in order. One launch, none without docs."""
    dev = scores.device
    i32, f32 = torch.int32, torch.float32
    for name, t, dt in (("scores", scores, f32), ("docs", docs, i32),
                        ("off", off, i32), ("idf", idf, f32),
                        ("doc_fac", doc_fac, f32)):
        _check(name, t, dt, dev)
    n_docs = docs.numel()
    if off.numel() != n_docs + 1 or idf.numel() < n_docs:
        raise ValueError("stage1_extras: bad doc-major table")
    if doc_fac.numel() != scores.numel():
        raise ValueError("stage1_extras: doc_fac and scores differ in width")
    if n_docs == 0:
        return
    _run_kernel("stage1_extras", lib, dev, lambda lb, stream: lb.stage1_extras(
        scores.data_ptr(), docs.data_ptr(), off.data_ptr(), idf.data_ptr(),
        doc_fac.data_ptr(), n_docs, stream))


def stage1_epilogue(scores, cnt, live, bits, fidf, doc_fac, q_off, q_grp,
                    *, lib=None):
    """``csrc/stage1_epilogue.cu``, in place on ``scores`` and ``cnt``
    (f32 [n_q, width], contiguous; see ``index/device.py
    stage1_epilogue``): with fuzzy groups (``bits`` int32 [n_grp, words]
    from ``stage1_fuzzy``, ``fidf`` f32 [n_grp], ``doc_fac`` f32 [width],
    ``q_off`` int32 [n_q + 1] and ``q_grp`` int32, each query's groups in
    rank order) adds the groups' scores and counts, then multiplies the
    scores by ``live`` (f32 [width]). ``cnt`` and ``live`` must not be
    negative (counts and 0/1 masks). Returns the row max of cnt * live,
    f32 [n_q]. One launch."""
    dev = scores.device
    f32 = torch.float32
    if scores.dim() != 2:
        raise ValueError("scores: must be a [n_q, width] tensor")
    n_q, width = scores.shape
    _check_nd("scores", scores, f32, (n_q, width), dev)
    _check_nd("cnt", cnt, f32, (n_q, width), dev)
    _check_nd("live", live, f32, (width,), dev)
    has_fz, words, ptrs = _fuzzy_cover(bits, fidf, q_off, q_grp, n_q, dev)
    if has_fz:
        _check_nd("doc_fac", doc_fac, f32, (width,), dev)
        if words * 32 < width:
            raise ValueError("stage1_epilogue: presence rows narrower than "
                             "the score rows")
    if n_q > 65535:
        raise ValueError(f"stage1_epilogue: {n_q} rows, at most 65535")
    rowmax = torch.zeros(n_q, dtype=torch.int32, device=dev)
    if n_q and width:
        _run_kernel("stage1_epilogue", lib, dev,
                    lambda lb, stream: lb.stage1_epilogue(
                        scores.data_ptr(), cnt.data_ptr(), width, n_q,
                        live.data_ptr(), ptrs[0], words, ptrs[1],
                        doc_fac.data_ptr() if has_fz else None, ptrs[2],
                        ptrs[3], has_fz, rowmax.data_ptr(), stream))
    return rowmax.view(f32)


_resident = {}


def resident_clusters(name: str, dev, slices: int, *extra) -> int:
    """How many clusters of ``slices`` blocks of kernel ``name`` (its
    ``<name>_clusters`` occupancy entry point, with ``extra`` arguments)
    ``dev`` holds at once (none where the card refuses that cluster size);
    for a device that is no card, ``HOST_BLOCKS // slices``."""
    if dev.type != "cuda":
        return HOST_BLOCKS // slices
    key = (name, dev.index, slices) + extra
    if key not in _resident:
        build()
        with torch.cuda.device(dev):
            _resident[key] = max(
                getattr(_lib, f"{name}_clusters")(slices, *extra), 0)
    return _resident[key]


def row_slices(n_rows: int, width: int, resident) -> int:
    """Blocks a row (a cluster) for the top-k and LIM kernels: the largest
    power of two up to 16 that keeps slices of at least ``SLICE_IDS`` ids
    and all ``n_rows`` clusters on the card at once (``resident(s)``: the
    clusters of s blocks it holds). A group of 128 queries so takes 2
    blocks a row on an H100, a single query 16."""
    s = 1
    while (s < 16 and 2 * s * SLICE_IDS <= width
           and n_rows <= resident(2 * s)):
        s *= 2
    return s


def topk_slices(n_rows: int, width: int, dev,
                run_keys: int = TOPK_RUN_KEYS) -> int:
    """The top-k kernel's blocks a row by ``row_slices`` on ``dev``."""
    return row_slices(n_rows, width, lambda c: resident_clusters(
        "stage1_topk", dev, c, run_keys))


#: waves of blocks the LIM kernel's slice rule allows: its rows end at
#: very different times (a dense class after its first chunk, a small one
#: after its whole window), and more, shorter blocks even the card's load
LIM_WAVES = 4


def lim_slices(n_q: int, window: int, dev) -> int:
    """The LIM kernel's blocks a row by ``row_slices`` on ``dev``, with up to
    ``LIM_WAVES`` times the blocks the card holds at once."""
    blocks = LIM_WAVES * resident_clusters("stage1_lim", dev, 1)
    return row_slices(n_q, window, lambda c: blocks // c)


def _check_slices(name: str, slices: int) -> None:
    if slices not in (1, 2, 4, 8, 16):
        raise ValueError(f"{name}: slices {slices} is not 1, 2, 4, 8 or 16")


def topk_scratch_cols(k: int, shared_keys: int = TOPK_SHARED_KEYS,
                      run_keys: int = TOPK_RUN_KEYS) -> int:
    """Columns of the top-k kernel's global scratch rows
    (``topk::scratch_cols_for``): none where every block's run fits
    ``run_keys`` (the sorted set holds at most max(k, shared_keys) ids),
    else twice that."""
    most = max(k, shared_keys)
    p = 1
    while p < most:
        p <<= 1
    return 0 if p <= run_keys else 2 * most


def stage1_topk(scores, k: int, *, shared_keys: int = TOPK_SHARED_KEYS,
                run_keys: int = TOPK_RUN_KEYS, slices=None, lib=None):
    """``csrc/stage1_topk.cu``: the exact top ``k`` of each row of
    ``scores`` (f32 [n_rows, width], contiguous) by (score desc, id asc),
    in that order, for 1 <= k <= width (see ``index/device.py
    stable_top_k``). Returns (scores f32 [n_rows, k], the rows' own
    values; ids int32 [n_rows, k]). Each row is served by a cluster of
    ``slices`` blocks (default ``topk_slices``). The kernel's select
    stops once its sorted set holds at most ``shared_keys`` (a power of
    two up to ``TOPK_SHARED_KEYS``) and each block sorts up to
    ``run_keys`` keys in shared memory (a power of two up to
    ``TOPK_MAX_RUN_KEYS``; the tests lower both to reach the other paths
    at small widths); the scratch rows for larger runs come from the
    torch allocator. One launch."""
    dev = scores.device
    if scores.dim() != 2:
        raise ValueError("scores: must be a [n_rows, width] tensor")
    n_rows, width = scores.shape
    _check_nd("scores", scores, torch.float32, (n_rows, width), dev)
    if not 1 <= k <= width:
        raise ValueError(f"stage1_topk: k {k} outside [1, {width}]")
    for what, v, top in (("shared_keys", shared_keys, TOPK_SHARED_KEYS),
                         ("run_keys", run_keys, TOPK_MAX_RUN_KEYS)):
        if not (1 <= v <= top and v & (v - 1) == 0):
            raise ValueError(f"stage1_topk: {what} {v} is not a power of "
                             f"two up to {top}")
    if slices is None:
        slices = topk_slices(n_rows, width, dev, run_keys)
    _check_slices("stage1_topk", slices)
    out_s = torch.empty((n_rows, k), dtype=torch.float32, device=dev)
    out_i = torch.empty((n_rows, k), dtype=torch.int32, device=dev)
    if n_rows == 0:
        return out_s, out_i
    cols = topk_scratch_cols(k, shared_keys, run_keys)
    scratch = (torch.empty((n_rows, cols), dtype=torch.int64, device=dev)
               if cols else None)
    _run_kernel("stage1_topk", lib, dev, lambda lb, stream: lb.stage1_topk(
        scores.data_ptr(), width, n_rows, k, shared_keys, run_keys, slices,
        scratch.data_ptr() if cols else None, cols, out_s.data_ptr(),
        out_i.data_ptr(), stream))
    return out_s, out_i


def stage1_lim(cnt, live, thresh, bits, fidf, q_off, q_grp, k_out: int,
               k2: int, window: int, id_offset: int, pad: int, *,
               slices=None, list_keys: int = LIM_LIST_KEYS, lib=None):
    """``csrc/stage1_lim.cu``: each query's LIM row (see
    ``index/device.py lim_rows``): the ``k2`` lowest ids below
    ``window`` whose ``cnt * live`` (f32 [n_q, width] and [width]) reaches
    ``thresh`` (f32 [n_q]) > 0, or that a scoring fuzzy group (``bits``,
    ``fidf``, ``q_off``, ``q_grp`` as in ``stage1_epilogue``; None for
    none) covers where live > 0, ascending, plus ``id_offset``, padded
    with ``pad`` to ``k_out``. Returns int32 [n_q, k_out]. Each query is
    served by a cluster of ``slices`` blocks (default ``lim_slices`` over
    the window), each keeping its first ``k2`` members in
    shared memory up to ``list_keys`` (at most ``LIM_LIST_KEYS``; the tests
    lower it), else in a scratch from the torch allocator. One launch."""
    dev = cnt.device
    f32 = torch.float32
    if cnt.dim() != 2:
        raise ValueError("cnt: must be a [n_q, width] tensor")
    n_q, width = cnt.shape
    _check_nd("cnt", cnt, f32, (n_q, width), dev)
    _check_nd("live", live, f32, (width,), dev)
    _check_nd("thresh", thresh, f32, (n_q,), dev)
    has_fz, words, ptrs = _fuzzy_cover(bits, fidf, q_off, q_grp, n_q, dev)
    if has_fz and words * 32 < width:
        raise ValueError("stage1_lim: presence rows narrower than the count "
                         "rows")
    if not (0 <= window <= width and 0 <= k2 <= k_out
            and 0 <= id_offset and id_offset + width <= pad < (1 << 31)):
        raise ValueError(f"stage1_lim: window {window}, k2 {k2}, k_out "
                         f"{k_out}, offset {id_offset}, pad {pad} against "
                         f"rows of {width}")
    if slices is None:
        slices = lim_slices(n_q, window, dev)
    _check_slices("stage1_lim", slices)
    if not 0 <= list_keys <= LIM_LIST_KEYS:
        raise ValueError(f"stage1_lim: list_keys {list_keys} outside "
                         f"[0, {LIM_LIST_KEYS}]")
    out = torch.empty((n_q, k_out), dtype=torch.int32, device=dev)
    if n_q and k_out:
        scratch = (torch.empty((n_q, slices, k2), dtype=torch.int32,
                               device=dev) if k2 > list_keys else None)
        _run_kernel("stage1_lim", lib, dev, lambda lb, stream: lb.stage1_lim(
            cnt.data_ptr(), width, n_q, live.data_ptr(), thresh.data_ptr(),
            ptrs[0], words, ptrs[1], ptrs[2], ptrs[3], has_fz, int(window),
            int(k2), int(k_out), int(id_offset), int(pad), out.data_ptr(),
            slices, list_keys,
            scratch.data_ptr() if scratch is not None else None, stream))
    return out
