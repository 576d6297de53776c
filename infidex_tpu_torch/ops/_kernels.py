"""Loader and wrappers of the port's hand-written CUDA kernels.

Every ``.cu`` source under ``infidex_tpu_torch/csrc`` is compiled on
first use by one ``nvcc`` call for ``sm_90a`` into ONE shared library
with a plain C interface, under ``build/infidex_tpu_torch/`` at the
repository root (named by a hash of all the sources and the flags, so an
edit to any of them rebuilds), and bound with ``ctypes``. Nothing is
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
launch_counts = {"stage1_scatter_lanes": 0, "fuzzy_match": 0}

_lib = None
_lock = threading.Lock()


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


def _sources() -> list:
    """The CUDA sources of the library, in a fixed order."""
    return sorted(os.path.join(_CSRC, f) for f in os.listdir(_CSRC)
                  if f.endswith(".cu"))


def library_path() -> str:
    tag = hashlib.sha1(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        with open(src, "rb") as f:
            tag.update(os.path.basename(src).encode() + b"\0" + f.read())
    return os.path.join(BUILD_DIR,
                        f"libinfidex_kernels.{tag.hexdigest()[:12]}.so")


def build(verbose: bool = False) -> float:
    """Compile the kernels if needed and load them; returns the seconds
    spent (0.0 when already loaded)."""
    global _lib
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
                print(res.stdout + res.stderr, flush=True)
            os.replace(tmp, so)
        lib = ctypes.CDLL(so)
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.stage1_scatter_lanes.argtypes = [p, p, p, p, p, p, p, i, p, p,
                                             p, p, p]
        lib.stage1_scatter_lanes.restype = i
        lib.fuzzy_match.argtypes = [p, p, p, p, p, p, p, i, i, i, i, p, p, p]
        lib.fuzzy_match.restype = i
        lib.stage1_error_string.argtypes = [i]
        lib.stage1_error_string.restype = ctypes.c_char_p
        _lib = lib
        return time.perf_counter() - t0


def _check(name: str, t: torch.Tensor, dtype, dev) -> None:
    if t.device != dev:
        raise ValueError(f"{name}: on {t.device}, expected {dev}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if t.dim() != 1 or not t.is_contiguous():
        raise ValueError(f"{name}: must be a contiguous 1-D tensor")


def stage1_scatter_lanes(scores, cnt, qstart, off, vstart, vend, idf, base,
                         rank, postings_docs, cfac) -> None:
    """``csrc/stage1_lanes.cu`` over a query-major chunk table (see
    ``ops/stage1_lanes.py``: rows ``qstart[q]:qstart[q+1]`` are query
    ``q``'s, in term-rank order), in place on ``scores`` and ``cnt``: ONE
    launch, one block per query. The caller guarantees that no two lanes
    of one term share a key, that different queries' keys differ, and
    that every key lies inside ``scores``."""
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
    if n_q == 0 or off.numel() == 0:
        return
    build()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = _lib.stage1_scatter_lanes(
            qstart.data_ptr(), off.data_ptr(), vstart.data_ptr(),
            vend.data_ptr(), idf.data_ptr(), base.data_ptr(),
            rank.data_ptr(), n_q, postings_docs.data_ptr(), cfac.data_ptr(),
            scores.data_ptr(), cnt.data_ptr(), stream)
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
