"""Loader and wrappers of the port's hand-written CUDA kernels.

The sources under ``infidex_tpu_torch/csrc`` are compiled on first use
with ``nvcc`` for ``sm_90a`` into a shared library with a plain C
interface, under ``build/infidex_tpu_torch/`` at the repository root
(keyed by a hash of the source, so an edited kernel rebuilds), and bound
with ``ctypes``. Nothing is built or imported from CUDA when this module
is imported: the CPU tests import it on machines without ``nvcc``.

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
_SRC = os.path.join(_PKG, "csrc", "stage1_lanes.cu")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "infidex_tpu_torch")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC"]

#: launches per kernel since the last reset (one per kernel launch)
launch_counts = {"stage1_scatter_lanes": 0}

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


def library_path() -> str:
    with open(_SRC, "rb") as f:
        tag = hashlib.sha1(f.read() + " ".join(NVCC_FLAGS).encode())
    return os.path.join(BUILD_DIR, f"libinfidex_kernels.{tag.hexdigest()[:12]}.so")


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
            cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, _SRC]
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
        lib.stage1_scatter_lanes.argtypes = [p, p, p, p, p, i, p, p, p, p, p]
        lib.stage1_scatter_lanes.restype = i
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


def stage1_scatter_lanes(scores, cnt, off, vstart, vend, idf, base,
                         lo: int, hi: int, postings_docs, cfac) -> None:
    """One rank pass of ``csrc/stage1_lanes.cu`` over chunk-table rows
    ``[lo, hi)`` (see ``ops/stage1_lanes.py``), in place on ``scores`` and
    ``cnt``. The caller guarantees that no two lanes of the pass share a
    key and that every key lies inside ``scores``."""
    dev = scores.device
    if dev.type != "cuda":
        raise ValueError("stage1_scatter_lanes: CUDA tensors required")
    i32, f32 = torch.int32, torch.float32
    for name, t, dt in (("scores", scores, f32), ("cnt", cnt, f32),
                        ("off", off, i32), ("vstart", vstart, i32),
                        ("vend", vend, i32), ("idf", idf, f32),
                        ("base", base, i32), ("postings_docs", postings_docs,
                                              i32), ("cfac", cfac, f32)):
        _check(name, t, dt, dev)
    if cnt.numel() != scores.numel() or cfac.numel() != postings_docs.numel():
        raise ValueError("stage1_scatter_lanes: mismatched sizes")
    n_rows = off.numel()
    if not (off.numel() == vstart.numel() == vend.numel() == idf.numel()
            == base.numel()) or not 0 <= lo <= hi <= n_rows:
        raise ValueError("stage1_scatter_lanes: bad chunk table slice")
    if hi == lo:
        return
    build()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = _lib.stage1_scatter_lanes(
            off.data_ptr() + 4 * lo, vstart.data_ptr() + 4 * lo,
            vend.data_ptr() + 4 * lo, idf.data_ptr() + 4 * lo,
            base.data_ptr() + 4 * lo, hi - lo, postings_docs.data_ptr(),
            cfac.data_ptr(), scores.data_ptr(), cnt.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError("stage1_scatter_lanes launch failed: "
                           + _lib.stage1_error_string(rc).decode())
    launch_counts["stage1_scatter_lanes"] += 1
