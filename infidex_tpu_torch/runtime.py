"""The port's device, chosen explicitly.

Every device tensor of the port (index state, coverage tables, per-call
arguments) is created on ``device()``. The default is CUDA; when no CUDA
device exists, ``device()`` raises unless ``set_device("cpu")`` was called
first. There is no silent fallback to the CPU: tests opt in to it, and
``chip_smoke.py`` selects ``"cuda"``.
"""

from __future__ import annotations

import torch

_device = None


def set_device(dev) -> torch.device:
    """Select the device for tensors created from now on ("cuda", "cpu",
    "cuda:1" or a ``torch.device``)."""
    global _device
    d = torch.device(dev)
    if d.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("set_device: CUDA is not available")
    if d.type not in ("cuda", "cpu"):
        raise ValueError(f"set_device: unsupported device type {d.type!r}")
    _device = d
    return d


def device() -> torch.device:
    """The selected device; CUDA unless ``set_device`` chose otherwise."""
    if _device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "infidex_tpu_torch: CUDA is not available. Call "
                "infidex_tpu_torch.runtime.set_device('cpu') to run the "
                "port's plain PyTorch path on the CPU.")
        return set_device("cuda")
    return _device


#: features of the JAX package that the port does not have yet, with the
#: ROADMAP.md item that queues each
SHARDING = ("multi-device sharded serving (parallel/sharding.py)",
            "ROADMAP.md §1 item 2")
POOL_SCORING = ("device pool scoring (INFIDEX_TPU_POOL_DEVICE=1, "
                "DeviceIndex.pool_score_dispatch)", "ROADMAP.md §1 item 3")


def not_ported(feature: tuple) -> NotImplementedError:
    """The error a copied module raises where it would reach a feature
    the port does not have yet (``SHARDING``, ``POOL_SCORING``)."""
    what, item = feature
    return NotImplementedError(
        f"infidex_tpu_torch: {what} is not ported yet ({item})")
