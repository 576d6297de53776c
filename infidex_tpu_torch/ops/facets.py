"""Batched facet counting as one device index-add per batch (PyTorch).

Port of ``infidex_tpu/ops/facets.py``. Behavioral reference: Infidex
``Core/FacetBuilder.cs:19-56`` — count field values over the result set,
sort by count desc then value asc, keep the top 100 per field. Each
facetable field's dictionary codes stay resident on ``runtime.device()``
as an int32 table, and every query of the serving batch is counted at
once:

    ids   [B, D] int64   padded result doc-id lists (-1 = padding)
    codes [n_docs] int32 per-field dictionary codes (-1 = field missing)
    out   [B, V]  int32  per-query counts over the V unique values

The count is ONE integer ``index_add_`` of ones on the flat keys
``b * V + code``; pads and missing values go to one spare slot past the
end, which is dropped. Integer sums do not depend on the order of the
additions, so the result is exact on every device. The reference runs the
same function as a jitted XLA scatter-add, not a Pallas kernel; plain
PyTorch is its counterpart. The routing thresholds (``MAX_VALUES``,
``MIN_BATCH_IDS``, ``worth_it``) are the reference's: the route changes
no count.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from .. import runtime
from .coverage_kernel import _upload

__all__ = ["DeviceFacetCounter", "facet_counts_batch_host"]


def facet_counts(ids: torch.Tensor, codes: torch.Tensor,
                 n_values: int) -> torch.Tensor:
    """int32 [B, n_values] counts of ``codes[ids]`` per row of the int64
    [B, D] ``ids`` (-1 pads); ids past the table clamp to its last doc,
    as in the reference."""
    n_rows = ids.shape[0]
    spare = n_rows * n_values
    out = torch.zeros(spare + 1, dtype=torch.int32, device=ids.device)
    if codes.numel() == 0 or ids.numel() == 0:
        return out[:spare].view(n_rows, n_values)
    code = codes[ids.clamp(0, codes.numel() - 1)].long()
    valid = (ids >= 0) & (code >= 0)
    row = torch.arange(n_rows, device=ids.device, dtype=torch.int64)
    key = torch.where(valid, row[:, None] * n_values + code, spare)
    out.index_add_(0, key.reshape(-1),
                   torch.ones(key.numel(), dtype=torch.int32,
                              device=ids.device))
    return out[:spare].view(n_rows, n_values)


class DeviceFacetCounter:
    """Per-ColumnStore device facet counter.

    Owns the device copies of each field's dictionary codes. Lifetime is
    tied to the ColumnStore that created it (the store is rebuilt whenever
    the document set changes, dropping stale device tables with it).
    """

    #: fields with more unique values than this never go to the device —
    #: the [B, V] counts tensor and its readback would dominate.
    MAX_VALUES = 8192
    #: minimum total result ids in the batch before a dispatch can win
    #: (the reference's threshold, kept: re-deriving it for the H100
    #: needs a benchmark).
    MIN_BATCH_IDS = 4096

    def __init__(self) -> None:
        self._codes_dev: Dict[str, torch.Tensor] = {}
        self._n_values: Dict[str, int] = {}

    # ------------------------------------------------------------------
    def worth_it(self, n_values: int, total_ids: int, n_queries: int) -> bool:
        return (n_queries > 1 and 2 <= n_values <= self.MAX_VALUES
                and total_ids >= self.MIN_BATCH_IDS)

    # ------------------------------------------------------------------
    def counts(self, field_name: str, codes: np.ndarray, n_values: int,
               id_lists: List[np.ndarray]) -> np.ndarray:
        """[B, n_values] int32 counts for every query's result-id list."""
        dev = self._codes_dev.get(field_name)
        if dev is None or self._n_values.get(field_name) != n_values:
            dev = _upload(np.ascontiguousarray(codes, np.int32),
                          runtime.device())
            self._codes_dev[field_name] = dev
            self._n_values[field_name] = n_values
        d = max(1, max((len(a) for a in id_lists), default=1))
        ids = np.full((len(id_lists), d), -1, dtype=np.int64)
        for i, a in enumerate(id_lists):
            if len(a):
                ids[i, : len(a)] = a
        out = facet_counts(torch.from_numpy(ids).to(dev.device), dev,
                           int(n_values))
        return out.cpu().numpy()


def facet_counts_batch_host(codes: np.ndarray, n_values: int,
                            id_lists: List[np.ndarray]) -> np.ndarray:
    """Host fallback: the same [B, n_values] counts via per-row bincount."""
    out = np.zeros((len(id_lists), n_values), dtype=np.int64)
    for i, ids in enumerate(id_lists):
        if len(ids) == 0:
            continue
        c = codes[ids]
        c = c[c >= 0]
        if len(c):
            out[i] = np.bincount(c, minlength=n_values)
    return out
