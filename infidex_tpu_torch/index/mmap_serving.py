"""Memory-bounded segment serving (``flush(materialize=False)``), port.

The reference's ``index/mmap_serving.py`` is host numpy code except for
two methods: ``_dispatch_group`` (device streaming: a group's lazily
decoded term postings become a per-group mini CSR that runs through the
resident Stage-1 program) and ``search_batch_collect`` (the readback).
The reference file is loaded once more under this package (see
``runtime.load_reference_module``), so its relative imports reach the
port's ``index/device.py``; ``MmapStage1`` here subclasses it and
overrides just those two methods. The host route — the one that
single-query ``search``, ``search_async`` and batches of at most
``VectorModel.HOST_S1_MAX_BATCH`` queries take — and ``_MiniBuilt``,
``build_union_index`` and the champion cache are the reference's own code.

Device streaming runs the mini CSR through the port's own Stage-1
(``DeviceIndex._dispatch_group``): per-posting BM25+ factors from the
uint8 weights and the doc lengths, the rank-major chunk table, and the
lane kernel (``csrc/stage1_lanes.cu``; its plain version on the CPU). The
factor of a posting depends only on its doc and weight, so a streamed
term contributes the same bits it contributes in resident mode.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np

from ..ops import stage1_lanes as lanes
from ..ops.coverage_kernel import _upload
from ..runtime import load_reference_module
from .device import DeviceIndex

_ref = load_reference_module(__package__, "index", "mmap_serving.py")
globals().update({k: v for k, v in vars(_ref).items()
                  if not k.startswith("__")})


class MmapStage1(_ref.MmapStage1):
    """The reference's Stage-1 over (memory CSR + lazily decoded segment
    blocks), with device streaming and readback on the port."""

    def _dispatch_group(self, queries, top_k: int, td, stop_limit,
                        live) -> dict:
        """Async half of one streamed group: decode the group's terms
        once, assemble the mini CSR, enqueue the resident Stage-1 on it."""
        device = self._model.device
        mini_ids: Dict[int, int] = {}
        parts_d: List[np.ndarray] = []
        parts_w: List[np.ndarray] = []

        def mid(tid: int) -> int:
            m = mini_ids.get(tid)
            if m is None:
                d, w = self._device_postings(int(tid))
                m = len(parts_d)
                mini_ids[tid] = m
                parts_d.append(d)
                parts_w.append(w)
            return m

        remapped = []
        for term_ids, idfs, fuzzy_groups in queries:
            r_ids = np.array([mid(int(t)) for t in
                              np.asarray(term_ids, np.int64)], np.int64)
            r_fz = [np.array([mid(int(t)) for t in
                              np.asarray(g, np.int64)], np.int64)
                    for g in (fuzzy_groups or ()) if np.asarray(g).size]
            remapped.append((r_ids, idfs, r_fz))

        offsets = np.zeros(len(parts_d) + 1, np.int64)
        if parts_d:
            np.cumsum([p.size for p in parts_d], out=offsets[1:])
        p_total = int(offsets[-1])
        # CHUNK trailing pad postings (the lane expansion reads whole
        # CHUNK-lane windows); pad docs park on the dead slot (n_pad - 1,
        # live 0) and lie inside no term range.
        mdocs = np.full(p_total + lanes.CHUNK, device.n_pad - 1, np.int32)
        mw = np.zeros(mdocs.size, np.uint8)
        if p_total:
            mdocs[:p_total] = np.concatenate(parts_d)
            mw[:p_total] = np.concatenate(parts_w)
        docs = _upload(mdocs, device.device)
        cfac = lanes.posting_cfac(docs, _upload(mw, device.device),
                                  device.doc_lengths, device.avgdl)
        return device._dispatch_group(
            remapped, top_k, td, stop_limit, live,
            csr=(_ref._MiniBuilt(offsets), docs, cfac))

    def search_batch_collect(self, handles: list) -> list:
        """Blocking half: host results as they are, one readback per
        streamed group."""
        out: list = []
        for h in handles:
            if "host" in h:
                out.extend(h["host"])
            else:
                out.extend(DeviceIndex._collect_group(h))
        return out
