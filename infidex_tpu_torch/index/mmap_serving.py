"""Memory-bounded segment serving: flushed postings stay on disk.

Behavioral reference: Infidex ``Indexing/Segments/MMapBlockPostingsEnum.cs``
(:1-303) and ``SegmentReader.cs:33-125`` — the reference serves flushed
segments directly from the memory-mapped block-postings file, decoding only
the blocks a query touches, so resident memory is bounded by the live
in-memory delta index + per-query working set, not the corpus.

``flush(path, materialize=False)`` puts the engine in this mode: the
unified CSR is built from the MEMORY postings only (docs added after the
flush), the vocabulary/df image is the union of memory + segment terms
(so idf and fuzzy LD1 matching see the whole corpus), and Stage-1 decodes
exactly the query's terms' blocks from each segment per batch. Doc
spaces are disjoint (segment docs precede the flush point), so the
per-source postings concatenate into one doc-ascending list per term.

Two Stage-1 executions share that lazy decode:

* **Device streaming** (default when a device index exists): the batch's
  decoded term postings are assembled into a per-group *mini CSR*
  (champion-clipped with the exact ``builder.ensure_champions`` rule),
  uploaded, and scored by the port's own Stage 1
  (``DeviceIndex._dispatch_group``): per-posting BM25+ factors from the
  uint8 weights and the doc lengths, the query-major chunk table, and the
  lane kernel (``csrc/stage1_lanes.cu``; its plain version on the CPU).
  The factor of a posting depends only on its doc and weight, so a
  streamed term contributes the same bits it contributes in resident mode,
  and resident device memory is bounded by the live memory CSR + the
  per-batch working set instead of the corpus.
* **Host scoring** (``INFIDEX_TPU_MMAP_DEVICE=0``, no device, or a
  below-link-floor tiny batch): exact full-postings numpy scatter,
  also used by ``VectorModel.host_stage1`` for resident tiny batches.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Tuple

import numpy as np

from .device import B, DELTA, K1, compute_idf


class _MiniBuilt:
    """Shape shim for ``prepare_batch_arrays``: a per-group CSR whose
    lanes are already champion-clipped (champion table empty)."""

    __slots__ = ("term_offsets",)
    champion_starts = None
    champion_len = 0

    def __init__(self, term_offsets: np.ndarray):
        self.term_offsets = term_offsets

    def ensure_champions(self, cap: int = 0) -> None:
        pass


class MmapStage1:
    """Stage-1 over (memory CSR + lazily-decoded segment blocks).

    Implements the ``DeviceIndex.search_batch``/``search_batch_dispatch``
    interface so the pipeline is agnostic to the serving mode."""

    def __init__(self, model, device_stream: bool = False):
        self._model = model
        flag = os.environ.get("INFIDEX_TPU_MMAP_DEVICE", "auto")
        self.device_stream = device_stream and flag not in (
            "0", "off", "false")
        # per-term decoded+clipped device lanes, keyed by union tid.
        # Bounded: <= _CHAMP_CACHE_CAP entries x DEVICE_TERM_CAP postings
        # (~40MB worst case) — the working set stays per-query-shaped.
        self._champ_cache: Dict[int, Tuple[np.ndarray, np.ndarray]] = {}

    _CHAMP_CACHE_CAP = 8192

    # ------------------------------------------------------------------
    def _term_parts(self, tid: int) -> List[Tuple[np.ndarray, np.ndarray]]:
        """(doc_ids, weights) arrays for one union term id: the memory CSR
        slice plus one lazily-decoded part per segment containing it."""
        model = self._model
        built = model.built
        parts: List[Tuple[np.ndarray, np.ndarray]] = []
        s, e = int(built.term_offsets[tid]), int(built.term_offsets[tid + 1])
        if e > s:
            parts.append((built.postings_docs[s:e],
                          built.postings_weights[s:e]))
        for seg, ordinal in model._segment_catalog.get(tid, ()):
            docs, weights = seg.get_postings_by_ordinal(ordinal, True)
            parts.append((docs.astype(np.int64), weights))
        return parts

    # ------------------------------------------------------------------
    # Device streaming: per-group mini CSR through the resident kernel

    def _device_postings(self, tid: int) -> Tuple[np.ndarray, np.ndarray]:
        """The union term's device lanes: segment parts (flush order =
        doc-ascending) + the memory CSR slice, champion-clipped with the
        EXACT ``builder.ensure_champions`` rule (LIM_K lowest ids
        reserved, then top-by-weight, stable toward lower doc id) — so a
        clipped term contributes the same lanes it would in resident
        mode and results match bit-for-bit."""
        hit = self._champ_cache.get(tid)
        if hit is not None:
            return hit
        model = self._model
        built = model.built
        parts: List[Tuple[np.ndarray, np.ndarray]] = []
        for seg, ordinal in model._segment_catalog.get(tid, ()):
            d, w = seg.get_postings_by_ordinal(ordinal, True)
            parts.append((d, w))
        s, e = int(built.term_offsets[tid]), int(built.term_offsets[tid + 1])
        if e > s:
            parts.append((built.postings_docs[s:e],
                          built.postings_weights[s:e]))
        if not parts:
            docs = np.zeros(0, np.int32)
            w = np.zeros(0, np.uint8)
        elif len(parts) == 1:
            docs = np.ascontiguousarray(parts[0][0], np.int32)
            w = np.ascontiguousarray(parts[0][1], np.uint8)
        else:
            docs = np.concatenate([p[0] for p in parts]).astype(
                np.int32, copy=False)
            w = np.concatenate([p[1] for p in parts]).astype(
                np.uint8, copy=False)
        from .builder import DEVICE_TERM_CAP
        from .device import LIM_K

        cap = DEVICE_TERM_CAP
        if cap > 0 and docs.size > cap:
            k_low = min(LIM_K, cap // 2)
            rest = k_low + np.argsort(
                -w[k_low:].astype(np.int16), kind="stable")[: cap - k_low]
            part = np.concatenate([np.arange(k_low), rest])
            part.sort()
            docs, w = docs[part], w[part]
        if len(self._champ_cache) >= self._CHAMP_CACHE_CAP:
            self._champ_cache.clear()
        self._champ_cache[tid] = (docs, w)
        return docs, w

    def _device_ok(self, queries) -> bool:
        """Stream this batch through the device kernel? Mirrors the
        resident path's host/device routing: tiny, low-lane batches
        undercut the device link round trip on the host."""
        model = self._model
        if not self.device_stream or model.device is None:
            return False
        if len(queries) > model.HOST_S1_MAX_BATCH:
            return True
        from .builder import DEVICE_TERM_CAP

        df = model.built.df
        cap = DEVICE_TERM_CAP if DEVICE_TERM_CAP > 0 else (1 << 30)
        lanes = 0
        for term_ids, _idf, fuzzy_groups in queries:
            ids = np.asarray(term_ids, np.int64)
            if ids.size:
                lanes += int(np.minimum(np.maximum(df[ids], 0), cap).sum())
            for grp in (fuzzy_groups or ()):
                g = np.asarray(grp, np.int64)
                if g.size:
                    lanes += int(np.minimum(
                        np.maximum(df[g], 0), cap).sum())
        return lanes > model.HOST_S1_MAX_LANES

    def _dispatch_group(self, queries, top_k: int, td, stop_limit,
                        live) -> dict:
        """Async half of one streamed group: decode the group's terms
        once, assemble the mini CSR, enqueue the resident Stage-1 on it."""
        from ..ops import stage1_lanes as lanes
        from ..ops.coverage_kernel import _upload
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
            csr=(_MiniBuilt(offsets), docs, cfac))

    def search_batch_dispatch(self, queries, top_k: int, total_docs=None,
                              stop_term_limit: int = 1_250_000,
                              live_override=None, host_mask=None) -> list:
        """Async half of ``search_batch``; pair with
        ``search_batch_collect``. Routes each lane-capped group through
        the device kernel, or the whole batch to the host scorer when
        the device would lose to its own link latency (handles carry
        finished host results in that case)."""
        if not queries:
            return []
        td = int(total_docs if total_docs is not None
                 else self._model.documents.count)
        if not self._device_ok(queries) and live_override is None:
            return [dict(host=[
                self._search_one(prep, top_k, td, stop_term_limit,
                                 host_mask=host_mask)
                for prep in queries])]
        from .device import _MAX_L_PER_CALL
        from .builder import DEVICE_TERM_CAP

        device = self._model.device
        live = (live_override if live_override is not None
                else device.masked_live(host_mask))
        # contiguous lane-capped groups (split_batch_by_lanes twin on
        # clipped GLOBAL dfs — the union CSR alone undercounts segments)
        df = self._model.built.df
        cap = DEVICE_TERM_CAP if DEVICE_TERM_CAP > 0 else (1 << 30)

        def lane_count(ids):
            ids = np.asarray(ids, np.int64)
            if ids.size == 0:
                return 0
            return int(np.minimum(np.maximum(df[ids], 0), cap).sum())

        lanes = [lane_count(t) + sum(lane_count(g) for g in (fz or ()))
                 for t, _i, fz in queries]
        groups = []
        lo, acc = 0, 0
        if sum(lanes) <= _MAX_L_PER_CALL:
            groups = [(0, len(queries))]
        else:
            for i, n in enumerate(lanes):
                if acc and acc + n > _MAX_L_PER_CALL:
                    groups.append((lo, i))
                    lo, acc = i, 0
                acc += n
            groups.append((lo, len(queries)))
        return [self._dispatch_group(queries[g_lo:g_hi], top_k, td,
                                     stop_term_limit, live)
                for g_lo, g_hi in groups]

    def search_batch_collect(self, handles: list) -> list:
        """Blocking half: host results as they are, one readback per
        streamed group."""
        from .device import DeviceIndex

        out: list = []
        for h in handles:
            if "host" in h:
                out.extend(h["host"])
            else:
                out.extend(DeviceIndex._collect_group(h))
        return out

    # ------------------------------------------------------------------
    def search_batch(self, queries, top_k: int, total_docs=None,
                     stop_term_limit: int = 1_250_000,
                     live_override=None, host_mask=None) -> list:
        """Same output convention as ``DeviceIndex.search_batch``:
        [(scores f32[k], ids int32[k], lim int32)] per query,
        score-descending, non-positive score = padding. Pre-filtering:
        pass ``live_override`` (device buffer) for the streaming path or
        the numpy ``host_mask`` (used by both paths)."""
        return self.search_batch_collect(self.search_batch_dispatch(
            queries, top_k, total_docs=total_docs,
            stop_term_limit=stop_term_limit, live_override=live_override,
            host_mask=host_mask))

    def _search_one(self, prep, top_k: int, total_docs: int,
                    stop_limit: int, host_mask=None):
        model = self._model
        built = model.built
        term_ids, idfs, fuzzy_groups = prep
        n = built.doc_lengths.size
        avgdl = np.float32(max(built.avgdl, 1e-9))
        dl = built.doc_lengths
        dl = np.where(dl <= 0.0, np.float32(1.0), dl)
        norm = np.float32(K1) * (np.float32(1.0 - B)
                                 + np.float32(B) * (dl / avgdl))
        scores = np.zeros(n, np.float32)
        cnt = np.zeros(n, np.int32)   # distinct-scoring-term count
        fz_any = np.zeros(n, bool)    # carries any fuzzy-matched word

        for tid, idf in zip(np.asarray(term_ids, np.int64), idfs):
            if float(idf) <= 0.0:
                continue
            for docs, weights in self._term_parts(int(tid)):
                d = docs.astype(np.int64)
                tf = weights.astype(np.float32)
                contrib = np.float32(idf) * (
                    (tf * np.float32(K1 + 1.0)) / (tf + norm[d])
                    + np.float32(DELTA))
                np.add.at(scores, d, contrib)
                np.add.at(cnt, d, 1)

        for grp in (fuzzy_groups or ()):
            # virtual term: union of matched terms' docs, tf = 1.0
            # (VectorModel.ExpandMissingTerm; device twin: device.py
            # fuzzy_presence + stage1_epilogue)
            chunks = [docs for tid in np.asarray(grp, np.int64)
                      for docs, _ in self._term_parts(int(tid))]
            if not chunks:
                continue
            union = np.unique(np.concatenate(chunks)).astype(np.int64)
            df = int(union.size)
            if df <= 0 or df > stop_limit:
                continue
            fidf = compute_idf(total_docs, df)
            contrib = np.float32(fidf) * (
                np.float32(K1 + 1.0) / (np.float32(1.0) + norm[union])
                + np.float32(DELTA))
            scores[union] += contrib
            if fidf > 0.0:
                cnt[union] += 1
                fz_any[union] = True

        if model.deleted_arr.size >= n:
            scores[model.deleted_arr[:n]] = 0.0
            cnt[model.deleted_arr[:n]] = 0
            fz_any[model.deleted_arr[:n]] = False
        if host_mask is not None and host_mask.size >= n:
            scores[~host_mask[:n]] = 0.0
            cnt[~host_mask[:n]] = 0
            fz_any[~host_mask[:n]] = False

        k = min(int(top_k), n)
        if k <= 0:
            return (np.zeros(0, np.float32), np.zeros(0, np.int32),
                    np.zeros(0, np.int32))
        idx = np.argpartition(-scores, k - 1)[:k] if k < n \
            else np.arange(n)
        order = np.lexsort((idx, -scores[idx]))   # desc, lower id wins tie
        out_scores = np.zeros(k, np.float32)
        out_ids = np.zeros(k, np.int32)
        out_scores[: order.size] = scores[idx[order]]
        out_ids[: order.size] = idx[order]
        # low-id matchers (device.py LIM rows, host twin): lowest ids of
        # the max-gram-coverage class UNION the fuzzy-matched-word class
        from .device import LIM_K, LIM_WINDOW

        w = min(LIM_WINDOW, n)
        cmax = int(cnt[:w].max()) if w else 0
        m = fz_any[:w]
        if cmax > 0:
            m = m | (cnt[:w] == cmax)
        lim = np.flatnonzero(m)[: min(LIM_K, k)]
        return out_scores, out_ids, lim.astype(np.int32)


def build_union_index(model, n_docs: int):
    """Union BuiltIndex for mmap serving: memory-postings CSR + the full
    memory∪segment vocabulary with GLOBAL df (idf and fuzzy matching see
    the whole corpus; segment-only terms carry empty CSR ranges). Also
    installs ``model._segment_catalog`` (union tid -> [(reader, ordinal)]).
    """
    from .builder import BuiltIndex, finalize_postings

    mem = finalize_postings(model.term_dict, n_docs)

    terms = list(mem.terms)
    term_to_id = dict(mem.term_to_id)
    dfs = mem.df.astype(np.int64).tolist()
    catalog: Dict[int, list] = {}
    for seg in model._segments:
        for term, ordinal in seg.iter_terms():
            t = term_to_id.get(term)
            if t is None:
                t = len(terms)
                term_to_id[term] = t
                terms.append(term)
                dfs.append(0)
            if dfs[t] >= 0:   # -1 = stop term: df stays pinned
                dfs[t] += int(seg.dfs[ordinal])
            catalog.setdefault(t, []).append((seg, ordinal))
    model._segment_catalog = catalog

    T = len(terms)
    offsets = np.zeros(T + 1, np.int64)
    offsets[: mem.term_offsets.size] = mem.term_offsets
    offsets[mem.term_offsets.size:] = mem.term_offsets[-1]

    # doc lengths: flushed docs' lengths were captured at flush time;
    # memory docs' lengths come from the live postings.
    dl = np.zeros(max(n_docs, 1), np.float32)
    fl = model._flushed_doc_lengths
    dl[: min(fl.size, n_docs)] = fl[: min(fl.size, n_docs)]
    ml = mem.doc_lengths
    k = min(ml.size, n_docs)
    dl[:k] += ml[:k]
    dl = dl[:n_docs]
    avgdl = float(dl.mean()) if n_docs > 0 else 0.0

    return BuiltIndex(
        terms=terms, term_to_id=term_to_id, term_offsets=offsets,
        postings_docs=mem.postings_docs,
        postings_weights=mem.postings_weights,
        df=np.asarray(dfs, np.int64).clip(-1, 2**31 - 1).astype(np.int32),
        doc_lengths=dl, avgdl=avgdl, num_docs=n_docs)
