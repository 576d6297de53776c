"""Device-resident inverted index + batched Stage-1 BM25+ scoring (PyTorch).

Port of the serving route of ``infidex_tpu/index/device.py``: BM25+ with
K1=1.2, B=0.75, delta=1.0 (Infidex ``Indexing/Bm25Scorer.cs:21-23``),
idf = ln((N-df+0.5)/(df+0.5)+1) (:686-695).

Postings live on the device as one flat CSR buffer (base postings plus the
champion extension of clipped terms) with a per-posting BM25+ factor
``cfac``. A batch of queries is one flat lane space: the host builds a
chunk table from each query term's CSR range, the lane kernel
(``ops/stage1_lanes.py``) scatters every lane's ``idf * cfac`` into a
dense [n_q, n_pad] score matrix and counts distinct scoring terms per
doc, the fuzzy virtual-term block adds on-device expanded typo groups,
and the epilogue takes the exact (score desc, id asc) top-k plus the
low-id-matcher (LIM) rows of each query's top quality class.

Every f32 operation is rounded on its own (no FMA contraction, no
atomics, no TF32), so CPU and CUDA give the same bits: the lane scatter
keeps the reference's serial per-cell addition order (see
``ops/stage1_lanes.py``; given the same per-posting factors the scores
equal the reference's bit for bit), the fuzzy scores accumulate per group
in group order, and the top-k packs score and id into one unique int64
key, so tie order never depends on the device. Ids come back as integers
(no f32 packing, no 2^24-doc cap on the id path).
"""

from __future__ import annotations

import os
from typing import Dict, Optional

import numpy as np
import torch

from .. import runtime
from ..ops import stage1_lanes as lanes
from ..ops.coverage_kernel import _upload
from .builder import BuiltIndex

K1 = 1.2
B = 0.75
DELTA = 1.0

_MIN_L = 1024
# Lane cap per Stage-1 group: batches whose flat lane space would exceed
# this split into several groups (each query's scores are independent of
# its group, so the split changes no result).
_MAX_L_PER_CALL = int(os.environ.get(
    "INFIDEX_TPU_MAX_LANES_PER_CALL", 4 * 1024 * 1024))

#: low-id matcher window/count (see the reference module): alongside the
#: score top-k, Stage-1 returns the LIM_K lowest doc ids (within the first
#: LIM_WINDOW ids) of each query's top quality class.
LIM_WINDOW = int(os.environ.get("INFIDEX_TPU_LIM_WINDOW", 1 << 30))
LIM_K = int(os.environ.get("INFIDEX_TPU_LIM_K", 256))

#: LIM row pad value (the reference's 2^24 sentinel; beyond 2^24 docs the
#: pad grows to n_pad so it can never alias a real id)
_LIM_PAD = 1 << 24


def compute_idf(total_docs: int, df: int) -> float:
    """BM25 idf (Bm25Scorer.ComputeIdf, :686-695), float32 semantics."""
    if df <= 0 or total_docs <= 0:
        return 0.0
    ratio = (np.float32(total_docs) - np.float32(df) + np.float32(0.5)) / (
        np.float32(df) + np.float32(0.5)
    )
    if ratio <= 0:
        return 0.0
    return float(np.log1p(ratio, dtype=np.float32))


def stable_top_k(scores: torch.Tensor, k: int):
    """Top-k of each row by (score desc, doc id asc), exactly.

    Each (score, id) pair becomes one unique int64 key: the high 32 bits
    are the order-preserving integer image of the f32 score, the low 32
    bits the inverted id. One top-k over unique keys has no ties, so the
    selection and its order are the same on every device and at every
    depth (membership nests across k). ``-0.0`` is folded into ``+0.0``
    first so the two compare equal, as floats do."""
    one_d = scores.dim() == 1
    if one_d:
        scores = scores[None, :]
    n_pad = scores.shape[-1]
    bits = (scores + 0.0).contiguous().view(torch.int32)
    order = bits ^ ((bits >> 31) & 0x7FFFFFFF)
    low = (1 << 32) - 1 - torch.arange(n_pad, device=scores.device,
                                       dtype=torch.int64)
    key = order.to(torch.int64) * (1 << 32) + low[None, :]
    top = torch.topk(key, k, dim=1, largest=True, sorted=True).values
    ids = ((1 << 32) - 1 - (top & 0xFFFFFFFF))
    out_scores = torch.gather(scores, 1, ids)
    ids = ids.to(torch.int32)
    if one_d:
        return out_scores[0], ids[0]
    return out_scores, ids


def _coverage_class(cnt: torch.Tensor, live_mask: torch.Tensor):
    """[n_q, N] bool: docs whose distinct-scoring-term count reaches the
    row maximum (the Stage-1 analogue of fusion's top quality class)."""
    cnt = cnt * live_mask[None, :]
    cmax = cnt.max(dim=1, keepdim=True).values
    return (cnt >= cmax) & (cmax > 0.0)


def _lim_rows(m: torch.Tensor, k: int) -> torch.Tensor:
    """[n_q, k] int32: the lowest True positions of mask ``m`` within the
    first LIM_WINDOW ids, ascending, at most LIM_K of them, padded."""
    n_q, n_pad = m.shape
    w = min(LIM_WINDOW, n_pad)
    k2 = min(LIM_K, k)
    pad = max(_LIM_PAD, n_pad)
    iota = torch.arange(w, device=m.device, dtype=torch.int64)
    key = torch.where(m[:, :w], iota[None, :], pad)
    out = torch.full((n_q, k), pad, dtype=torch.int64, device=m.device)
    out[:, :k2] = torch.topk(key, k2, dim=1, largest=False,
                             sorted=True).values
    return out.to(torch.int32)


def _fuzzy_block(scores, cnt, postings_docs, doc_lengths, fz_starts,
                 fz_lens, fz_group, grp_query, total_docs, stop_limit,
                 avgdl, n_q: int):
    """On-device fuzzy virtual-term scoring.

    Each fuzzy query token is a group of LD1-matched vocab terms
    (VectorModel.ExpandMissingTerm, :643-743); its terms' postings expand
    into a [n_grp, N] presence matrix (deduping the doc union), df is the
    row sum, idf the BM25 idf of df gated to 0 < df <= stop_limit, and
    every doc of the group gains ``idf * doc_fac`` (tf = 1) and one
    distinct-term count. ``fz_*`` and ``grp_query`` are host arrays.
    Groups add in group order, one pass per group rank (a group's position
    among its query's groups), so each cell sums in the same order as the
    reference's [n_q, n_grp] x [n_grp, N] product, with no atomics and no
    TF32. Returns (scores, cnt, fz_any)."""
    dev = scores.device
    f32 = torch.float32
    n_pad = doc_lengths.shape[0]
    n_grp = int(grp_query.size)
    fz_lens = np.asarray(fz_lens, np.int64)
    f_total = int(fz_lens.sum())
    lens_t = torch.from_numpy(fz_lens).to(dev)
    term = torch.repeat_interleave(
        torch.arange(lens_t.numel(), device=dev), lens_t,
        output_size=f_total)
    first = torch.cumsum(lens_t, 0) - lens_t
    pos = torch.arange(f_total, device=dev) - first[term]
    fidx = torch.from_numpy(np.asarray(fz_starts, np.int64)).to(dev)[term] + pos
    fgrp = torch.from_numpy(np.asarray(fz_group, np.int64)).to(dev)[term]
    presence = torch.zeros(n_grp * n_pad, dtype=f32, device=dev)
    presence[fgrp * n_pad + postings_docs[fidx].long()] = 1.0
    presence = presence.view(n_grp, n_pad)
    # virtual-term df = distinct posting docs (deleted included, like the
    # host union over raw postings); exact in f32 below 2^24
    df = presence.sum(dim=1)
    ratio = (total_docs - df + 0.5) / (df + 0.5)
    # f32 log1p differs in the last ulp between XLA, PyTorch's CPU
    # kernels and CUDA's log1pf; the port takes it in f64 and rounds once,
    # so every device gives the same idf (the nearest f32 to log1p).
    fidf = torch.where((df > 0) & (df <= stop_limit) & (ratio > 0),
                       torch.log1p(torch.clamp_min(ratio, 0.0).double())
                       .to(f32), 0.0)
    dl_all = torch.where(doc_lengths <= 0.0, 1.0, doc_lengths)
    fnorm = K1 * (1.0 - B + B * (dl_all / avgdl))
    doc_fac = torch.tensor(K1 + 1.0, dtype=f32, device=dev) / (
        1.0 + fnorm) + DELTA
    gq = torch.from_numpy(np.asarray(grp_query, np.int64)).to(dev)
    scoring = (fidf > 0.0).to(f32)
    fz_score = torch.zeros((n_q, n_pad), dtype=f32, device=dev)
    fz_cnt = torch.zeros((n_q, n_pad), dtype=f32, device=dev)
    g_rank = lanes.owner_ranks(grp_query)
    for r in range(int(g_rank.max(initial=-1)) + 1):
        sel = torch.from_numpy(np.flatnonzero(g_rank == r)).to(dev)
        pres = presence[sel]
        fz_score.index_add_(0, gq[sel], fidf[sel, None] * (pres * doc_fac))
        fz_cnt.index_add_(0, gq[sel], scoring[sel, None] * pres)
    return scores + fz_score, cnt + fz_cnt, fz_cnt > 0.0


def _bucket(n: int, minimum: int) -> int:
    """Quadrupling buckets (the reference's shape buckets; the port keeps
    them where they size host arrays shared with the reference)."""
    b = minimum
    while b < n:
        b *= 4
    return b


def _bucket2(n: int, minimum: int) -> int:
    """Doubling buckets (the doc axis n_pad)."""
    b = minimum
    while b < n:
        b *= 2
    return b


def split_batch_by_lanes(built: BuiltIndex, queries,
                         cap: int = 0) -> list:
    """Contiguous (lo, hi) query groups whose lane totals fit the per-call
    cap. A single query may exceed the cap (it gets its own group).
    Returns [(0, len(queries))] when no split is needed."""
    cap = cap or _MAX_L_PER_CALL
    built.ensure_champions()
    offsets = built.term_offsets
    cs, clen = built.champion_starts, built.champion_len

    def lane_count(ids: np.ndarray) -> int:
        if ids.size == 0:
            return 0
        full = (offsets[ids + 1] - offsets[ids]).astype(np.int64)
        if cs is not None:
            full = np.where(cs[ids] >= 0, clen, full)
        return int(full.sum())

    lanes_q = []
    for term_ids, _idf, fuzzy_groups in queries:
        n = lane_count(np.asarray(term_ids, dtype=np.int64))
        for grp in (fuzzy_groups or ()):
            n += lane_count(np.asarray(grp, dtype=np.int64))
        lanes_q.append(n)
    if sum(lanes_q) <= cap:
        return [(0, len(queries))]
    groups = []
    lo, acc = 0, 0
    for i, n in enumerate(lanes_q):
        if acc and acc + n > cap:
            groups.append((lo, i))
            lo, acc = i, 0
        acc += n
    groups.append((lo, len(queries)))
    return groups


def term_device_range(built: BuiltIndex, tid: int):
    """(start, len) of the term's device lanes: champion range for
    clipped high-df terms, full CSR range otherwise."""
    cs = built.champion_starts
    if cs is not None and cs[tid] >= 0:
        return int(cs[tid]), built.champion_len
    s = int(built.term_offsets[tid])
    return s, int(built.term_offsets[tid + 1]) - s


def prepare_batch_arrays(built: BuiltIndex, queries):
    """Host half of the batched Stage-1: flatten B queries' (term, idf)
    lists and fuzzy term-id groups into padded CSR-range arrays (the
    reference's layout, unchanged; pad entries have length 0)."""
    n_q = len(queries)
    n_q_pad = _bucket2(n_q, 1)

    starts_l, lens_l, idfs_l, tq_l = [], [], [], []
    fz_starts_p, fz_lens_p, fz_group_p = [], [], []
    grp_query_l: list = []
    built.ensure_champions()
    offsets = built.term_offsets
    cs = built.champion_starts
    clen = built.champion_len
    for qi, (term_ids, term_idf, fuzzy_groups) in enumerate(queries):
        for i, tid in enumerate(np.asarray(term_ids, dtype=np.int64)):
            s, n = term_device_range(built, int(tid))
            starts_l.append(s)
            lens_l.append(n)
            idfs_l.append(term_idf[i])
            tq_l.append(qi)
        for grp in (fuzzy_groups or ()):
            grp = np.asarray(grp, dtype=np.int64)
            if grp.size == 0:
                continue
            g = len(grp_query_l)
            grp_query_l.append(qi)
            s = offsets[grp].astype(np.int64)
            n = (offsets[grp + 1] - s).astype(np.int64)
            if cs is not None:
                champ = cs[grp]
                use = champ >= 0
                s = np.where(use, champ, s)
                n = np.where(use, clen, n)
            fz_starts_p.append(s.astype(np.int32))
            fz_lens_p.append(n.astype(np.int32))
            fz_group_p.append(np.full(grp.size, g, np.int32))

    qt = max(len(starts_l), 1)
    qt_pad = _bucket(qt, 8)
    starts = np.zeros(qt_pad, dtype=np.int32)
    lens = np.zeros(qt_pad, dtype=np.int32)
    idfs = np.zeros(qt_pad, dtype=np.float32)
    tq = np.zeros(qt_pad, dtype=np.int32)
    starts[: len(starts_l)] = starts_l
    lens[: len(lens_l)] = lens_l
    idfs[: len(idfs_l)] = idfs_l
    tq[: len(tq_l)] = tq_l

    total = int(lens.sum())
    l_pad = _bucket(max(total, 1), _MIN_L)

    n_groups = len(grp_query_l)
    if n_groups:
        fz_starts_all = np.concatenate(fz_starts_p)
        fz_lens_all = np.concatenate(fz_lens_p)
        fz_group_all = np.concatenate(fz_group_p)
        ft_pad = _bucket(int(fz_starts_all.size), 64)
        fz_starts = np.zeros(ft_pad, np.int32)
        fz_lens = np.zeros(ft_pad, np.int32)
        fz_group = np.zeros(ft_pad, np.int32)
        fz_starts[: fz_starts_all.size] = fz_starts_all
        fz_lens[: fz_lens_all.size] = fz_lens_all
        fz_group[: fz_group_all.size] = fz_group_all
        f_total = int(fz_lens_all.sum())
        f_pad = _bucket(max(f_total, 1), 1024)
        n_grp = _bucket2(n_groups, 1)
        grp_query = np.zeros(n_grp, np.int32)
        grp_query[:n_groups] = grp_query_l
    else:
        f_pad = 0
        n_grp = 0
        fz_starts = fz_lens = fz_group = np.zeros(0, np.int32)
        grp_query = np.zeros(0, np.int32)

    return (n_q_pad, starts, lens, idfs, tq, l_pad, fz_starts, fz_lens,
            fz_group, grp_query, f_pad, n_grp)


class DeviceIndex:
    """Device-resident CSR postings + batched Stage-1 search."""

    def __init__(self, built: BuiltIndex, deleted: Optional[np.ndarray] = None,
                 device=None):
        built.ensure_champions()
        n = built.num_docs
        n_pad = max(_bucket2(n + 1, 8), 128)
        # base CSR + champion extension in ONE buffer (clipped terms'
        # lanes point at their champion range), with CHUNK trailing zeros:
        # the plain lane expansion reads whole CHUNK-lane windows.
        ext_d = built.ext_docs if built.ext_docs.size else np.zeros(1, np.int32)
        ext_w = (built.ext_weights if built.ext_weights.size
                 else np.zeros(1, np.uint8))
        pd = np.zeros(ext_d.size + lanes.CHUNK, np.int32)
        pd[:ext_d.size] = ext_d
        pw = np.zeros(pd.size, np.uint8)
        pw[:ext_w.size] = ext_w
        dl = np.zeros(n_pad, dtype=np.float32)
        dl[:n] = built.doc_lengths
        self._load(built, pd, pw, dl, self._live(n, n_pad, deleted),
                   built.avgdl, device)

    @classmethod
    def from_state(cls, built: BuiltIndex, postings_docs, postings_weights,
                   doc_lengths, live_mask, avgdl, device=None) -> "DeviceIndex":
        """A DeviceIndex over given index state (numpy arrays, e.g. a
        reference ``DeviceIndex``'s; see ``infidex_tpu_torch.convert``).
        ``postings_docs`` must carry >= CHUNK trailing pad postings and
        ``doc_lengths``/``live_mask`` the padded doc axis (n_pad)."""
        self = cls.__new__(cls)
        built.ensure_champions()
        self._load(built, postings_docs, postings_weights, doc_lengths,
                   live_mask, avgdl, device)
        return self

    @staticmethod
    def _live(n: int, n_pad: int, deleted) -> np.ndarray:
        live = np.zeros(n_pad, dtype=np.float32)
        live[:n] = 1.0
        if deleted is not None and deleted.size >= n:
            live[:n] = np.where(deleted[:n], 0.0, 1.0)
        live[n_pad - 1] = 0.0  # parking slot never scores
        return live

    def _load(self, built, pd, pw, dl, live, avgdl, device) -> None:
        dev = torch.device(device) if device is not None else runtime.device()
        self.built = built
        self.num_docs = built.num_docs
        self.n_pad = int(np.asarray(dl).shape[0])
        if np.asarray(pd).size < built.ext_docs.size + lanes.CHUNK:
            raise ValueError("postings_docs needs CHUNK trailing pad postings")
        self.device = dev
        self.postings_docs = _upload(np.asarray(pd, np.int32), dev)
        self.doc_lengths = _upload(np.asarray(dl, np.float32), dev)
        self.live_mask = _upload(np.asarray(live, np.float32), dev)
        self.avgdl = torch.tensor(float(np.float32(avgdl)),
                                  dtype=torch.float32, device=dev)
        # per-posting BM25+ factor, computed once per index image; the
        # posting weights are not needed on the device after this
        self.cfac = lanes.posting_cfac(
            self.postings_docs,
            _upload(np.asarray(pw, np.uint8), dev),
            self.doc_lengths, self.avgdl)
        # filter-mask ∧ live-mask device buffers, keyed by mask identity
        self._mask_cache: Dict[int, tuple] = {}

    def set_deleted(self, deleted: np.ndarray) -> None:
        self.live_mask = torch.from_numpy(
            self._live(self.num_docs, self.n_pad, deleted)).to(self.device)
        self._mask_cache.clear()

    def masked_live(self, mask: Optional[np.ndarray]):
        """live_mask ∧ filter-mask as a device buffer (cached per mask
        object so repeated filtered batches upload the [N] mask once)."""
        if mask is None:
            return self.live_mask
        key = id(mask)
        hit = self._mask_cache.get(key)
        if hit is not None and hit[0] is mask:
            return hit[1]
        m = np.zeros(self.n_pad, np.float32)
        k = min(int(mask.size), self.num_docs)
        m[:k] = mask[:k].astype(np.float32)
        buf = torch.from_numpy(m).to(self.device) * self.live_mask
        if len(self._mask_cache) >= 16:
            self._mask_cache.clear()
        self._mask_cache[key] = (mask, buf)
        return buf

    def _max_q(self) -> int:
        # flat scatter keys are query*n_pad + doc in int32
        return max(1, ((1 << 31) - 1) // self.n_pad)

    def search_batch(self, queries, top_k: int,
                     total_docs: Optional[int] = None,
                     stop_term_limit: int = 1_250_000,
                     live_override=None) -> list:
        """Score B queries; returns [(scores f32[k], ids int32[k], lim
        int32[k])] * B. Each query is (term_ids, term_idf, fuzzy_groups);
        fuzzy_groups holds the LD1-matched vocab term ids of each unknown
        query token (their union/df/idf resolve on the device)."""
        return self.search_batch_collect(self.search_batch_dispatch(
            queries, top_k, total_docs=total_docs,
            stop_term_limit=stop_term_limit, live_override=live_override))

    def search_batch_dispatch(self, queries, top_k: int,
                              total_docs: Optional[int] = None,
                              stop_term_limit: int = 1_250_000,
                              live_override=None) -> list:
        """Async half of ``search_batch``: enqueue every lane-capped group
        on the device and return handles without waiting (CUDA work runs
        on the current stream; ``search_batch_collect`` reads it back)."""
        if not queries:
            return []
        max_q = self._max_q()
        handles: list = []
        for lo in range(0, len(queries), max_q):
            chunk = queries[lo:lo + max_q]
            for glo, ghi in split_batch_by_lanes(self.built, chunk):
                handles.append(self._dispatch_group(
                    chunk[glo:ghi], top_k, total_docs, stop_term_limit,
                    live_override))
        return handles

    def search_batch_collect(self, handles: list) -> list:
        """Blocking half of ``search_batch``: read back every dispatched
        group in dispatch order."""
        out: list = []
        for h in handles:
            out.extend(self._collect_group(h))
        return out

    def stage1_chunks(self, queries) -> lanes.QueryChunks:
        """The lane kernel's input for one lane-capped group of queries:
        its query-major chunk table, on this index's device."""
        return self._chunks(queries, prepare_batch_arrays(self.built, queries))

    def _chunks(self, queries, prep) -> lanes.QueryChunks:
        _, starts, lens, idfs, tq = prep[:5]
        n = sum(len(q[0]) for q in queries)   # pad terms have no lanes
        return lanes.build_query_chunks(starts[:n], lens[:n], idfs[:n],
                                        tq[:n], len(queries), self.n_pad,
                                        self.device)

    def _dispatch_group(self, queries, top_k, total_docs, stop_term_limit,
                        live_override, csr=None) -> dict:
        """Stage-1 for one lane-capped group of queries, enqueued.
        ``csr`` = (built, postings_docs, cfac) scores the queries' term
        ids over another CSR on this index's doc axis (mmap streaming's
        per-group mini CSR); by default this index's own."""
        built, postings_docs, cfac = csr or (self.built, self.postings_docs,
                                             self.cfac)
        dev = self.device
        f32 = torch.float32
        n_q = len(queries)
        n_pad = self.n_pad
        prep = prepare_batch_arrays(built, queries)
        fz_starts, fz_lens, fz_group, grp_query, _, n_grp = prep[6:]
        chunks = self._chunks(queries, prep)
        scores = torch.zeros(n_q * n_pad, dtype=f32, device=dev)
        cnt = torch.zeros(n_q * n_pad, dtype=f32, device=dev)
        lanes.scatter_lanes(scores, cnt, chunks, postings_docs, cfac)
        scores = scores.view(n_q, n_pad)
        cnt = cnt.view(n_q, n_pad)

        fz_any = None
        if n_grp > 0:
            td = torch.tensor(float(np.float32(
                total_docs if total_docs is not None else self.num_docs)),
                dtype=f32, device=dev)
            sl = torch.tensor(float(np.float32(stop_term_limit)), dtype=f32,
                              device=dev)
            scores, cnt, fz_any = _fuzzy_block(
                scores, cnt, postings_docs, self.doc_lengths,
                fz_starts, fz_lens, fz_group, grp_query, td, sl,
                torch.clamp_min(self.avgdl, 1e-9), n_q)

        live = live_override if live_override is not None else self.live_mask
        scores = scores * live[None, :]
        k = min(int(top_k), n_pad)
        top_scores, top_ids = stable_top_k(scores, k)
        m = _coverage_class(cnt, live)
        if fz_any is not None:
            m = m | (fz_any & (live[None, :] > 0.0))
        return dict(out=(top_scores, top_ids, _lim_rows(m, k)), n_q=n_q)

    @staticmethod
    def _collect_group(h: dict) -> list:
        """Blocking half: read back one dispatched group."""
        scores, ids, lim = (t.cpu().numpy() for t in h["out"])
        return [(scores[b], ids[b], lim[b]) for b in range(h["n_q"])]

    def pool_score_dispatch(self, jobs, top_k: int):
        """Device pool scoring (``INFIDEX_TPU_POOL_DEVICE=1``) is not
        ported: raises ``NotImplementedError``."""
        raise runtime.not_ported(runtime.POOL_SCORING)

    def pool_score_collect(self, handle):
        raise runtime.not_ported(runtime.POOL_SCORING)
