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
low-id-matcher (LIM) rows of each query's top quality class. On CUDA the
epilogue is four hand-written kernels (``csrc/stage1_fuzzy.cu``: the
groups' presence bitset and df; ``csrc/stage1_epilogue.cu``: one pass
adding the groups, applying the live mask and taking the row max of the
counts; ``csrc/stage1_topk.cu``; ``csrc/stage1_lim.cu``), reached through
the dispatchers below; CPU tensors take their plain versions.

``DeviceIndex.search`` is the single-query route (the reference's
``_stage1_kernel``): the lane kernel on one row, the query's explicit
fuzzy extra postings (host-materialised doc unions, tf = 1) added after
its lanes by ``csrc/stage1_extras.cu`` (dispatcher ``stage1_extras``),
then the epilogue pass (the live mask only) and the top-k kernel.

Every f32 operation is rounded on its own (no FMA contraction, no
atomics, no TF32), so CPU and CUDA give the same bits: the lane scatter
keeps the reference's serial per-cell addition order (see
``ops/stage1_lanes.py``; given the same per-posting factors the scores
equal the reference's bit for bit), the fuzzy scores accumulate per group
in group order, and the top-k orders score and id as one unique key, so
tie order never depends on the device. Ids come back as integers
(no f32 packing, no 2^24-doc cap on the id path).
"""

from __future__ import annotations

import os
from typing import Dict, NamedTuple, Optional

import numpy as np
import torch

from .. import runtime
from ..ops import _kernels
from ..ops import stage1_lanes as lanes
from ..ops.coverage_kernel import _upload
from ..ops.pool_score import pool_score
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


def order_keys(scores: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """int64 keys that order (score, id) pairs by (score desc, id asc)
    when taken largest first: the high 32 bits are the order-preserving
    integer image of the f32 score, the low 32 bits the inverted id
    (``0 <= id < 2^32``; ``ids`` broadcasts against ``scores``). ``-0.0``
    is folded into ``+0.0`` first so the two compare equal, as floats
    do."""
    bits = (scores + 0.0).contiguous().view(torch.int32)
    order = bits ^ ((bits >> 31) & 0x7FFFFFFF)
    return order.to(torch.int64) * (1 << 32) + (
        (1 << 32) - 1 - ids.to(torch.int64))


def stable_top_k_plain(scores: torch.Tensor, k: int):
    """Top-k of each row by (score desc, doc id asc), exactly.

    Each (score, id) pair becomes one unique int64 key (``order_keys``).
    One top-k over unique keys has no ties, so the selection and its order
    are the same on every device and at every depth (membership nests
    across k)."""
    one_d = scores.dim() == 1
    if one_d:
        scores = scores[None, :]
    n_pad = scores.shape[-1]
    key = order_keys(scores, torch.arange(n_pad, device=scores.device,
                                          dtype=torch.int64)[None, :])
    top = torch.topk(key, k, dim=1, largest=True, sorted=True).values
    ids = ((1 << 32) - 1 - (top & 0xFFFFFFFF))
    out_scores = torch.gather(scores, 1, ids)
    ids = ids.to(torch.int32)
    if one_d:
        return out_scores[0], ids[0]
    return out_scores, ids


def _use_plain(t: torch.Tensor) -> bool:
    """The Stage-1 dispatchers' route (the epilogue's and the extras'):
    plain PyTorch for CPU tensors, the kernels for every other device
    (CUDA; elsewhere they raise)."""
    return t.device.type == "cpu"


def stable_top_k(scores: torch.Tensor, k: int):
    """Top-k of each row (or of a 1-D row) by (score desc, doc id asc),
    exactly: (scores f32, ids int32), [n_rows, k]. CPU tensors take the
    plain version; CUDA tensors ``csrc/stage1_topk.cu``, which gives the
    same ids and score bits without a key matrix."""
    if _use_plain(scores):
        return stable_top_k_plain(scores, k)
    if scores.dim() == 1:
        s, i = _kernels.stage1_topk(scores[None, :].contiguous(), k)
        return s[0], i[0]
    return _kernels.stage1_topk(scores.contiguous(), k)


def _lim_rows(m: torch.Tensor, k: int, k2: Optional[int] = None,
              window: Optional[int] = None, id_offset: int = 0,
              pad: Optional[int] = None) -> torch.Tensor:
    """[n_q, k] int32: the lowest True positions of mask ``m`` within the
    first ``window`` ids (LIM_WINDOW), ascending, at most ``k2``
    (min(LIM_K, k)) of them, each plus ``id_offset``, padded with ``pad``
    (max(2^24, n_pad))."""
    n_q, n_pad = m.shape
    w = min(LIM_WINDOW if window is None else window, n_pad)
    k2 = min(LIM_K, k) if k2 is None else k2
    pad = max(_LIM_PAD, n_pad) if pad is None else pad
    iota = torch.arange(n_pad, device=m.device, dtype=torch.int64)
    key = torch.where(m & (iota < w)[None, :], iota[None, :] + id_offset,
                      pad)
    out = torch.full((n_q, k), pad, dtype=torch.int64, device=m.device)
    out[:, :k2] = torch.topk(key, k2, dim=1, largest=False,
                             sorted=True).values
    return out.to(torch.int32)


def lim_rows_plain(cnt, live, thresh, fz_any, k_out: int, k2: int,
                   window: int, id_offset: int, pad: int) -> torch.Tensor:
    """Plain version of ``lim_rows``: the class mask (the docs whose
    distinct-scoring-term count reaches ``thresh``, the Stage-1 analogue of
    fusion's top quality class, or'ed with the fuzzy-covered live docs),
    then ``_lim_rows``."""
    cnt = cnt * live[None, :]
    m = (cnt >= thresh[:, None]) & (thresh[:, None] > 0.0)
    if fz_any is not None:
        m = m | (fz_any & (live[None, :] > 0.0))
    return _lim_rows(m, k_out, k2, window, id_offset, pad)


def lim_rows(cnt, live, thresh, k_out: int, *, k2: int, window: int,
             pad: int, id_offset: int = 0, fz_any=None, presence=None,
             fidf=None, fz=None) -> torch.Tensor:
    """[n_q, k_out] int32 LIM rows: per query the ``k2`` lowest ids below
    ``window`` of its top quality class (``cnt * live >= thresh`` with
    ``thresh > 0``, or covered by one of its scoring fuzzy groups where
    live), ascending, plus ``id_offset``, padded with ``pad``. The fuzzy
    cover comes as the route keeps it: ``fz_any`` (bool [n_q, width]) on
    the CPU; ``presence`` (the bitset), ``fidf`` and ``fz`` (the group
    tables) on CUDA, where ``csrc/stage1_lim.cu`` runs."""
    if _use_plain(cnt):
        return lim_rows_plain(cnt, live, thresh, fz_any, k_out, k2, window,
                              id_offset, pad)
    return _kernels.stage1_lim(
        cnt, live, thresh, presence, fidf,
        fz.d_qoff if fz is not None else None,
        fz.d_qgrp if fz is not None else None, k_out, k2, window, id_offset,
        pad)


class FuzzyGroups(NamedTuple):
    """The fuzzy groups of one Stage-1 group (``prepare_batch_arrays``):
    the padded host tables, and the same on the device as views of one
    int32 buffer (one upload) for the kernels, with each query's groups
    in rank order (``lanes.owner_ranks``)."""

    starts: np.ndarray          # int32 [T] first posting of each term
    lens: np.ndarray            # int32 [T]
    group: np.ndarray           # int32 [T] owning group
    grp_query: np.ndarray       # int32 [n_grp] owning query (pads: 0)
    n_lanes: int                # postings of all terms
    d_starts: torch.Tensor      # int32 [T]
    d_group: torch.Tensor       # int32 [T]
    d_cum: torch.Tensor         # int32 [T + 1] first lane of each term
    d_qoff: torch.Tensor        # int32 [n_q + 1]
    d_qgrp: torch.Tensor        # int32 [n_grp] groups by query, rank order


def fuzzy_groups(fz_starts, fz_lens, fz_group, grp_query, n_q: int,
                 dev) -> FuzzyGroups:
    """``FuzzyGroups`` of ``prepare_batch_arrays``' fuzzy tables for
    ``n_q`` queries, its device buffer on ``dev``."""
    starts = np.asarray(fz_starts, np.int32)
    lens = np.asarray(fz_lens, np.int32)
    group = np.asarray(fz_group, np.int32)
    grp_query = np.asarray(grp_query, np.int32)
    n_t = starts.size
    cum = np.zeros(n_t + 1, np.int64)
    np.cumsum(lens, out=cum[1:])
    q_off = np.zeros(n_q + 1, np.int64)
    np.cumsum(np.bincount(grp_query, minlength=n_q), out=q_off[1:])
    q_grp = np.argsort(grp_query, kind="stable")
    buf = _upload(np.concatenate([starts, group, cum, q_off, q_grp])
                  .astype(np.int32), dev)
    ends = np.cumsum([n_t, n_t, n_t + 1, n_q + 1, q_grp.size])
    views = torch.tensor_split(buf, ends[:-1].tolist())
    return FuzzyGroups(starts, lens, group, grp_query, int(cum[-1]), *views)


def fuzzy_presence_plain(postings_docs, fz_starts, fz_lens, fz_group,
                         n_grp: int, doc_lo: int,
                         doc_hi: int) -> torch.Tensor:
    """[n_grp, doc_hi - doc_lo] f32: 1 where a doc of the window
    ``[doc_lo, doc_hi)`` carries a posting of one of the group's matched
    terms (the union of the group's posting docs). ``fz_*`` are host
    arrays; lanes of docs outside the window park in a dropped slot."""
    dev = postings_docs.device
    width = doc_hi - doc_lo
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
    local = postings_docs[fidx].long() - doc_lo
    inside = (local >= 0) & (local < width)
    presence = torch.zeros(n_grp * width + 1, dtype=torch.float32,
                           device=dev)
    presence[torch.where(inside, fgrp * width + local, n_grp * width)] = 1.0
    return presence[:n_grp * width].view(n_grp, width)


def fuzzy_presence(postings_docs, fz: FuzzyGroups, n_grp: int, doc_lo: int,
                   doc_hi: int):
    """(presence, df) of the fuzzy groups over the doc window
    ``[doc_lo, doc_hi)``: df (int32 [n_grp], exact) counts each group's
    distinct posting docs in the window, deleted ones included (as the
    host union over raw postings does). The presence is what the route
    keeps: a dense f32 [n_grp, width] matrix on the CPU
    (``fuzzy_presence_plain``), a bitset int32 [n_grp, ceil(width / 32)]
    from ``csrc/stage1_fuzzy.cu`` on CUDA."""
    if _use_plain(postings_docs):
        presence = fuzzy_presence_plain(postings_docs, fz.starts, fz.lens,
                                        fz.group, n_grp, doc_lo, doc_hi)
        # exact in f32 below 2^24
        return presence, presence.sum(dim=1).to(torch.int32)
    return _kernels.stage1_fuzzy(postings_docs, fz.d_starts, fz.d_group,
                                 fz.d_cum, fz.n_lanes, n_grp, doc_lo, doc_hi)


def fuzzy_idf(df, total_docs, stop_limit):
    """Each fuzzy group's BM25 idf from its df over the WHOLE index,
    gated to 0 < df <= stop_limit (f32 [n_grp])."""
    df = df.to(torch.float32)
    ratio = (total_docs - df + 0.5) / (df + 0.5)
    # f32 log1p differs in the last ulp between XLA, PyTorch's CPU
    # kernels and CUDA's log1pf; the port takes it in f64 and rounds once,
    # so every device gives the same idf (the nearest f32 to log1p).
    return torch.where((df > 0) & (df <= stop_limit) & (ratio > 0),
                       torch.log1p(torch.clamp_min(ratio, 0.0).double())
                       .to(torch.float32), 0.0)


def fuzzy_doc_factor(doc_lengths, avgdl):
    """The fuzzy groups' per-doc BM25+ factor at tf = 1 (``avgdl`` a
    one-element tensor; the divisors stay tensors, so CPU and CUDA round
    alike)."""
    dl_all = torch.where(doc_lengths <= 0.0, 1.0, doc_lengths)
    fnorm = K1 * (1.0 - B + B * (dl_all / torch.clamp_min(avgdl, 1e-9)))
    return torch.tensor(K1 + 1.0, dtype=torch.float32,
                        device=doc_lengths.device) / (1.0 + fnorm) + DELTA


class ExtrasTable(NamedTuple):
    """A single query's extra postings doc-major (``extras_table``), as
    ``csrc/stage1_extras.cu`` reads them: views of one int32 upload."""

    docs: torch.Tensor     # int32 [U] distinct docs, ascending
    off: torch.Tensor      # int32 [U + 1] first extra of each doc
    idf: torch.Tensor      # f32 [E] the extras' idfs, doc-major


def _extras_host(extra_docs, extra_idf, width: int):
    """(docs int64 [E], idf f32 [E]) of a query's extra postings, checked:
    as many idfs as docs, every doc inside the score row."""
    docs = np.asarray(extra_docs, np.int64).reshape(-1)
    idf = np.asarray(extra_idf, np.float32).reshape(-1)
    if idf.size != docs.size:
        raise ValueError(f"extra postings: {docs.size} docs, {idf.size} idfs")
    if docs.size and (docs.min() < 0 or docs.max() >= width):
        raise ValueError(f"extra postings: a doc outside [0, {width})")
    return docs, idf


def extras_table(extra_docs, extra_idf, dev) -> ExtrasTable:
    """The extras grouped by doc (a stable sort, so each doc keeps its
    extras in array order), uploaded to ``dev`` in one copy."""
    order = np.argsort(extra_docs, kind="stable")
    docs = extra_docs[order]
    first = np.flatnonzero(np.r_[True, docs[1:] != docs[:-1]])
    n_u = first.size
    buf = _upload(np.concatenate([
        docs[first], first, [docs.size],
        extra_idf[order].view(np.int32)]).astype(np.int32), dev)
    return ExtrasTable(buf[:n_u], buf[n_u:2 * n_u + 1],
                       buf[2 * n_u + 1:].view(torch.float32))


def stage1_extras_plain(scores, extra_docs, extra_idf, doc_fac) -> None:
    """Plain version of ``stage1_extras``: one ``index_add_`` per
    occurrence rank (each doc's first extras, then its second ones, ...),
    so that each cell adds its extras one at a time in array order."""
    dev = scores.device
    rank = lanes.owner_ranks(extra_docs)
    for r in range(int(rank.max(initial=-1)) + 1):
        sel = np.flatnonzero(rank == r)
        d = torch.from_numpy(extra_docs[sel]).to(dev)
        idf = torch.from_numpy(extra_idf[sel]).to(dev)
        scores.index_add_(0, d, idf * doc_fac[d])


def stage1_extras(scores, extra_docs, extra_idf, doc_fac) -> None:
    """In place on one query's score row (f32 [width]): each explicit
    fuzzy extra posting (``extra_docs`` with ``extra_idf``, host arrays;
    a doc may repeat) adds ``idf * doc_fac[doc]``, a doc's extras in array
    order. CPU tensors take the plain version; CUDA tensors
    ``csrc/stage1_extras.cu`` over the doc-major ``extras_table``."""
    docs, idf = _extras_host(extra_docs, extra_idf, scores.numel())
    if docs.size == 0:
        return
    if _use_plain(scores):
        stage1_extras_plain(scores, docs, idf, doc_fac)
        return
    t = extras_table(docs, idf, scores.device)
    _kernels.stage1_extras(scores, t.docs, t.off, t.idf, doc_fac)


def _fuzzy_apply(scores, cnt, presence, fidf, doc_fac, grp_query,
                 n_q: int):
    """The fuzzy groups' scores and counts over the docs of ``presence``
    (``doc_fac`` the same docs'), given each group's idf. Groups add in
    group order, one pass per group rank (a group's position among its
    query's groups), so each cell sums in the same order as the
    reference's [n_q, n_grp] x [n_grp, N] product, with no atomics and no
    TF32. Returns (scores, cnt, fz_any)."""
    dev = scores.device
    f32 = torch.float32
    n_pad = doc_fac.shape[0]
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


def stage1_epilogue_plain(scores, cnt, live, presence, fidf, doc_fac,
                          grp_query):
    """Plain version of ``stage1_epilogue``: the fuzzy block's scores and
    counts (``_fuzzy_apply``, skipped without fuzzy groups), the live
    mask, and the row max of the live counts. Returns (scores, cnt,
    rowmax, fz_any)."""
    fz_any = None
    if presence is not None:
        scores, cnt, fz_any = _fuzzy_apply(scores, cnt, presence, fidf,
                                           doc_fac, grp_query,
                                           scores.shape[0])
    scores = scores * live[None, :]
    rowmax = (cnt * live[None, :]).max(dim=1).values
    return scores, cnt, rowmax, fz_any


def stage1_epilogue(scores, cnt, live, fz: Optional[FuzzyGroups], presence,
                    fidf, doc_fac):
    """The pass over a Stage-1 group's [n_q, width] score and count
    matrices: the fuzzy groups' ``idf * doc_fac`` and counts added in
    group-rank order where their presence is set (``fz`` None: no fuzzy
    groups), the scores times ``live``, and each row's max of
    ``cnt * live``. Returns (scores, cnt, rowmax f32 [n_q], fz_any): CPU
    tensors take the plain version (``fz_any`` the fuzzy-covered docs,
    bool [n_q, width]); CUDA tensors ``csrc/stage1_epilogue.cu``, in place
    (``fz_any`` None: ``lim_rows`` reads the bitset)."""
    if _use_plain(scores):
        return stage1_epilogue_plain(
            scores, cnt, live, presence, fidf, doc_fac,
            fz.grp_query if fz is not None else None)
    rowmax = _kernels.stage1_epilogue(
        scores, cnt, live, presence, fidf, doc_fac,
        fz.d_qoff if fz is not None else None,
        fz.d_qgrp if fz is not None else None)
    return scores, cnt, rowmax, None


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


def single_query_chunks(built: BuiltIndex, term_ids, term_idf, width: int,
                        device) -> lanes.QueryChunks:
    """The lane kernel's chunk table of ONE query's terms (their device
    ranges, ``term_device_range``) over a score row of ``width`` cells,
    on ``device``."""
    ranges = [term_device_range(built, int(t))
              for t in np.asarray(term_ids, np.int64).reshape(-1)]
    starts = np.asarray([r[0] for r in ranges], np.int64)
    lens = np.asarray([r[1] for r in ranges], np.int64)
    idfs = np.asarray(term_idf, np.float32).reshape(-1)[:len(ranges)]
    return lanes.build_query_chunks(starts, lens, idfs,
                                    np.zeros(len(ranges), np.int64), 1,
                                    width, device)


def read_top_k(scores, ids):
    """(scores f32[k], ids int32[k]) numpy arrays of a [1, k] top-k, in
    one readback."""
    k = scores.shape[-1]
    row = torch.cat([scores.reshape(1, k).view(torch.int32),
                     ids.reshape(1, k).to(torch.int32)], dim=1).cpu().numpy()
    return row[0, :k].view(np.float32), row[0, k:]


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
        # per-posting BM25+ factor, computed once per index image; Stage 1
        # keeps no posting weights on the device. Pool scoring (off by
        # default) uploads them at its first dispatch.
        self._weights_host = np.asarray(pw, np.uint8)
        self._pool_weights = None
        self.cfac = lanes.posting_cfac(
            self.postings_docs, _upload(self._weights_host, dev),
            self.doc_lengths, self.avgdl)
        # the fuzzy groups' per-doc factor, once per index image
        self.doc_fac = fuzzy_doc_factor(self.doc_lengths, self.avgdl)
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

    def search(self, term_ids, term_idf, top_k: int, extra_docs=None,
               extra_idf=None):
        """Score one query's terms (by id, with their idfs) and its
        explicit fuzzy extra postings (``extra_docs`` with ``extra_idf``:
        the doc unions of its typo tokens' matched terms, tf = 1, a doc
        may repeat); return the top-k by (score desc, id asc) as
        (scores f32[k], internal doc ids int32[k]) numpy arrays, k =
        min(top_k, n_pad). Entries with score <= 0 are non-matches.

        On a card: one lane-kernel launch (none without lanes), one
        extras launch where there are extras, one epilogue pass (the live
        mask) and one top-k launch, then one readback."""
        dev, n_pad = self.device, self.n_pad
        scores = torch.zeros(n_pad, dtype=torch.float32, device=dev)
        cnt = torch.zeros_like(scores)
        lanes.scatter_lanes(scores, cnt, single_query_chunks(
            self.built, term_ids, term_idf, n_pad, dev), self.postings_docs,
            self.cfac, 0, n_pad)
        if extra_docs is not None:
            stage1_extras(scores, extra_docs, extra_idf, self.doc_fac)
        scores = stage1_epilogue(scores.view(1, n_pad), cnt.view(1, n_pad),
                                 self.live_mask, None, None, None, None)[0]
        return read_top_k(*stable_top_k(scores, min(int(top_k), n_pad)))

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
        lanes.scatter_lanes(scores, cnt, chunks, postings_docs, cfac, 0,
                            n_pad)
        scores = scores.view(n_q, n_pad)
        cnt = cnt.view(n_q, n_pad)

        # the epilogue: fuzzy groups, live mask, top-k, LIM rows (four
        # kernels on CUDA; see stage1_epilogue, stable_top_k, lim_rows)
        fz = presence = fidf = None
        if n_grp > 0:
            td = torch.tensor(float(np.float32(
                total_docs if total_docs is not None else self.num_docs)),
                dtype=f32, device=dev)
            sl = torch.tensor(float(np.float32(stop_term_limit)), dtype=f32,
                              device=dev)
            fz = fuzzy_groups(fz_starts, fz_lens, fz_group, grp_query, n_q,
                              dev)
            presence, df = fuzzy_presence(postings_docs, fz, n_grp, 0, n_pad)
            fidf = fuzzy_idf(df, td, sl)

        live = live_override if live_override is not None else self.live_mask
        scores, cnt, rowmax, fz_any = stage1_epilogue(
            scores, cnt, live, fz, presence, fidf, self.doc_fac)
        k = min(int(top_k), n_pad)
        top_scores, top_ids = stable_top_k(scores, k)
        lim = lim_rows(cnt, live, rowmax, k, k2=min(LIM_K, k),
                       window=min(LIM_WINDOW, n_pad),
                       pad=max(_LIM_PAD, n_pad), fz_any=fz_any,
                       presence=presence, fidf=fidf, fz=fz)
        return dict(out=(top_scores, top_ids, lim), n_q=n_q)

    @staticmethod
    def _collect_group(h: dict) -> list:
        """Blocking half: read back one dispatched group."""
        scores, ids, lim = (t.cpu().numpy() for t in h["out"])
        return [(scores[b], ids[b], lim[b]) for b in range(h["n_q"])]

    # ---- tier-pool scoring (host-selected candidates, device BM25) ----
    #
    # The host tier path (index/candidates.py TieredStage1) selects a
    # few-thousand-doc candidate pool per heavy multi-term query; with
    # INFIDEX_TPU_POOL_DEVICE=1 its exact BM25+ runs on the device as a
    # batched binary-search join over the FULL base CSR (ops/pool_score.py,
    # csrc/pool_score.cu), queued behind the batch's Stage-1 groups.

    def pool_score_dispatch(self, jobs, top_k: int):
        """Async: score B host-selected pools on the device; returns a
        handle (None for no jobs).

        ``jobs``: list of (pool int64[] ascending live doc ids, term_ids,
        term_idf). Scoring is exact over the full base CSR, bit-equal to
        ``candidates.score_pool`` (same f32 op order). Pair with
        ``pool_score_collect``."""
        if not jobs:
            return None
        args = self.pool_args(jobs)
        scores = pool_score(*args)
        k = min(int(top_k), scores.shape[1])
        top_scores, top_pos = stable_top_k(scores, k)
        top_ids = torch.gather(args[0], 1, top_pos.long())
        return dict(out=(top_scores, top_ids), n=len(jobs))

    def pool_args(self, jobs) -> tuple:
        """The arguments of ``ops.pool_score.pool_score`` for ``jobs`` (see
        ``pool_score_dispatch``), on this index's device: the pools padded
        to [B, Pp] (pad id n_pad - 1, not valid), their terms' full base
        CSR ranges and idfs [B, T], the postings and their uint8 weights
        (uploaded at the first call: Stage 1 does not keep them), the doc
        lengths and avgdl. B, Pp and T are the reference's buckets."""
        offsets = self.built.term_offsets
        b_pad = _bucket2(len(jobs), 4)
        p_max = max(int(np.asarray(j[0]).size) for j in jobs)
        p_pad = _bucket2(max(p_max, 1), 512)
        t_max = max(len(j[1]) for j in jobs)
        t_pad = _bucket(max(t_max, 1), 8)
        pool = np.full((b_pad, p_pad), self.n_pad - 1, np.int32)
        valid = np.zeros((b_pad, p_pad), bool)
        starts = np.zeros((b_pad, t_pad), np.int32)
        lens = np.zeros((b_pad, t_pad), np.int32)
        idfs = np.zeros((b_pad, t_pad), np.float32)
        for b, (p, term_ids, term_idf) in enumerate(jobs):
            p = np.asarray(p)
            pool[b, : p.size] = p
            valid[b, : p.size] = True
            for j, tid in enumerate(np.asarray(term_ids, np.int64)):
                starts[b, j] = offsets[tid]
                lens[b, j] = offsets[tid + 1] - offsets[tid]
                idfs[b, j] = term_idf[j]
        dev = self.device
        if self._pool_weights is None:
            self._pool_weights = _upload(self._weights_host, dev)
        return (_upload(pool, dev), _upload(valid, dev), _upload(starts, dev),
                _upload(lens, dev), _upload(idfs, dev), self.postings_docs,
                self._pool_weights, self.doc_lengths, self.avgdl)

    @staticmethod
    def pool_score_collect(handle):
        """Blocking half of ``pool_score_dispatch``: one readback per
        output; returns [(scores f32[k], ids int32[k])] per job."""
        if handle is None:
            return []
        scores, ids = (t.cpu().numpy() for t in handle["out"])
        return [(scores[b], ids[b].astype(np.int32))
                for b in range(handle["n"])]
