"""Stage-1 lane expansion + scatter for BM25+ scoring (PyTorch / CUDA).

Port of ``infidex_tpu/ops/stage1_lanes.py``. Every query term's lanes are
ONE contiguous slice of the CSR buffers; the host splits the slices into
``CHUNK``-lane pieces (``build_chunk_table``, unchanged from the
reference), and each lane yields a scatter key ``query * n_pad + doc``
and a contribution ``idf * cfac``.

``cfac`` is the per-posting BM25+ document factor precomputed once per
index build: ``(tf*(K1+1))/(tf + K1*(1-B+B*dl/avgdl)) + DELTA``
(Infidex ``Indexing/Bm25Scorer.cs:21-23,686-695``).

Scatter determinism. The reference adds every lane's contribution into
the flat score matrix with one scatter-add, which XLA on the CPU runs in
lane order; lane order is (query, term). Ranking ties (``stable_top_k``,
fusion tie classes) need bit-equal scores for equal documents, so the
port reproduces that order exactly instead of using float atomics: each
score cell must receive its query's terms' contributions in term RANK
order (a term's rank is its position among its query's terms). Within one
term no two lanes share a key — a term's postings are distinct docs — and
different queries own different key ranges, so between two ranks every
update is a plain read-add-write with no atomics.

Two layouts of one chunk table carry that order:

* query-major (``QueryChunks``, ``build_query_chunks``): each query's
  chunks in rank order, ``qstart[q]:qstart[q+1]`` the rows of query
  ``q``. The hand-written CUDA kernel (``csrc/stage1_lanes.cu``,
  expansion and scatter fused, so keys and contributions never reach
  device memory) runs ONE launch per group: one block per query walks its
  rows and synchronises between ranks.
* rank-major (``RankedChunks``, ``build_ranked_chunks``, or
  ``QueryChunks.ranked`` of a query-major table): rows
  ``bounds[r]:bounds[r+1]`` hold every query's rank-``r`` chunks.
  ``scatter_lanes_plain`` (the plain ``expand_lanes`` + ``index_add_``)
  runs one pass per rank.

``scatter_lanes`` takes the query-major table: the kernel for CUDA
tensors, the plain version on its rank-major view for CPU tensors. Both
take a doc window ``[doc_lo, doc_hi)``: a document shard of a sharded
index (``parallel/sharding.py``) walks the same table with its own
window and keys ``query * shard_size + (doc - doc_lo)``; lanes of other
shards' docs are skipped (parked at 0.0 by the plain version).
"""

from __future__ import annotations

import os
from typing import List, NamedTuple, Tuple

import numpy as np
import torch

from . import _kernels

CHUNK = int(os.environ.get("INFIDEX_TPU_LANE_CHUNK", "2048"))
assert CHUNK % 1024 == 0 and CHUNK > 0, "CHUNK must be a multiple of 1024"

K1 = 1.2
B = 0.75
DELTA = 1.0


def posting_cfac(postings_docs: torch.Tensor, postings_weights: torch.Tensor,
                 doc_lengths: torch.Tensor, avgdl) -> torch.Tensor:
    """Per-posting BM25+ document factor, f32 (see module docstring)."""
    f32 = torch.float32
    tf = postings_weights.to(f32)
    dl = doc_lengths[postings_docs.long()]
    dl = torch.where(dl <= 0.0, 1.0, dl)
    avgdl = torch.clamp_min(torch.as_tensor(avgdl, dtype=f32,
                                            device=dl.device), 1e-9)
    norm = K1 * (1.0 - B + B * (dl / avgdl))
    return (tf * (K1 + 1.0)) / (tf + norm) + DELTA


#: Chunk starts are aligned down to ALIGN with a [vstart, vend) valid
#: window (the reference's Mosaic DMA tiling). The CUDA kernel simply
#: reads each chunk's window; the table layout is kept so the port and
#: the reference expand identical lane spaces.
ALIGN = 1024

#: the end of a doc window that takes every doc (doc ids are int32)
ALL_DOCS = (1 << 31) - 1


def _chunk_spans(starts, lens):
    """Per term: aligned first offset, lead-in before the term's first
    posting, lanes spanned from the aligned offset, and chunk count."""
    starts = np.asarray(starts, np.int64)
    lens = np.asarray(lens, np.int64)
    off0 = (starts // ALIGN) * ALIGN
    lead = starts - off0
    span = np.where(lens > 0, lead + lens, 0)
    return off0, lead, span, (span + CHUNK - 1) // CHUNK


def build_chunk_table(starts: np.ndarray, lens: np.ndarray,
                      idfs: np.ndarray, qofs: np.ndarray,
                      n_pad: int) -> Tuple[np.ndarray, np.ndarray,
                                           np.ndarray, np.ndarray,
                                           np.ndarray]:
    """Split per-term CSR ranges into ALIGN-aligned CHUNK-lane pieces
    (host, vectorized).

    Returns (chunk_off, chunk_vstart, chunk_vend, chunk_idf, chunk_base):
    aligned posting offset, the chunk's valid lane window, query idf and
    flat scatter-key base (query * n_pad). Zero-length terms produce no
    chunks; lanes outside [vstart, vend) are parked by the expansion.
    """
    off0, lead, span, n_chunks = _chunk_spans(starts, lens)
    total = int(n_chunks.sum())
    if total == 0:
        z = np.zeros(0, np.int32)
        return z, z, z, np.zeros(0, np.float32), z
    term_of = np.repeat(np.arange(lens.size), n_chunks)
    bounds = np.concatenate([[0], np.cumsum(n_chunks)[:-1]])
    ci = np.arange(total, dtype=np.int64) - np.repeat(bounds, n_chunks)
    off = off0[term_of] + ci * CHUNK
    vstart = np.maximum(lead[term_of] - ci * CHUNK, 0)
    vend = np.minimum(span[term_of] - ci * CHUNK, CHUNK)
    return (off.astype(np.int32), vstart.astype(np.int32),
            vend.astype(np.int32),
            np.asarray(idfs, np.float32)[term_of],
            (np.asarray(qofs, np.int64)[term_of] * n_pad).astype(np.int32))


def owner_ranks(owner: np.ndarray) -> np.ndarray:
    """Position of each item among the items of the same owner, in
    order (``[0, 1, 1, 0, 1] -> [0, 0, 1, 1, 2]``)."""
    owner = np.asarray(owner, np.int64)
    order = np.argsort(owner, kind="stable")
    so = owner[order]
    ranks = np.empty(owner.size, np.int64)
    ranks[order] = np.arange(owner.size) - np.searchsorted(so, so)
    return ranks


class RankedChunks(NamedTuple):
    """Chunk table grouped by term rank: rows ``bounds[r]:bounds[r+1]``
    hold the chunks of every query's rank-``r`` term."""

    off: torch.Tensor      # int32 [c]
    vstart: torch.Tensor   # int32 [c]
    vend: torch.Tensor     # int32 [c]
    idf: torch.Tensor      # f32 [c]
    base: torch.Tensor     # int32 [c]
    bounds: List[int]


def build_ranked_chunks(starts, lens, idfs, qofs, n_pad: int,
                        device) -> RankedChunks:
    """``build_chunk_table`` per term rank, concatenated rank-major and
    uploaded to ``device`` (``qofs`` must be the terms' owning queries)."""
    ranks = owner_ranks(qofs)
    parts = []
    bounds = [0]
    for r in range(int(ranks.max(initial=-1)) + 1):
        sel = ranks == r
        t = build_chunk_table(np.asarray(starts)[sel], np.asarray(lens)[sel],
                              np.asarray(idfs)[sel], np.asarray(qofs)[sel],
                              n_pad)
        if t[0].size:
            parts.append(t)
            bounds.append(bounds[-1] + t[0].size)
    cols = ([np.concatenate([p[i] for p in parts]) for i in range(5)]
            if parts else [np.zeros(0, np.int32)] * 3
            + [np.zeros(0, np.float32), np.zeros(0, np.int32)])
    return RankedChunks(*(torch.from_numpy(c).to(device) for c in cols),
                        bounds=bounds)


class QueryChunks(NamedTuple):
    """Chunk table in query-major order: rows ``qstart[q]:qstart[q+1]``
    hold query ``q``'s chunks, its terms in rank order; ``rank`` is each
    row's term rank."""

    off: torch.Tensor      # int32 [c]
    vstart: torch.Tensor   # int32 [c]
    vend: torch.Tensor     # int32 [c]
    idf: torch.Tensor      # f32 [c]
    base: torch.Tensor     # int32 [c]
    rank: torch.Tensor     # int32 [c]
    qstart: torch.Tensor   # int32 [n_q + 1]

    def ranked(self) -> RankedChunks:
        """The same rows regrouped rank-major (stable, so each rank keeps
        query order): the table ``build_ranked_chunks`` gives for the
        same terms when they come query by query, as a batch's do."""
        order = torch.argsort(self.rank, stable=True)
        counts = torch.bincount(self.rank.long()).tolist()
        bounds = [0]
        for n in counts:
            if n:
                bounds.append(bounds[-1] + n)
        return RankedChunks(self.off[order], self.vstart[order],
                            self.vend[order], self.idf[order],
                            self.base[order], bounds=bounds)


def build_query_chunks(starts, lens, idfs, qofs, n_q: int, n_pad: int,
                       device) -> QueryChunks:
    """``build_chunk_table`` over the terms in (query, rank) order,
    uploaded to ``device``, with each row's term rank and the per-query
    row starts (``qofs``: the terms' owning queries, each < ``n_q``)."""
    qofs = np.asarray(qofs, np.int64)
    order = np.argsort(qofs, kind="stable")
    starts = np.asarray(starts, np.int64)[order]
    lens = np.asarray(lens, np.int64)[order]
    qofs = qofs[order]
    table = build_chunk_table(starts, lens, np.asarray(idfs)[order], qofs,
                              n_pad)
    n_chunks = _chunk_spans(starts, lens)[3]
    rank = np.repeat(owner_ranks(qofs), n_chunks).astype(np.int32)
    per_q = np.bincount(np.repeat(qofs, n_chunks), minlength=n_q)
    qstart = np.zeros(n_q + 1, np.int32)
    np.cumsum(per_q, out=qstart[1:])
    return QueryChunks(*(torch.from_numpy(c).to(device)
                         for c in (*table, rank, qstart)))


def expand_lanes(chunk_off, chunk_vstart, chunk_vend, chunk_idf, chunk_base,
                 postings_docs, cfac, park: int, doc_lo: int = 0,
                 doc_hi: int = ALL_DOCS):
    """Flat (scatter keys int32, contributions f32) for all chunks' lanes;
    lanes outside a chunk's valid window, or whose doc lies outside the
    doc window ``[doc_lo, doc_hi)``, are parked at ``park`` / 0.0. A
    lane's key is ``base + doc - doc_lo``.

    ``postings_docs``/``cfac`` must carry >= CHUNK trailing pad elements
    (every chunk reads CHUNK lanes from its aligned offset)."""
    dev = postings_docs.device
    lane = torch.arange(CHUNK, device=dev, dtype=torch.int64)
    idx = chunk_off.long()[:, None] + lane[None, :]
    valid = ((lane[None, :] >= chunk_vstart.long()[:, None])
             & (lane[None, :] < chunk_vend.long()[:, None]))
    docs = postings_docs[idx]
    valid &= (docs >= doc_lo) & (docs < doc_hi)
    contrib = torch.where(valid, chunk_idf[:, None] * cfac[idx], 0.0)
    keys = torch.where(valid, chunk_base[:, None] + (docs - doc_lo),
                       torch.tensor(park, dtype=torch.int32, device=dev))
    return keys.reshape(-1), contrib.reshape(-1)


def expand_lanes_reference(chunk_off, chunk_vstart, chunk_vend, chunk_idf,
                           chunk_base, postings_docs, cfac, park: int):
    """Pure-numpy oracle of expand_lanes for parity tests."""
    keys = np.full((len(chunk_off), CHUNK), park, np.int32)
    contrib = np.zeros((len(chunk_off), CHUNK), np.float32)
    docs = np.asarray(postings_docs)
    cf = np.asarray(cfac)
    for c in range(len(chunk_off)):
        vs, ve = int(chunk_vstart[c]), int(chunk_vend[c])
        s = int(chunk_off[c])
        keys[c, vs:ve] = chunk_base[c] + docs[s + vs:s + ve]
        contrib[c, vs:ve] = chunk_idf[c] * cf[s + vs:s + ve]
    return keys.reshape(-1), contrib.reshape(-1)


def scatter_lanes_plain(scores: torch.Tensor, cnt: torch.Tensor,
                        chunks: RankedChunks, postings_docs: torch.Tensor,
                        cfac: torch.Tensor, doc_lo: int = 0,
                        doc_hi: int = ALL_DOCS) -> None:
    """Plain PyTorch version of ``scatter_lanes`` (same passes, same
    per-cell addition order, same doc window). Parked lanes add 0.0 to
    the last cell."""
    park = scores.numel() - 1
    for lo, hi in zip(chunks.bounds, chunks.bounds[1:]):
        keys, contrib = expand_lanes(
            chunks.off[lo:hi], chunks.vstart[lo:hi], chunks.vend[lo:hi],
            chunks.idf[lo:hi], chunks.base[lo:hi], postings_docs, cfac,
            park, doc_lo, doc_hi)
        keys = keys.long()
        scores.index_add_(0, keys, contrib)
        cnt.index_add_(0, keys, (contrib > 0.0).to(torch.float32))


def scatter_lanes(scores: torch.Tensor, cnt: torch.Tensor,
                  chunks: QueryChunks, postings_docs: torch.Tensor,
                  cfac: torch.Tensor, doc_lo: int = 0,
                  doc_hi: int = ALL_DOCS) -> None:
    """In place: ``scores[key] += idf * cfac`` and ``cnt[key] += 1`` (for a
    positive contribution) over every lane of ``chunks`` whose doc lies in
    ``[doc_lo, doc_hi)`` (a document shard; the whole doc axis by
    default), ``key = base + doc - doc_lo``, each cell's terms in rank
    order. CUDA tensors launch the hand-written kernel once for the whole
    table; CPU tensors take the plain version on its rank-major view."""
    if scores.device.type == "cpu":
        scatter_lanes_plain(scores, cnt, chunks.ranked(), postings_docs, cfac,
                            doc_lo, doc_hi)
        return
    _kernels.stage1_scatter_lanes(
        scores, cnt, chunks.qstart, chunks.off, chunks.vstart, chunks.vend,
        chunks.idf, chunks.base, chunks.rank, postings_docs, cfac, doc_lo,
        doc_hi)
