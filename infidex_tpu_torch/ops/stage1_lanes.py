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
port reproduces that order exactly instead of using float atomics: the
chunks are grouped by term RANK (a term's position among its query's
terms) and each rank is scattered in its own pass, in rank order. Within
one rank no two lanes share a key — a term's postings are distinct docs
and different queries own different key ranges — so each pass is a plain
read-add-write with no atomics, and each score cell receives its terms'
contributions in exactly the serial order. ``scatter_lanes`` runs one
pass per rank: the hand-written CUDA kernel (``csrc/stage1_lanes.cu``,
expansion and scatter fused, so keys and contributions never reach
device memory) for CUDA tensors, and ``scatter_lanes_plain`` (the plain
``expand_lanes`` + ``index_add_``) for CPU tensors.
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
    starts = np.asarray(starts, np.int64)
    lens = np.asarray(lens, np.int64)
    off0 = (starts // ALIGN) * ALIGN
    lead = starts - off0
    span = np.where(lens > 0, lead + lens, 0)
    n_chunks = (span + CHUNK - 1) // CHUNK
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


def expand_lanes(chunk_off, chunk_vstart, chunk_vend, chunk_idf, chunk_base,
                 postings_docs, cfac, park: int):
    """Flat (scatter keys int32, contributions f32) for all chunks' lanes;
    lanes outside a chunk's valid window are parked at ``park`` / 0.0.

    ``postings_docs``/``cfac`` must carry >= CHUNK trailing pad elements
    (every chunk reads CHUNK lanes from its aligned offset)."""
    dev = postings_docs.device
    lane = torch.arange(CHUNK, device=dev, dtype=torch.int64)
    idx = chunk_off.long()[:, None] + lane[None, :]
    valid = ((lane[None, :] >= chunk_vstart.long()[:, None])
             & (lane[None, :] < chunk_vend.long()[:, None]))
    contrib = torch.where(valid, chunk_idf[:, None] * cfac[idx], 0.0)
    keys = torch.where(valid, chunk_base[:, None] + postings_docs[idx],
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
                        cfac: torch.Tensor) -> None:
    """Plain PyTorch version of ``scatter_lanes`` (same passes, same
    per-cell addition order). Parked lanes add 0.0 to the last cell."""
    park = scores.numel() - 1
    for lo, hi in zip(chunks.bounds, chunks.bounds[1:]):
        keys, contrib = expand_lanes(
            chunks.off[lo:hi], chunks.vstart[lo:hi], chunks.vend[lo:hi],
            chunks.idf[lo:hi], chunks.base[lo:hi], postings_docs, cfac,
            park)
        keys = keys.long()
        scores.index_add_(0, keys, contrib)
        cnt.index_add_(0, keys, (contrib > 0.0).to(torch.float32))


def scatter_lanes(scores: torch.Tensor, cnt: torch.Tensor,
                  chunks: RankedChunks, postings_docs: torch.Tensor,
                  cfac: torch.Tensor) -> None:
    """In place: ``scores[key] += idf * cfac`` and ``cnt[key] += 1`` (for a
    positive contribution) over every lane of ``chunks``, one pass per
    term rank. CUDA tensors launch the hand-written kernel once per rank;
    CPU tensors take the plain version."""
    if scores.device.type == "cpu":
        scatter_lanes_plain(scores, cnt, chunks, postings_docs, cfac)
        return
    for lo, hi in zip(chunks.bounds, chunks.bounds[1:]):
        _kernels.stage1_scatter_lanes(
            scores, cnt, chunks.off, chunks.vstart, chunks.vend, chunks.idf,
            chunks.base, lo, hi, postings_docs, cfac)
