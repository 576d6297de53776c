"""Exact BM25+ of host-selected candidate pools (device pool scoring).

Port of the reference's ``_pool_score_kernel`` (``infidex_tpu/index/
device.py``), the device half of ``INFIDEX_TPU_POOL_DEVICE=1``: the host
tier path (``index/candidates.py TieredStage1.select_pool``) picks a pool
of a few thousand docs per heavy multi-term query, and the device scores
the pool exactly over the FULL base CSR (no champion clipping), with the
same f32 operation order as the host scorer ``candidates.score_pool`` and
its native twin, so the scores are bit-equal whichever side scored them.

For each (job, pool slot) and each term in order, the doc is looked up in
the term's doc-sorted, duplicate-free posting range (its lower bound is
unique, so every exact search finds the same posting), and
``idf * ((tf*(K1+1))/(tf+norm) + DELTA)`` is added where it is found. The
reference searches in exactly ``BSEARCH_BITS`` steps, which is exact for
ranges of fewer than 2^21 postings; the plain version takes that many
steps, or as many as its longest range needs, and the kernel searches
until it converges, so both are exact for a range of any length and equal
to the reference wherever the reference is exact. The top-k over pool positions (``stable_top_k``) and
the gather of the ids stay outside the kernel (``index/device.py``).

``pool_score`` launches the hand-written CUDA kernel
(``csrc/pool_score.cu``, ``_kernels.pool_score``) for CUDA tensors and
runs ``pool_score_plain`` for CPU tensors.
"""

from __future__ import annotations

import torch

from . import _kernels

K1 = 1.2
B = 0.75
DELTA = 1.0

#: binary-search depth of the reference's join (_POOL_BSEARCH_BITS): exact
#: for term posting ranges of fewer than 2^21 docs
BSEARCH_BITS = 21


def pool_score_plain(pool, pool_valid, term_starts, term_lens, term_idf,
                     postings_docs, postings_weights, doc_lengths, avgdl):
    """Plain PyTorch version of ``pool_score`` (same arguments, same
    result bit for bit): a loop over the terms, each a vectorised binary
    search of every pool slot at once, ``BSEARCH_BITS`` steps deep or as
    deep as the longest range needs (steps past convergence change
    nothing)."""
    f32 = torch.float32
    n_post = postings_docs.numel()
    dl = doc_lengths[pool.long()]
    dl = torch.where(dl <= 0.0, 1.0, dl)
    avgdl = torch.clamp_min(avgdl.reshape(()), 1e-9)
    norm = K1 * (1.0 - B + B * (dl / avgdl))
    scores = torch.zeros_like(norm)
    pool64 = pool.long()
    longest = int(term_lens.max()) if term_lens.numel() else 0
    steps = max(BSEARCH_BITS, longest.bit_length())
    for j in range(term_starts.shape[1]):
        s = term_starts[:, j:j + 1].long()
        n = term_lens[:, j:j + 1].long()
        idf = term_idf[:, j:j + 1]
        lo = torch.zeros_like(pool64)
        hi = n.expand_as(pool64)
        for _ in range(steps):
            mid = (lo + hi) >> 1
            v = postings_docs[torch.clamp_max(s + mid, n_post - 1)]
            lt = v < pool
            lo = torch.where(lt, mid + 1, lo)
            hi = torch.where(lt, hi, mid)
        at = torch.clamp_max(s + lo, n_post - 1)
        found = (lo < n) & (postings_docs[at] == pool) & pool_valid
        tf = torch.where(found, postings_weights[at].to(f32), 0.0)
        contrib = idf * ((tf * (K1 + 1.0)) / (tf + norm) + DELTA)
        scores = scores + torch.where(found, contrib, 0.0)
    return scores


def pool_score(pool, pool_valid, term_starts, term_lens, term_idf,
               postings_docs, postings_weights, doc_lengths, avgdl):
    """f32 scores [B, Pp] of B pools (``pool`` int32 [B, Pp] ascending,
    valid where ``pool_valid``) over their terms' full base-CSR ranges
    (``term_starts``/``term_lens`` int32, ``term_idf`` f32, [B, T]).
    CUDA tensors launch the kernel; CPU tensors take the plain version."""
    if pool.device.type == "cpu":
        return pool_score_plain(pool, pool_valid, term_starts, term_lens,
                                term_idf, postings_docs, postings_weights,
                                doc_lengths, avgdl)
    return _kernels.pool_score(pool, pool_valid, term_starts, term_lens,
                               term_idf, postings_docs, postings_weights,
                               doc_lengths, avgdl.reshape(1))
