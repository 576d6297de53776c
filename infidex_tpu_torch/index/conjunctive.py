"""Token-conjunctive candidate tier for multi-word queries.

Stage-1's disjunctive BM25 top-``coverage_depth`` under-serves multi-word
queries: a document that matches EVERY query word — one of them only
partially (a prefix, an LD1 typo, or a handful of n-grams) — is exactly
what the coverage/fusion rerank ranks highest (coverage_tier 3,
``scoring/fusion.py``), yet its *disjunctive* gram score often sits at
Stage-1 rank 500–20000, behind thousands of documents that match a single
common word perfectly.  The reference engine hides this class less often
only because its Stage-1 is exact over all matched docs
(``Scoring/SearchPipeline.cs`` CoverageDepth truncation); at TPU batch
sizes we instead *generate* the class directly:

  pool(query) = union over pivot tokens of
      { docs with STRONG evidence for the pivot token }
      filtered so that every OTHER token has ANY gram evidence

  - strong evidence  = the token's WordMatcher lists (exact, LD1/FastSS,
    prefix/suffix affix — ``index/word_matcher.py``), its fuzzy-expansion
    matches for unknown tokens (``VectorModel.expand_missing_term_ids``),
    and the postings of its *rare* grams (df ≤ num_docs/64) clipped to
    weight champions.
  - any gram evidence = membership in ≥1 posting list of any gram of the
    token (full host CSR — unlike the device kernels this sees past the
    per-term champion clipping, which is what buries these docs).

The pool is ranked by exact BM25+ over the query's known terms
(``candidates.score_pool`` — device-identical math) and clipped to
``CONJ_CAP``; the pipeline feeds it into the candidate-prior chain
(``SearchPipeline._assemble_prior``) after the exact-words class prior
and ahead of the WordMatcher heads' unused-budget fill.  Ranking is
deterministic (score desc, id asc) so deeper (oracle) candidate sets
nest production ones at every coverage depth.

Everything here is host numpy on sorted arrays; at batch time it runs on
the WordMatcher prefetch pool and overlaps the Stage-1 device round trip.
"""

from __future__ import annotations

import os
from typing import List, Optional, Sequence, Tuple

import numpy as np

from .. import tracing
from .candidates import score_pool

#: ranked-pool cap (constant across coverage depths: oracle nesting).
CONJ_CAP = int(os.environ.get("INFIDEX_TPU_CONJ_CAP", "2048"))
#: per-pivot anchor union cap — bounds probe cost on common-word pivots.
ANCHOR_CLIP = int(os.environ.get("INFIDEX_TPU_CONJ_ANCHOR_CLIP", "16384"))
#: a gram is "rare" (anchor-grade evidence) below num_docs // RARE_DIV.
RARE_DIV = 64
#: per-rare-gram champion clip (top postings by weight).
GRAM_CHAMPIONS = 4096
#: token lengths [min_length_one_typo, FPREFIX_MAX] gain a fuzzy-prefix
#: evidence class (WordMatcher.fuzzy_prefix_parts): short tokens' grams
#: cannot see interior doc words whose prefix is one edit away (the
#: boundary gram exists only doc-initially), yet the coverage cascade
#: credits exactly those matches — ROUND5.md §7 mechanism 2. 0 disables.
FPREFIX_MAX = int(os.environ.get("INFIDEX_TPU_CONJ_FPREFIX_MAX", "4"))
FPREFIX_MIN = 3   # coverage's min_length_one_typo: shorter gets no typo


class ConjPool(np.ndarray):
    """Ranked conjunctive pool ids with one extra fact: the length of
    the LEADING (strong desc, tok_n asc) class — fusion's top tie class.

    The pipeline's flat ``CONJ_TAKE`` slice cuts mid-class when that
    class is large (measured at 1M: oracle top-10 docs at pool ranks
    618-795 inside an ~800-doc top class, 'viussador dor' losses in
    scripts/loss_diag.py) — the class members are indistinguishable to
    the pool's own (BM25, id) tiebreak, so any flat cut samples the
    wrong ones. ``first_class`` lets the slice extend through the whole
    top class instead. Plain numpy views/slices drop the attribute —
    read it before filtering."""

    first_class: int = 0


def _as_pool(a: np.ndarray, first_class: int = 0) -> "ConjPool":
    p = np.ascontiguousarray(a, np.int64).view(ConjPool)
    p.first_class = int(first_class)
    return p


def _first_class_len(model, built, word_groups, pool: np.ndarray) -> int:
    """Length of the pool's leading (strong, tok_n) class, recomputed
    with the same evidence the ranking used (anchor-union membership per
    token + coverage tok_count). Returns 0 when the evidence memo has
    been evicted (overflow) — callers then skip the extension."""
    if pool.size == 0:
        return 0
    cache = getattr(model, "_conj_token_evidence", None)
    if cache is None or cache[0] is not built:
        return 0
    memo = cache[1]
    infos = [memo.get(w) for w, _ in word_groups]
    if any(inf is None for inf in infos):
        return 0
    from ..native import member_any_into

    strong = np.zeros(pool.size, np.int32)
    p64 = np.ascontiguousarray(pool, np.int64)
    # member_any_into's two-pointer merge requires SORTED candidates;
    # the pool arrives in ranked order — probe sorted, scatter back.
    order = np.argsort(p64, kind="stable")
    sorted_p = np.ascontiguousarray(p64[order])
    for inf in infos:
        if inf.anchor_union.size == 0:
            continue
        hit = np.zeros(pool.size, np.uint8)
        member_any_into(inf.anchor_union, sorted_p, hit)
        strong[order] += hit
    tables = getattr(model, "coverage_tables", None)
    if tables is not None and tables.tok_count_host is not None:
        tok_n = tables.tok_count_host[np.minimum(
            p64, tables.tok_count_host.size - 1)].astype(np.int32)
    else:
        tok_n = np.zeros(pool.size, np.int32)
    run = (strong == strong[0]) & (tok_n == tok_n[0])
    stop = np.flatnonzero(~run)
    return int(stop[0]) if stop.size else int(pool.size)


def _champions(built, tid: int, cap: int) -> np.ndarray:
    """The term's ``cap`` best postings by byte-quantized tf, doc-id
    ascending (same deterministic weight-desc/doc-asc rule as
    TieredCandidateSelector._champions)."""
    from .candidates import top_weight_idx

    s = int(built.term_offsets[tid])
    e = int(built.term_offsets[tid + 1])
    docs = built.postings_docs[s:e]
    if docs.size <= cap:
        return docs
    w = built.postings_weights[s:e]
    return docs[top_weight_idx(w, cap)]


class _TokenEvidence:
    __slots__ = ("anchors", "gram_tids", "anchor_union",
                 "ev_bits", "an_bits")

    def __init__(self, anchors: List[np.ndarray], gram_tids: List[int]):
        self.anchors = anchors
        self.gram_tids = gram_tids
        # ONE sorted union per token, computed once: every pivot (and the
        # strong-count ranking below) probes the same evidence — merging
        # up front replaces len(anchors) probes per use with one.
        self.anchor_union = (
            np.unique(np.concatenate(
                [np.asarray(a, np.int32) for a in anchors]))
            if anchors else np.zeros(0, np.int32))
        self.ev_bits = None   # packed evidence bitset (anchors | grams)
        self.an_bits = None   # packed anchors-only bitset

    def ensure_bits(self, built) -> None:
        """Packed per-doc membership bitsets (little bitorder; bit d =
        doc d carries this token's evidence). Built once per WORD per
        index image — one pass over the same postings the per-query
        galloping probes used to walk per (pivot, other) pair — then
        every query reusing the word filters in O(n_cand) byte gathers
        (the native ``infidex_conj_pool`` twin)."""
        if self.ev_bits is not None:
            return
        b = np.zeros(built.num_docs, bool)
        b[self.anchor_union] = True
        self.an_bits = np.packbits(b, bitorder="little")
        for tid in self.gram_tids:
            b[built.postings_for(int(tid))[0]] = True
        self.ev_bits = np.packbits(b, bitorder="little")


def _token_evidence(model, word: str,
                    wm_parts: Sequence[np.ndarray]) -> _TokenEvidence:
    built = model.built
    gram_tids: List[int] = []
    for t in set(model.tokenizer.tokenize_for_search(word)):
        tid = built.term_to_id.get(t, -1)
        if tid >= 0 and built.df[tid] > 0:
            gram_tids.append(tid)
    anchors = [np.asarray(p) for p in wm_parts if len(p)]
    wid = built.term_to_id.get(word, -1)
    if (wid < 0 or built.df[wid] <= 0) and len(word) >= 4:
        for tid in np.asarray(
                model.expand_missing_term_ids(word)).tolist():
            anchors.append(built.postings_for(int(tid))[0])
            gram_tids.append(int(tid))
    wm = getattr(model, "_wm_ref", None)
    if wm is not None and FPREFIX_MIN <= len(word) <= FPREFIX_MAX:
        anchors.extend(wm.fuzzy_prefix_parts(word))
    rare_cap = min(8192, max(64, built.num_docs // RARE_DIV))
    for tid in gram_tids:
        if 0 < built.df[tid] <= rare_cap:
            anchors.append(_champions(built, tid, GRAM_CHAMPIONS))
    return _TokenEvidence(anchors, gram_tids)


def conjunctive_pool(model, word_groups: Sequence[Tuple[str, Sequence[np.ndarray]]],
                     prep: Optional[tuple]) -> np.ndarray:
    """Ranked conjunctive candidates (internal doc ids, int64).

    ``word_groups``: per query token, ``(word, wordmatcher_parts)`` as
    produced by ``WordMatcher.lookup_parts_grouped``.  ``prep`` is the
    query's ``VectorModel.prepare_stage1`` tuple (known term ids + idfs)
    used for exact BM25 ranking of the pool; fuzzy-group contributions
    are intentionally omitted (the pool exists to surface candidates —
    the coverage/fusion rerank does the real ordering).

    The finished pool is memoized per (query words, scoring term ids),
    keyed to the built-index identity like the token-evidence memo
    below: the pool is a pure function of the build, query words repeat
    Zipf-style across a serving stream, and the native probe/rank pass
    costs ~1.8ms per multi-word query at 1M docs
    (scripts/begin_profile.py) — the single largest begin-path item.
    Entries are treated as immutable by every caller (_assemble_prior
    slices/filters into fresh arrays). Bounded: CONJ_CAP int64 ids per
    entry, 4096 entries (~64MB worst case), wholesale clear on overflow
    or rebuild.
    """
    built = model.built
    if built is None or len(word_groups) < 2:
        return np.zeros(0, np.int64)

    pool_key = (tuple(w for w, _ in word_groups),
                tuple(int(t) for t in np.asarray(prep[0]).tolist())
                if prep is not None else None)
    pcache = getattr(model, "_conj_pool_memo", None)
    if pcache is None or pcache[0] is not built:
        pcache = (built, {})
        model._conj_pool_memo = pcache
    hit = pcache[1].get(pool_key)
    if hit is not None:
        tracing.count("conj_memo.hit")
        return hit
    tracing.count("conj_memo.miss")
    pool = _conjunctive_pool_impl(model, built, word_groups, prep)
    pool = _as_pool(pool, _first_class_len(model, built, word_groups, pool))
    if len(pcache[1]) >= 4096:
        tracing.count("conj_memo.clear")
        pcache[1].clear()
    pcache[1][pool_key] = pool
    return pool


def _conjunctive_pool_impl(model, built, word_groups, prep) -> np.ndarray:

    # Per-word evidence memo, keyed to the built-index identity (a
    # rebuild invalidates it wholesale). Query words repeat Zipf-style
    # across a serving stream and _token_evidence's anchor-union merge
    # is ~40% of the pool cost (scripts/host_hot_profile.py).
    cache = getattr(model, "_conj_token_evidence", None)
    if cache is None or cache[0] is not built:
        cache = (built, {})
        model._conj_token_evidence = cache
    memo = cache[1]
    infos = []
    hits = 0
    for w, parts in word_groups:
        inf = memo.get(w)
        if inf is None:
            inf = _token_evidence(model, w, parts)
            # memo cap: bitset entries cost ~2 * num_docs/8 bytes each
            # (ensure_bits), so bound the memo's worst case at ~512MB.
            cap = max(512, min(8192, (1 << 31) // max(built.num_docs, 1)))
            if len(memo) >= cap:
                tracing.count("evidence_memo.clear")
                memo.clear()
            memo[w] = inf
        else:
            hits += 1
        infos.append(inf)
    tracing.count("evidence_memo.hit", hits)
    tracing.count("evidence_memo.miss", len(word_groups) - hits)
    evidenced = [inf for inf in infos if inf.gram_tids or inf.anchors]
    if len(evidenced) < 2:
        return np.zeros(0, np.int64)

    from .. import native

    if native.available and not os.environ.get("INFIDEX_TPU_CONJ_PY"):
        # One native call replaces the whole probe/rank loop below
        # (~45% of the per-query host budget at 1M —
        # scripts/host_hot_profile.py); byte-identical output pinned by
        # tests/test_conjunctive.py::test_native_pool_parity.
        if prep is not None:
            score_tids = [int(t) for t in np.asarray(prep[0]).tolist()]
            score_idfs = [float(i) for i in np.asarray(prep[1]).tolist()]
        else:
            score_tids, score_idfs = [], []
        tables = getattr(model, "coverage_tables", None)
        tok_count = (tables.tok_count_host if tables is not None
                     and tables.tok_count_host is not None else None)
        for inf in infos:
            inf.ensure_bits(built)
        return native.conj_pool_native(
            built, [inf.anchor_union for inf in infos],
            np.stack([inf.ev_bits for inf in infos]),
            np.stack([inf.an_bits for inf in infos]),
            np.array([1 if (inf.gram_tids or inf.anchors) else 0
                      for inf in infos], np.uint8),
            score_tids, score_idfs, tok_count, ANCHOR_CLIP, CONJ_CAP)

    from ..native import member_any_into

    pools: List[np.ndarray] = []
    for pi, inf in enumerate(infos):
        if not inf.anchors:
            continue
        cand = inf.anchor_union[:ANCHOR_CLIP].astype(np.int64)
        for oi, other in enumerate(infos):
            if oi == pi or not (other.gram_tids or other.anchors):
                continue
            if cand.size == 0:
                break
            found = np.zeros(cand.size, np.uint8)
            # strong (WordMatcher/LD1) union first: the coverage fuzzy
            # matcher credits LD1 tokens that share NO boundary gram with
            # the query token ('ran' -> 'han'), so gram probes alone
            # reject exactly the class fusion ranks highest.
            member_any_into(other.anchor_union, cand, found)
            # most-common gram first: each probe costs the same, the
            # biggest df covers the most candidates -> earliest exit;
            # member_any_into skips already-found candidates so the
            # probe work shrinks with every list.
            if not found.all():
                for tid in sorted(other.gram_tids,
                                  key=lambda t: -int(built.df[t])):
                    p = built.postings_for(tid)[0]
                    member_any_into(p, cand, found)
                    if found.all():
                        break
            cand = cand[found.view(bool)]
        if cand.size:
            pools.append(cand)
    if not pools:
        return np.zeros(0, np.int64)
    pool = np.unique(np.concatenate(pools)) if len(pools) > 1 else pools[0]

    if prep is None:
        return pool[:CONJ_CAP]
    # Fusion-aligned pool ranking. BM25-gram order alone buried the
    # winners (measured at 1M: oracle top-10 docs at pool rank 777-2537):
    # fusion's tie classes prefer docs where MORE tokens match strongly
    # and SHORTER docs, so rank by (strong-evidence token count desc,
    # doc token count asc, BM25 desc, id asc).
    strong = np.zeros(pool.size, np.int32)
    for inf in infos:
        hit = np.zeros(pool.size, np.uint8)
        member_any_into(inf.anchor_union, pool, hit)
        strong += hit
    tables = getattr(model, "coverage_tables", None)
    if tables is not None and tables.tok_count_host is not None:
        tok_n = tables.tok_count_host[np.minimum(
            pool, tables.tok_count_host.size - 1)].astype(np.int32)
    else:
        tok_n = np.zeros(pool.size, np.int32)
    term_ids = [int(t) for t in np.asarray(prep[0]).tolist()]
    idfs = [float(i) for i in np.asarray(prep[1]).tolist()]
    scores = score_pool(built, term_ids, idfs, pool)
    order = np.lexsort((pool, -scores, tok_n, -strong))
    return pool[order][:CONJ_CAP].astype(np.int64)
