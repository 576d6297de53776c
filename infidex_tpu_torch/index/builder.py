"""Host-side index construction: term dictionary + CSR postings tensors.

Behavioral reference: Infidex ``Core/Term.cs`` / ``Core/TermCollection.cs`` /
``Indexing/VectorModel.cs:73-220``:

* Per token occurrence the term's df counter is incremented once per new
  document; repeats of the same (term, doc) accumulate the byte weight
  (``FirstCycleAdd``, Term.cs:71-122) with .NET ``Math.Round`` (banker's
  rounding) applied at every accumulation step, capped at 255 (increments
  that would exceed 255 are dropped).
* Terms whose unique-doc count exceeds ``stop_term_limit`` become stop terms:
  postings dropped, df = -1 (Term.cs:118-121).
* doc_lengths[d] = sum of posting weights for doc d; avgdl = mean
  (VectorModel.BuildInvertedLists, :130-220).

TPU-native design: instead of per-term List<int>/List<byte> served through
iterator chains, ``finalize`` lays the whole index out as flat CSR tensors
(term_offsets/doc_ids/weights) that are uploaded to HBM once and scored by
dense batched XLA programs (see index/device.py).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np


def _bankers_round(x: float) -> int:
    """C# Math.Round default: round-half-to-even (matches Python round)."""
    return int(round(x))


class TermPostings:
    """In-progress posting list for one term (mirrors Term.cs semantics)."""

    __slots__ = ("doc_ids", "weights", "df")

    def __init__(self) -> None:
        self.doc_ids: List[int] = []
        self.weights: List[int] = []
        self.df: int = 0  # -1 => stop term

    def increment_usage(self, stop_term_limit: int) -> bool:
        """Per-occurrence df counter (Term.IncrementTermUsageCounter)."""
        if self.df == -1:
            return True
        self.df += 1
        if self.df > stop_term_limit:
            self.df = -1
            return False
        return True

    def first_cycle_add(
        self, doc_id: int, stop_term_limit: int, remove_duplicates: bool, field_weight: float
    ) -> None:
        """Append/accumulate a posting (Term.FirstCycleAdd, Term.cs:71-122)."""
        if self.df < 0:
            return
        if type(self.doc_ids) is not list:
            # Loaded snapshots back postings with CSR array views; convert
            # to mutable lists on first write (copy-on-write).
            self.doc_ids = self.doc_ids.tolist()
            self.weights = self.weights.tolist()
        if len(self.weights) >= stop_term_limit:
            self.df = -1
            self.doc_ids.clear()
            self.weights.clear()
            return
        if not self.doc_ids or self.doc_ids[-1] != doc_id:
            w = min(_bankers_round(field_weight), 255)
            self.doc_ids.append(doc_id)
            self.weights.append(w)
        elif not remove_duplicates:
            new_w = self.weights[-1] + field_weight
            if new_w <= 255:
                self.weights[-1] = _bankers_round(new_w)
                self.df -= 1
        # else: duplicate occurrence with remove_duplicates=True is ignored
        # (and df keeps the per-occurrence increment, mirroring Term.cs).


class TermDictionary:
    """String term -> dense id mapping with posting accumulation."""

    def __init__(self) -> None:
        self.term_to_id: Dict[str, int] = {}
        self.terms: List[str] = []
        self.postings: List[TermPostings] = []

    def __len__(self) -> int:
        return len(self.terms)

    def get_id(self, term: str) -> int:
        return self.term_to_id.get(term, -1)

    def get_or_add(self, term: str) -> Tuple[int, bool]:
        tid = self.term_to_id.get(term)
        if tid is not None:
            return tid, False
        tid = len(self.terms)
        self.term_to_id[term] = tid
        self.terms.append(term)
        self.postings.append(TermPostings())
        return tid, True

    def df(self, term_id: int) -> int:
        return self.postings[term_id].df

    def load_csr_image(self, terms, dfs, offsets, docs, weights) -> None:
        """Bulk-restore from a snapshot's CSR image: postings become array
        views over the shared buffers (no per-term materialization; the
        write path converts a term to lists on first append)."""
        base = len(self.terms)
        self.terms.extend(terms)
        t2i = self.term_to_id
        postings = self.postings
        for i, term in enumerate(terms):
            t2i[term] = base + i
        append = postings.append
        for i in range(len(terms)):
            p = TermPostings()
            p.df = dfs[i]
            s, e = offsets[i], offsets[i + 1]
            p.doc_ids = docs[s:e]
            p.weights = weights[s:e]
            append(p)


#: device-lane champion cap per term: high-df terms ship only their top
#: CAP postings by weight to the dense device kernels (impact-ordered
#: truncation; the exact host paths — tier pools, oracle joins — always
#: read the full CSR). 0 disables clipping. Measured on the 1M-doc fuzzy
#: workload (cap sweep 32768/8192/4096/2048/1024): 2048 wins BOTH axes -
#: 138.7 vs 92.8 QPS and recall@10 0.7375 vs 0.6875 against 32768;
#: recall plateaus at 4096 and QPS at 2048. Smaller champion lists concentrate
#: Stage-1's coverage-depth budget on the docs that actually carry
#: weight for the query's rare terms.
import itertools as _itertools
import os as _os

DEVICE_TERM_CAP = int(_os.environ.get("INFIDEX_TPU_DEVICE_TERM_CAP",
                                      "2048"))

_BUILD_GEN = _itertools.count(1)


@dataclass
class BuiltIndex:
    """Immutable flat CSR image of the inverted index (host numpy)."""

    terms: List[str]
    term_to_id: Dict[str, int]
    term_offsets: np.ndarray      # int64 [T+1]
    postings_docs: np.ndarray     # int32 [P]
    postings_weights: np.ndarray  # uint8 [P]
    df: np.ndarray                # int32 [T]  (-1 => stop term)
    doc_lengths: np.ndarray       # float32 [N]
    avgdl: float
    num_docs: int
    # Champion extension (built lazily by ensure_champions): for terms
    # with df > DEVICE_TERM_CAP, the top-CAP postings by weight (doc-id
    # sorted) appended after the base CSR in ext_docs/ext_weights;
    # champion_starts[t] = offset into the EXTENDED buffer, -1 = use the
    # full base range. The device uploads base+extension as one buffer.
    champion_starts: Optional[np.ndarray] = None   # int64 [T]
    champion_len: int = 0
    ext_docs: Optional[np.ndarray] = None
    ext_weights: Optional[np.ndarray] = None
    # Monotone build token: keys the native champion-list memo
    # (native/_lib.cpp champions_cached) — a new BuiltIndex gets a new
    # generation, so memoized champion lists can never leak across
    # finalizes (same contract as WordMatcher's per-finalize memos).
    gen: int = field(default_factory=lambda: next(_BUILD_GEN))

    def postings_for(self, term_id: int) -> Tuple[np.ndarray, np.ndarray]:
        s, e = self.term_offsets[term_id], self.term_offsets[term_id + 1]
        return self.postings_docs[s:e], self.postings_weights[s:e]

    def get_id(self, term: str) -> int:
        return self.term_to_id.get(term, -1)

    def ensure_champions(self, cap: int = 0) -> None:
        """Build the per-term weight-champion extension (one-time).

        The TPU analogue of impact-ordered index truncation: a term with
        df far beyond the candidate budget contributes its best-tf docs;
        the dense kernels then expand bounded lanes for every term.
        Exactness note: docs outside a clipped term's champions lose that
        term's Stage-1 contribution only — coverage reranking and the
        other query terms still see them; bench recall@10 quantifies it.
        """
        if self.champion_starts is not None:
            return
        cap = cap or DEVICE_TERM_CAP
        starts = np.full(len(self.terms), -1, dtype=np.int64)
        if cap <= 0:
            self.champion_starts = starts
            self.ext_docs = self.postings_docs
            self.ext_weights = self.postings_weights
            return
        ext_d: List[np.ndarray] = [self.postings_docs]
        ext_w: List[np.ndarray] = [self.postings_weights]
        pos = int(self.postings_docs.size)
        big = np.nonzero(self.df > cap)[0]
        for t in big:
            s, e = int(self.term_offsets[t]), int(self.term_offsets[t + 1])
            if e - s <= cap:
                continue
            part = champion_select(self.postings_weights[s:e], cap)
            ext_d.append(self.postings_docs[s:e][part])
            ext_w.append(self.postings_weights[s:e][part])
            starts[t] = pos
            pos += cap
        self.champion_starts = starts
        self.champion_len = cap
        self.ext_docs = (np.concatenate(ext_d) if len(ext_d) > 1
                         else self.postings_docs)
        self.ext_weights = (np.concatenate(ext_w) if len(ext_w) > 1
                            else self.postings_weights)


def champion_select(w: np.ndarray, cap: int) -> np.ndarray:
    """Champion-posting positions for one clipped term, id-ascending.

    Reserve the term's LIM_K lowest doc ids (postings are id-ascending),
    then fill with top-by-weight from the rest, ties toward lower doc id
    (stable sort on descending weight keeps ascending-doc order within a
    weight). The low-id reservation makes the low-id-matcher rows exact
    per term even under clipping: fusion resolves quality-tie classes by
    ascending key, and the class winners of a clipped term were exactly
    the lanes weight-champions dropped. Shared by ``ensure_champions``
    and the append-finalize champion merge (index/append.py) so both
    produce identical extensions."""
    from .device import LIM_K

    k_low = min(LIM_K, cap // 2)
    rest = k_low + np.argsort(
        -w[k_low:].astype(np.int16), kind="stable")[: cap - k_low]
    part = np.concatenate([np.arange(k_low), rest])
    part.sort()
    return part


def finalize_postings(term_dict: TermDictionary, num_docs: int) -> BuiltIndex:
    """Flatten accumulated postings to CSR and compute doc lengths/avgdl."""
    T = len(term_dict)
    lens = np.zeros(T, dtype=np.int64)
    dfs = np.zeros(T, dtype=np.int32)
    for t in range(T):
        p = term_dict.postings[t]
        dfs[t] = p.df
        if p.df > 0:
            lens[t] = len(p.doc_ids)
    offsets = np.zeros(T + 1, dtype=np.int64)
    np.cumsum(lens, out=offsets[1:])
    P = int(offsets[-1])

    docs = np.zeros(P, dtype=np.int32)
    weights = np.zeros(P, dtype=np.uint8)
    for t in range(T):
        p = term_dict.postings[t]
        if p.df > 0 and len(p.doc_ids):
            s = offsets[t]
            docs[s : s + len(p.doc_ids)] = p.doc_ids
            weights[s : s + len(p.weights)] = p.weights

    doc_lengths = np.zeros(max(num_docs, 1), dtype=np.float32)
    np.add.at(doc_lengths, docs[:P], weights[:P].astype(np.float32))
    doc_lengths = doc_lengths[:num_docs] if num_docs > 0 else doc_lengths[:0]
    avgdl = float(doc_lengths.mean()) if num_docs > 0 else 0.0

    return BuiltIndex(
        terms=list(term_dict.terms),
        term_to_id=dict(term_dict.term_to_id),
        term_offsets=offsets,
        postings_docs=docs,
        postings_weights=weights,
        df=dfs,
        doc_lengths=doc_lengths,
        avgdl=avgdl,
        num_docs=num_docs,
    )
