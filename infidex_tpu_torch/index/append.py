"""Append-only fast finalize: delta postings + O(delta) CSR merge.

Behavioral reference: Infidex's live incremental path is
accumulate-then-CalculateWeights (``SearchEngine.cs:165-185``), where
``CalculateWeights`` re-runs ``BuildInvertedLists`` over the mutable
per-term posting lists — O(corpus) per call, acceptable at C# list
speeds. This repo's finalized image is an immutable CSR + device
upload, so the same recipe measured 61s per finalize at 1M docs
(ROUND5.md §10) and capped config-5 (autocomplete under concurrent
writes) at 2.7 QPS.

TPU-native redesign: between finalizes, new documents accumulate in an
``AppendDelta`` — per touched term, a continuation of the reference's
``Term.FirstCycleAdd``/``IncrementTermUsageCounter`` state
(``Term.cs:71-122``) seeded from the base CSR's df/length. At
``calculate_weights`` the merged CSR is produced by slab-copying the
base postings around the touched terms (new doc ids are strictly
greater than every base id, so per-term postings stay doc-sorted by
construction) and recomputing champion extensions ONLY for touched
terms — O(delta + touched-terms) work plus two large memcpys, instead
of O(corpus) Python. The resulting ``BuiltIndex`` is bit-identical to
what the slow path (materialize-lists + ``finalize_postings``) builds
for the same add sequence; ``tests/test_append_finalize.py`` pins
this with a forced slow-path twin.

Stop-term transitions are handled exactly: a term whose running df
crosses ``stop_term_limit`` during the delta drops its base postings
in the merge and its weight contribution is subtracted from the
affected docs' lengths (Term.cs:118-121 semantics).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np

from .builder import BuiltIndex, _bankers_round, champion_select


class DeltaTermState:
    """Term.cs accumulation state continuing from a base-CSR term."""

    __slots__ = ("tid", "base_df", "base_len", "df", "doc_ids", "weights")

    def __init__(self, tid: int, base_df: int, base_len: int):
        self.tid = tid              # global term id (new terms pre-assigned)
        self.base_df = base_df      # df at delta start (-1 = stop term)
        self.base_len = base_len    # base posting count
        self.df = base_df           # running df (Term.IncrementTermUsageCounter)
        self.doc_ids: List[int] = []
        self.weights: List[int] = []

    def increment_usage(self, stop_term_limit: int) -> None:
        if self.df == -1:
            return
        self.df += 1
        if self.df > stop_term_limit:
            self.df = -1

    def first_cycle_add(self, doc_id: int, stop_term_limit: int,
                        remove_duplicates: bool, field_weight: float) -> None:
        if self.df < 0:
            return
        if self.base_len + len(self.weights) >= stop_term_limit:
            self.df = -1
            self.doc_ids.clear()
            self.weights.clear()
            return
        # Delta doc ids are strictly greater than every base doc id, so
        # an empty delta list can never be a same-doc continuation of
        # the base tail — the append branch is always correct there.
        if not self.doc_ids or self.doc_ids[-1] != doc_id:
            self.doc_ids.append(doc_id)
            self.weights.append(min(_bankers_round(field_weight), 255))
        elif not remove_duplicates:
            new_w = self.weights[-1] + field_weight
            if new_w <= 255:
                self.weights[-1] = _bankers_round(new_w)
                self.df -= 1

    @property
    def newly_stopped(self) -> bool:
        return self.df == -1 and self.base_df != -1


class AppendDelta:
    """Per-finalize accumulation of appended documents' postings."""

    def __init__(self, start_doc: int, base_terms: int):
        self.start_doc = start_doc      # first delta internal doc id
        self.base_terms = base_terms    # len(built.terms) at delta start
        self.states: Dict[str, DeltaTermState] = {}
        self.new_terms: List[str] = []  # first-encounter order

    def get_or_add(self, term: str, built: BuiltIndex) -> DeltaTermState:
        st = self.states.get(term)
        if st is not None:
            return st
        tid = built.term_to_id.get(term)
        if tid is None:
            tid = self.base_terms + len(self.new_terms)
            self.new_terms.append(term)
            st = DeltaTermState(tid, 0, 0)
        else:
            s = int(built.term_offsets[tid])
            e = int(built.term_offsets[tid + 1])
            st = DeltaTermState(tid, int(built.df[tid]), e - s)
        self.states[term] = st
        return st

    @property
    def n_new_terms(self) -> int:
        return len(self.new_terms)

    def drain_into_term_dict(self, term_dict) -> None:
        """Apply the accumulated delta to materialized TermPostings lists
        (slow-path fallback for flush()/segment paths). ``term_dict``
        must already hold the base postings as mutable lists and must
        NOT yet contain the delta's new terms."""
        from .builder import TermPostings

        for term in self.new_terms:
            tid, _ = term_dict.get_or_add(term)
            assert tid == self.states[term].tid
        for term, st in self.states.items():
            p: TermPostings = term_dict.postings[st.tid]
            if st.df == -1:
                p.df = -1
                if type(p.doc_ids) is not list:
                    p.doc_ids = []
                    p.weights = []
                else:
                    p.doc_ids.clear()
                    p.weights.clear()
                continue
            if type(p.doc_ids) is not list:
                p.doc_ids = list(p.doc_ids)
                p.weights = list(p.weights)
            p.doc_ids.extend(st.doc_ids)
            p.weights.extend(st.weights)
            p.df = st.df


def fast_merge_built(built: BuiltIndex, delta: AppendDelta,
                     num_docs: int) -> BuiltIndex:
    """Merged BuiltIndex from base CSR + delta, bit-identical to the
    slow path's ``finalize_postings`` over the same add sequence.

    Aliasing note: ``terms``/``term_to_id`` of the returned index share
    the live TermDictionary objects (the full path copies them, an
    O(vocab) cost per 2s finalize at 1M docs). The engine discards the
    previous BuiltIndex at finalize, and list/dict EXTENSION is the
    only mutation these objects see, so stale references (old device
    images mid-swap) never observe changed entries."""
    T_old = len(built.term_offsets) - 1
    T_new = T_old + delta.n_new_terms

    old_offsets = built.term_offsets
    old_docs = built.postings_docs
    old_weights = built.postings_weights

    lens = np.empty(T_new, np.int64)
    np.subtract(old_offsets[1:], old_offsets[:-1], out=lens[:T_old])
    lens[T_old:] = 0
    df_new = np.empty(T_new, np.int32)
    df_new[:T_old] = built.df
    df_new[T_old:] = 0

    touched: List[Tuple[int, DeltaTermState]] = sorted(
        ((st.tid, st) for st in delta.states.values()), key=lambda x: x[0])
    stopped: List[Tuple[int, DeltaTermState]] = []
    for tid, st in touched:
        if st.df == -1:
            df_new[tid] = -1
            lens[tid] = 0
            if st.newly_stopped:
                stopped.append((tid, st))
        else:
            df_new[tid] = st.df
            lens[tid] += len(st.doc_ids)

    new_offsets = np.zeros(T_new + 1, np.int64)
    np.cumsum(lens, out=new_offsets[1:])
    P_new = int(new_offsets[-1])
    docs = np.empty(P_new, np.int32)
    weights = np.empty(P_new, np.uint8)

    # Slab-copy base postings around the touched terms: untouched runs
    # share a constant shift, so each run is one memcpy.
    def copy_run(t0: int, t1: int) -> None:
        """Copy untouched terms [t0, t1) in one slab."""
        if t1 <= t0:
            return
        s0, s1 = int(old_offsets[t0]), int(old_offsets[t1])
        if s1 <= s0:
            return
        d0 = int(new_offsets[t0])
        docs[d0:d0 + (s1 - s0)] = old_docs[s0:s1]
        weights[d0:d0 + (s1 - s0)] = old_weights[s0:s1]

    prev = 0
    for tid, st in touched:
        if tid >= T_old:
            break  # new terms: no base range (touched is tid-sorted)
        copy_run(prev, tid)
        prev = tid + 1
        if st.df == -1:
            continue
        s0, s1 = int(old_offsets[tid]), int(old_offsets[tid + 1])
        d0 = int(new_offsets[tid])
        base_n = s1 - s0
        if base_n:
            docs[d0:d0 + base_n] = old_docs[s0:s1]
            weights[d0:d0 + base_n] = old_weights[s0:s1]
        k = len(st.doc_ids)
        if k:
            docs[d0 + base_n:d0 + base_n + k] = st.doc_ids
            weights[d0 + base_n:d0 + base_n + k] = st.weights
    copy_run(prev, T_old)
    for tid, st in touched:
        if tid < T_old or st.df == -1:
            continue
        d0 = int(new_offsets[tid])
        docs[d0:d0 + len(st.doc_ids)] = st.doc_ids
        weights[d0:d0 + len(st.weights)] = st.weights

    # Doc lengths: base lengths stand (their postings are unchanged)
    # except where a newly-stopped term dropped its base postings; new
    # docs accumulate their delta weights.
    old_n = built.doc_lengths.size
    doc_lengths = np.zeros(max(num_docs, 1), np.float32)
    doc_lengths[:old_n] = built.doc_lengths
    for tid, st in stopped:
        s0, s1 = int(old_offsets[tid]), int(old_offsets[tid + 1])
        np.subtract.at(doc_lengths, old_docs[s0:s1],
                       old_weights[s0:s1].astype(np.float32))
    for tid, st in touched:
        if st.df == -1 or not st.doc_ids:
            continue
        np.add.at(doc_lengths, np.asarray(st.doc_ids, np.int64),
                  np.asarray(st.weights, np.float32))
    doc_lengths = doc_lengths[:num_docs] if num_docs > 0 else doc_lengths[:0]
    avgdl = float(doc_lengths.mean()) if num_docs > 0 else 0.0

    merged = BuiltIndex(
        terms=built.terms,            # extended in place by the caller
        term_to_id=built.term_to_id,  # (see aliasing note above)
        term_offsets=new_offsets,
        postings_docs=docs,
        postings_weights=weights,
        df=df_new,
        doc_lengths=doc_lengths,
        avgdl=avgdl,
        num_docs=num_docs,
    )
    _merge_champions(built, merged, dict(touched))
    return merged


def _merge_champions(old: BuiltIndex, new: BuiltIndex,
                     touched: Dict[int, DeltaTermState]) -> None:
    """Champion extension for the merged index: untouched clipped terms
    copy their old champion block verbatim (their postings are
    unchanged); touched and newly-big terms re-select. Produces the
    same extension ``ensure_champions`` would build from scratch."""
    if old.champion_starts is None:
        return  # base never built champions; leave lazy
    cap = old.champion_len
    T_new = len(new.df)
    starts = np.full(T_new, -1, np.int64)
    if cap <= 0:
        new.champion_starts = starts
        new.ext_docs = new.postings_docs
        new.ext_weights = new.postings_weights
        return
    big = np.nonzero(new.df > cap)[0]
    ext_d: List[np.ndarray] = [new.postings_docs]
    ext_w: List[np.ndarray] = [new.postings_weights]
    pos = int(new.postings_docs.size)
    for t in big:
        t = int(t)
        s, e = int(new.term_offsets[t]), int(new.term_offsets[t + 1])
        if e - s <= cap:
            continue
        st = touched.get(t)
        had_block = t < len(old.df) and old.champion_starts[t] >= 0
        if st is None and had_block:
            o = int(old.champion_starts[t])
            ext_d.append(old.ext_docs[o:o + cap])
            ext_w.append(old.ext_weights[o:o + cap])
        elif st is not None and had_block:
            # Incremental re-selection over (old champions ∪ delta) —
            # EXACT: a posting outside the old champion set lost to
            # cap-many postings of >= weight (earlier position on ties);
            # appends only add contenders, so it can never re-enter. The
            # k_low low-id reserve is unchanged (delta ids exceed every
            # base id), and ascending-id candidate order preserves the
            # stable positional tie rule. O(cap + delta) vs O(df) per
            # touched clipped term — the dominant finalize cost for
            # high-df gram terms at 1M docs otherwise.
            o = int(old.champion_starts[t])
            cd = np.concatenate([old.ext_docs[o:o + cap],
                                 np.asarray(st.doc_ids, np.int32)])
            cw = np.concatenate([old.ext_weights[o:o + cap],
                                 np.asarray(st.weights, np.uint8)])
            part = champion_select(cw, cap)
            ext_d.append(cd[part])
            ext_w.append(cw[part])
        else:
            part = champion_select(new.postings_weights[s:e], cap)
            ext_d.append(new.postings_docs[s:e][part])
            ext_w.append(new.postings_weights[s:e][part])
        starts[t] = pos
        pos += cap
    new.champion_starts = starts
    new.champion_len = cap
    new.ext_docs = (np.concatenate(ext_d) if len(ext_d) > 1
                    else new.postings_docs)
    new.ext_weights = (np.concatenate(ext_w) if len(ext_w) > 1
                       else new.postings_weights)
