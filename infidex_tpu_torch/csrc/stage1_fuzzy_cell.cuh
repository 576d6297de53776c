// The fuzzy groups' presence over a doc window: the arithmetic of
// csrc/stage1_fuzzy.cu, in a header of its own so that g++ builds the same
// code for the CPU tests (tests/test_torch_stage1_epilogue.py holds it to
// the plain version, index/device.py fuzzy_presence_plain).
//
// A fuzzy query token is a group of matched vocabulary terms; its
// presence row has bit d set where doc doc_lo + d carries a posting of
// any of the group's terms (the union of their posting docs, a doc in
// several of them once), and its df is the row's popcount: here the count
// of the lanes that turned a bit of the row on. Terms are rows of the
// flat lane space [0, n_lanes): term t owns lanes [cum[t], cum[t + 1]),
// lane i reads posting starts[t] + i - cum[t].
// Lanes whose doc lies outside [doc_lo, doc_hi) are dropped. Presence is
// an integer OR and df an integer count: exact in any order (exactly one
// lane finds a bit clear).

#pragma once

#include "block_steps.cuh"

namespace fuzzy {

struct Args {
  const int* starts;          // [n_terms] first posting of each term
  const int* group;           // [n_terms] owning group
  const int* cum;             // [n_terms + 1] first lane of each term
  int n_terms;
  long long n_lanes;          // cum[n_terms]
  const int* postings_docs;
  int doc_lo, doc_hi;
  unsigned* bits;             // [n_grp, words], zero on entry
  long long words;            // ceil((doc_hi - doc_lo) / 32)
  int n_grp;
  int* df;                    // [n_grp], zero on entry
};

// The term that owns lane i: the last t with cum[t] <= i (terms of no
// lanes share their cum with the next one).
GRP_HD int term_of(const Args& a, long long i) {
  int lo = 0, hi = a.n_terms;   // cum[lo] <= i < cum[hi]
  while (hi - lo > 1) {
    const int mid = (lo + hi) >> 1;
    if (a.cum[mid] <= i) lo = mid; else hi = mid;
  }
  return lo;
}

// Lane i's posting into its group's presence row: the group where this
// lane turned its bit on (the old word atomic_or returns had it clear),
// else -1 (a lane past n_lanes, a doc outside the window, a bit already
// set).
GRP_HD int mark(const Args& a, long long i) {
  if (i >= a.n_lanes) return -1;
  const int t = term_of(a, i);
  const long long p = static_cast<long long>(a.starts[t]) + (i - a.cum[t]);
  const long long local =
      static_cast<long long>(a.postings_docs[p]) - a.doc_lo;
  if (local < 0 || local >= a.doc_hi - a.doc_lo) return -1;
  const unsigned bit = 1u << (local & 31);
  const unsigned old =
      blk::atomic_or(a.bits + a.group[t] * a.words + (local >> 5), bit);
  return (old & bit) != 0u ? -1 : a.group[t];
}

// Lanes i0 .. i0 + 31 of a warp: their bits, and one df added per bit
// turned on (each doc of a group's row counted once, by whichever lane
// set its bit).
GRP_HD void mark_warp(const blk::Warp& w, const Args& a, long long i0) {
  blk::count_keys(w, a.df, [&](int l) { return mark(a, i0 + l); });
}

}  // namespace fuzzy
