// The fuzzy groups' presence over a doc window: the arithmetic of
// csrc/stage1_fuzzy.cu, in a header of its own so that g++ builds the same
// code for the CPU tests (tests/test_torch_stage1_epilogue.py holds it to
// the plain version, index/device.py fuzzy_presence_plain).
//
// A fuzzy query token is a group of matched vocabulary terms; its
// presence row has bit d set where doc doc_lo + d carries a posting of
// any of the group's terms (the union of their posting docs, a doc in
// several of them once), and its df is the row's popcount. Terms are
// rows of the flat lane space [0, n_lanes): term t owns lanes
// [cum[t], cum[t + 1]), lane i reads posting starts[t] + i - cum[t].
// Lanes whose doc lies outside [doc_lo, doc_hi) are dropped. Presence is
// an integer OR and df an integer count: exact in any order.

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
  int* df;                    // [n_grp]
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

// Lane i's posting into its group's presence row.
GRP_HD void mark(const Args& a, long long i) {
  const int t = term_of(a, i);
  const long long p = static_cast<long long>(a.starts[t]) + (i - a.cum[t]);
  const long long local =
      static_cast<long long>(a.postings_docs[p]) - a.doc_lo;
  if (local < 0 || local >= a.doc_hi - a.doc_lo) return;
  blk::atomic_or(a.bits + a.group[t] * a.words + (local >> 5),
                 1u << (local & 31));
}

constexpr int kDfThreads = 256;
constexpr int kDfWarps = kDfThreads / 32;

struct DfShared {
  int part[kDfWarps];
};

// Group g's df: the popcount of its row (a block of kDfThreads).
GRP_HD void row_df(const Args& a, int g, DfShared* sh) {
  const unsigned* row = a.bits + g * a.words;
  blk::step(kDfWarps, [&](const blk::Warp& w, int wi) {
    const int s = blk::sum_int(w, [&](int l) {
      int n = 0;
      for (long long i = wi * 32 + l; i < a.words; i += kDfThreads) {
        n += blk::popc(row[i]);
      }
      return n;
    });
    if (grp::leader(w)) sh->part[wi] = s;
  });
  blk::step(kDfWarps, [&](const blk::Warp& w, int wi) {
    if (wi != 0 || !grp::leader(w)) return;
    int n = 0;
    for (int v = 0; v < kDfWarps; ++v) n += sh->part[v];
    a.df[g] = n;
  });
}

}  // namespace fuzzy
