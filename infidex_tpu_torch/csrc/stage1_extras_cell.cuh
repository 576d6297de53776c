// A single query's explicit fuzzy extra postings added to its score row:
// the arithmetic of csrc/stage1_extras.cu, in a header of its own so that
// g++ builds the same code for the CPU tests
// (tests/test_torch_single_search.py holds it to the plain version,
// index/device.py stage1_extras_plain).
//
// An extra posting e is (doc, idf) at tf = 1; it adds
//     scores[doc] += idf * doc_fac[doc]
// after the doc's term lanes, and a doc's extras add in their array order
// (the reference's scatter-add, serial on the CPU). The host lists the
// extras doc-major: docs[u] is the u-th distinct doc, its extras' idfs are
// idf[off[u]:off[u + 1]] in array order. One thread a distinct doc reads
// its cell once, adds its extras in that order with each f32 operation
// rounded on its own, and writes it once: no two threads share a cell, so
// there are no atomics and the result is the plain version's bit for bit.

#pragma once

#include "block_steps.cuh"

namespace extras {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

struct Args {
  float* scores;                // [width], in place
  const int* docs;              // [n_docs] distinct docs, each < width
  const int* off;               // [n_docs + 1] first extra of each doc
  const float* idf;             // [off[n_docs]] the extras' idfs, doc-major
  const float* doc_fac;         // [width] the BM25+ factor at tf = 1
  int n_docs;
};

// Distinct doc u: its extras added to its cell.
GRP_HD void add_doc(const Args& a, int u) {
  const int d = a.docs[u];
  const float fac = a.doc_fac[d];
  float s = a.scores[d];
  for (int e = a.off[u]; e < a.off[u + 1]; ++e) {
    s = blk::fadd(s, blk::fmul(a.idf[e], fac));
  }
  a.scores[d] = s;
}

// The distinct docs [b * kThreads, (b + 1) * kThreads), a thread each.
GRP_HD void block(const Args& a, long long b) {
  blk::step(kWarps, [&](const blk::Warp& g, int w) {
    blk::lanes(g, [&](int l) {
      const long long u = b * kThreads + w * 32 + l;
      if (u < a.n_docs) add_doc(a, static_cast<int>(u));
    });
  });
}

}  // namespace extras
