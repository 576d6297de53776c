// One candidate of the device fake-LCS, worked by a group of lanes: the
// arithmetic of csrc/coverage_lcs.cu, in a header of its own so that a host
// compiler can build the same code (the CPU tests compile it with g++ and
// hold it against the plain PyTorch version, ops/coverage_kernel.py
// coverage_lcs_plain, and the host LCS, utils/metrics.py lcs; the CUDA
// kernel includes it unchanged). The group's collectives are those of
// csrc/lane_group.cuh: warp intrinsics on the card, a loop over the lanes
// on the host.
//
// StringMetrics.cs:12-36 over the full normalized text r and query q, in
// utf-16 code units: |q| when q is contained in r, else
// min(prefix + tol, min(|q|, |r|)) when they share a prefix of `prefix`
// chars, else 0; 0 when either is empty. The plain version tests every
// offset of the text row for containment; here the group copies the two
// rows as far as the compares reach into its scratch, then lane l tests
// the offsets l, l + G, ... a round at a time (each compare stops at its
// first mismatch) and a ballot says whether any offset of the round hits:
// the result is |q| for any hit, so which one hits first does not matter.
// The common prefix is the first mismatch of a ballot over the first chars.
// Integer work only: exact.

#pragma once

#include "lane_group.cuh"

#if defined(__CUDACC__)
#define LCS_HD __host__ __device__ __forceinline__
#else
#define LCS_HD inline
#endif

namespace lcs {

LCS_HD int imin(int a, int b) { return a < b ? a : b; }
LCS_HD int imax(int a, int b) { return a > b ? a : b; }

// Ints of a group's scratch: the text row's first t_cap + qt_cap units
// (zeros past t_cap), then the query row's qt_cap.
LCS_HD int scratch_ints(int t_cap, int qt_cap) { return t_cap + 2 * qt_cap; }

// txt: the doc's row of t_cap code units (zeros past its text), q: the
// query's row of qt_cap; qtl and text_len the two lengths, tol the query's
// error tolerance. The plain version compares the query's first
// min(qtl, qt_cap) chars and reads zeros past the row's end; so does this.
template <int G>
LCS_HD int device_lcs(const grp::Group<G>& g, int* scratch, const int* txt,
                      int t_cap, const int* q, int qt_cap, int qtl,
                      int text_len, int tol) {
  if (!(qtl > 0 && text_len > 0)) return 0;
  const int nq = imin(qtl, qt_cap);
  // containment at offsets o with o + qtl <= text_len, o < t_cap
  const int o_end = imin(t_cap, text_len - qtl + 1);
  // the common prefix over the first min(qtl, text_len) chars (at most
  // qt_cap are compared)
  const int lim = imin(qtl, text_len);
  const int n = imin(qt_cap, lim);
  // the text units the compares reach
  const int reach = imax(o_end > 0 ? o_end - 1 + nq : 0, n);
  int* s_txt = scratch;
  int* s_q = scratch + t_cap + qt_cap;
  grp::each(g, reach, [&](int j) { s_txt[j] = j < t_cap ? txt[j] : 0; });
  grp::each(g, nq, [&](int i) { s_q[i] = q[i]; });
  grp::sync(g);
  const bool contained = grp::any(g, o_end, [&](int o) {
    int i = 0;
    while (i < nq && s_txt[o + i] == s_q[i]) ++i;
    return i == nq;
  });
  if (contained) return qtl;
  const int m = grp::first(g, 0, n, [&](int i) { return s_q[i] != s_txt[i]; });
  const int prefix = m < n ? m : lim;
  return prefix > 0 ? imin(prefix + tol, lim) : 0;
}

// Candidate c of a block: its doc is text_ids[c], its query qsel[c]. The
// fake-LCS where both are eligible, else the host value lcs_in[c]; every
// lane of the group returns it. `scratch` holds scratch_ints(t_cap, qt_cap)
// ints of the group's own.
template <int G>
LCS_HD float candidate(const grp::Group<G>& g, int* scratch,
                       const int* text_chars, const unsigned char* lcs_ok,
                       const int* q_text, const int* q_text_len,
                       const int* q_tol, const unsigned char* q_ok,
                       const long long* text_ids, const long long* qsel,
                       const int* text_len, const float* lcs_in, int t_cap,
                       int qt_cap, int c) {
  const long long doc = text_ids[c];
  const long long b = qsel[c];
  if (!(lcs_ok[doc] && q_ok[b])) return lcs_in[c];
  return static_cast<float>(device_lcs(
      g, scratch, text_chars + doc * t_cap, t_cap, q_text + b * qt_cap,
      qt_cap, q_text_len[b], text_len[c], q_tol[b]));
}

}  // namespace lcs
