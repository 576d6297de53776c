// One candidate of the device fake-LCS: the arithmetic of
// csrc/coverage_lcs.cu, in a header of its own so that a host compiler can
// build the same code (the CPU tests compile it with g++ and hold it
// against the plain PyTorch version, ops/coverage_kernel.py
// coverage_lcs_plain, and the host LCS, utils/metrics.py lcs; the CUDA
// kernel includes it unchanged).
//
// StringMetrics.cs:12-36 over the full normalized text r and query q, in
// utf-16 code units: |q| when q is contained in r, else
// min(prefix + tol, min(|q|, |r|)) when they share a prefix of `prefix`
// chars, else 0; 0 when either is empty. The plain version tests every
// offset of the text row for containment; here the offsets are walked in
// order and the walk stops at the first hit, and each offset's compare
// stops at its first mismatch. Integer work only: exact.

#pragma once

#if defined(__CUDACC__)
#define LCS_HD __host__ __device__ __forceinline__
#else
#define LCS_HD inline
#endif

namespace lcs {

LCS_HD int imin(int a, int b) { return a < b ? a : b; }

// txt: the doc's row of t_cap code units (zeros past its text), q: the
// query's row of qt_cap; qtl and text_len the two lengths, tol the query's
// error tolerance. The plain version compares the query's first
// min(qtl, qt_cap) chars and reads zeros past the row's end; so does this.
LCS_HD int device_lcs(const int* txt, int t_cap, const int* q, int qt_cap,
                      int qtl, int text_len, int tol) {
  if (!(qtl > 0 && text_len > 0)) return 0;
  const int nq = imin(qtl, qt_cap);
  // containment at offsets o with o + qtl <= text_len, o < t_cap
  const int o_end = imin(t_cap, text_len - qtl + 1);
  for (int o = 0; o < o_end; ++o) {
    int i = 0;
    while (i < nq && (o + i < t_cap ? txt[o + i] : 0) == q[i]) ++i;
    if (i == nq) return qtl;
  }
  // common prefix over the first min(qtl, text_len) chars (at most qt_cap
  // are compared)
  const int lim = imin(qtl, text_len);
  const int n = imin(qt_cap, lim);
  int prefix = lim;
  for (int i = 0; i < n; ++i) {
    if (q[i] != (i < t_cap ? txt[i] : 0)) {
      prefix = i;
      break;
    }
  }
  return prefix > 0 ? imin(prefix + tol, lim) : 0;
}

// Candidate c of a block: its doc is text_ids[c], its query qsel[c]. The
// fake-LCS where both are eligible, else the host value lcs_in[c].
LCS_HD float candidate(const int* text_chars, const unsigned char* lcs_ok,
                       const int* q_text, const int* q_text_len,
                       const int* q_tol, const unsigned char* q_ok,
                       const long long* text_ids, const long long* qsel,
                       const int* text_len, const float* lcs_in, int t_cap,
                       int qt_cap, int c) {
  const long long doc = text_ids[c];
  const long long b = qsel[c];
  if (!(lcs_ok[doc] && q_ok[b])) return lcs_in[c];
  return static_cast<float>(device_lcs(
      text_chars + doc * t_cap, t_cap, q_text + b * qt_cap, qt_cap,
      q_text_len[b],
      text_len[c], q_tol[b]));
}

}  // namespace lcs
