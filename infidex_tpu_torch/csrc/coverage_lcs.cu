// The device fake-LCS of the coverage program in one launch, for Hopper
// (sm_90a).
//
// Replaces the jitted program's device fake-LCS,
// infidex_tpu/ops/coverage_kernel.py:1038-1077 (a blocked scan over every
// offset of the [T, C] text rows gathered per candidate): in the eager
// PyTorch version (ops/coverage_kernel.py coverage_lcs_plain) about 560
// launches per block of candidates, three per text offset, each over a
// [QT, C] tensor.
//
// What it computes. For every candidate c < C, whose doc is text_ids[c]
// and whose query is qsel[c] (both int64): where both are eligible
// (lcs_ok[doc] and q_ok[query]), the fake-LCS of coverage_lcs_cell.cuh
// between the doc's
// row of text_chars (int32 [N, T], utf-16 code units) and the query's row
// of q_text (int32 [B, QT]), as a float; elsewhere the host value
// lcs_in[c]. Exact (integers until the last cast).
//
// Design. One thread per candidate, reading its doc's row and its query's
// row in place (no gather); the offsets are walked in order and the walk
// stops at the first hit, each offset's compare at its first mismatch, so
// a thread's work follows its own text and query lengths. Ineligible
// candidates read nothing but their flags.
//
// What bounds it. Bytes (the text and query chars the compares need, and
// the ids), far below either bound in practice: latency of the dependent
// reads of a thread's row, which L1 holds after the first.

#include <cuda_runtime.h>

#include "coverage_lcs_cell.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
coverage_lcs_kernel(const int* __restrict__ text_chars,
                    const unsigned char* __restrict__ lcs_ok,
                    const int* __restrict__ q_text,
                    const int* __restrict__ q_text_len,
                    const int* __restrict__ q_tol,
                    const unsigned char* __restrict__ q_ok,
                    const long long* __restrict__ text_ids,
                    const long long* __restrict__ qsel,
                    const int* __restrict__ text_len,
                    const float* __restrict__ lcs_in, int t_cap, int qt_cap,
                    int n_c, float* __restrict__ out) {
  const int c = blockIdx.x * kThreads + threadIdx.x;
  if (c >= n_c) return;
  out[c] = lcs::candidate(text_chars, lcs_ok, q_text, q_text_len, q_tol, q_ok,
                          text_ids, qsel, text_len, lcs_in, t_cap, qt_cap, c);
}

}  // namespace

extern "C" {

// The fake-LCS of n_c candidates on `stream`; every text id below the
// rows of text_chars, every qsel below the rows of q_text. Returns
// cudaGetLastError() of the launch (0 on success).
int coverage_lcs(const int* text_chars, const unsigned char* lcs_ok,
                 const int* q_text, const int* q_text_len, const int* q_tol,
                 const unsigned char* q_ok, const long long* text_ids,
                 const long long* qsel, const int* text_len,
                 const float* lcs_in, int t_cap, int qt_cap, int n_c,
                 float* out, void* stream) {
  if (n_c <= 0) return 0;
  const unsigned blocks = static_cast<unsigned>((n_c + kThreads - 1) / kThreads);
  coverage_lcs_kernel<<<blocks, kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      text_chars, lcs_ok, q_text, q_text_len, q_tol, q_ok, text_ids, qsel,
      text_len, lcs_in, t_cap, qt_cap, n_c, out);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
