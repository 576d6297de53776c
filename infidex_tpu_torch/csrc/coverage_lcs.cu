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
// Design. A warp per candidate, four to a block, so that a block of 8,192
// candidates runs as 8,192 warps. Four, not eight: a block's resources are
// freed when its slowest warp ends, and on an H100 four were up to 13 %
// faster on rows of 256 units and as fast elsewhere (PERF.md). The warp
// copies its doc's row (contiguous, at most T units: coalesced) and its
// query's row into its own slice of shared memory, as far as the compares
// reach, with zeros past the row's end; then lane l tests the text offsets
// l, l + 32, ... for containment (each compare stops at its first
// mismatch; neighbouring lanes read neighbouring words), a ballot a round,
// and the common prefix is a ballot of mismatches and a find-first-set.
// Ineligible candidates read nothing but their flags.
//
// What bounds it. Bytes (the text and query chars the compares need, and
// the ids), far below either bound in practice: the latency of the three
// dependent reads (ids, then flags and lengths, then the rows), which the
// many warps in flight on each SM overlap.

#include <cuda_runtime.h>

#include "coverage_lcs_cell.cuh"

namespace {

constexpr int kWarps = 4;   // candidates per block
constexpr int kThreads = 32 * kWarps;
constexpr int kSharedMax = 48 * 1024;   // without an opt-in

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
  extern __shared__ int scratch[];
  const int warp = static_cast<int>(threadIdx.x) >> 5;
  const int c = blockIdx.x * kWarps + warp;
  if (c >= n_c) return;
  const grp::Group<32> g = grp::this_group<32>();
  const float v = lcs::candidate(
      g, scratch + warp * lcs::scratch_ints(t_cap, qt_cap), text_chars,
      lcs_ok, q_text, q_text_len, q_tol, q_ok, text_ids, qsel, text_len,
      lcs_in, t_cap, qt_cap, c);
  if (grp::leader(g)) out[c] = v;
}

}  // namespace

extern "C" {

// The fake-LCS of n_c candidates on `stream`; every text id below the
// rows of text_chars, every qsel below the rows of q_text. Returns
// cudaGetLastError() of the launch (0 on success), or
// cudaErrorInvalidValue for rows too wide for the scratch (t_cap +
// 2 * qt_cap above 1,536 units; the tables' widest is 256 + 2 * 64).
int coverage_lcs(const int* text_chars, const unsigned char* lcs_ok,
                 const int* q_text, const int* q_text_len, const int* q_tol,
                 const unsigned char* q_ok, const long long* text_ids,
                 const long long* qsel, const int* text_len,
                 const float* lcs_in, int t_cap, int qt_cap, int n_c,
                 float* out, void* stream) {
  if (n_c <= 0) return 0;
  const long long bytes =
      4LL * kWarps * lcs::scratch_ints(t_cap, qt_cap);
  if (bytes > kSharedMax) return static_cast<int>(cudaErrorInvalidValue);
  const unsigned blocks = static_cast<unsigned>((n_c + kWarps - 1) / kWarps);
  coverage_lcs_kernel<<<blocks, kThreads, static_cast<size_t>(bytes),
                        static_cast<cudaStream_t>(stream)>>>(
      text_chars, lcs_ok, q_text, q_text_len, q_tol, q_ok, text_ids, qsel,
      text_len, lcs_in, t_cap, qt_cap, n_c, out);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
