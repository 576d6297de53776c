// The pair kernel of the coverage program for Hopper (sm_90a): everything
// Stage 2 needs about each (query word, doc word) pair of a block of
// candidates, from one read of the two words' characters, in one launch.
//
// Replaces, in the jitted coverage program, the pairwise word relations
// (infidex_tpu/ops/coverage_kernel.py:466 _pairwise_primitives and :526
// _q_startswith_d_t) and the edit distances (:640-662 over
// infidex_tpu/ops/editdistance_multi.py): in eager PyTorch about 200
// launches per call for the relations and 2,000 for the distances
// (ops/coverage_kernel.py coverage_pairs_plain), whose [S, L, D, C]
// equality tensors and [W, S, D, C] band rows go through device memory.
//
// What it computes. For every query token s < S, doc token d < D and
// candidate c < C, from the candidate-minor tensors
//   qc, qr  int32 [S, L, C]   the query token's chars, and reversed
//   ql      int32 [S, C]      its length
//   dc, dr  int32 [L, D, C]   the doc token's chars, and reversed
//   dl      int32 [D, C]      its length
//   valid   bool  [D, C]      whether the doc token exists
// one int32 [S, D, C]: six relation bits, the common-prefix length and,
// in the build with distances, the five Damerau distances in three bits
// each (edit_distances_cell.cuh has the layout and the cell's arithmetic).
// All integer: the result equals the plain version bit for bit. The build
// without distances serves the fusion signals' query tokens, which use
// none.
//
// Design, against what held the earlier edit-distance kernel back (one
// thread per cell, five int32 outputs per cell, its time that of the warps
// holding a live cell):
//   * one packed word per pair is written, not seven tensors: 4 bytes a
//     cell in place of 20 for the distances alone;
//   * most cells are dead (a word is empty: S and D are padded widths) and
//     need no chars: each thread settles its own cell if it is dead (a
//     build of the cell code whose words and masks are constants, folded
//     to a few operations on the two lengths; a coalesced store); the
//     live cells of a block's 256 consecutive cells
//     are compacted (ballot, prefix over the warps) into a list in shared
//     memory, and the first n_live threads take one each, so that the live
//     cells fill whole warps instead of sharing theirs with dead ones;
//   * a thread keeps both words' chars (2 L registers), the band row and
//     four position masks in registers; all loops over chars and band are
//     unrolled for L = 12 and L = 24, so every register index is static.
//
// What bounds it. Integer operations: a live cell runs up to L x (7 + 5)
// band updates of about ten operations each and up to L x L compares for
// "contains", against 4 L + 3 values read (chars re-read across s and d
// come from L2) and one int written. A sweep ends at the doc word's length,
// so the work follows the words, not L.

#include <cuda_runtime.h>

#include "edit_distances_cell.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

template <int L, bool DIST>
__global__ void __launch_bounds__(kThreads)
coverage_pairs_kernel(const int* __restrict__ qc, const int* __restrict__ qr,
                      const int* __restrict__ ql, const int* __restrict__ dc,
                      const int* __restrict__ dr, const int* __restrict__ dl,
                      const unsigned char* __restrict__ valid, int n_s,
                      int n_d, int n_c, int* __restrict__ out) {
  __shared__ int warp_live[kWarps];
  __shared__ unsigned char live_list[kThreads];
  const long long base = static_cast<long long>(blockIdx.x) * kThreads;
  const long long n = static_cast<long long>(n_s) * n_d * n_c;
  const long long plane = static_cast<long long>(n_d) * n_c;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;

  // own cell: dead or live?
  const long long own = base + threadIdx.x;
  bool live = false;
  if (own < n) {
    const int c = static_cast<int>(own % n_c);
    const int d = static_cast<int>((own / n_c) % n_d);
    const int s = static_cast<int>(own / plane);
    live = ql[static_cast<long long>(s) * n_c + c] > 0 &&
           dl[static_cast<long long>(d) * n_c + c] > 0;
  }
  const unsigned ballot = __ballot_sync(0xffffffffu, live);
  if (lane == 0) warp_live[warp] = __popc(ballot);
  __syncthreads();
  int before = 0, n_live = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    if (w < warp) before += warp_live[w];
    n_live += warp_live[w];
  }
  if (live) {
    live_list[before + __popc(ballot & ((1u << lane) - 1u))] =
        static_cast<unsigned char>(threadIdx.x);
  }
  __syncthreads();

  // a dead own cell: no chars, the arithmetic folded for empty words
  if (own < n && !live) {
    const int c = static_cast<int>(own % n_c);
    const int d = static_cast<int>((own / n_c) % n_d);
    const int s = static_cast<int>(own / plane);
    const long long d_at = static_cast<long long>(d) * n_c + c;
    out[own] = edit::pair_word<L, DIST, false>(
        nullptr, nullptr, 0, nullptr, nullptr, 0,
        ql[static_cast<long long>(s) * n_c + c], dl[d_at], valid[d_at] != 0);
  }
  // one cell of the live list
  if (static_cast<int>(threadIdx.x) < n_live) {
    const long long i = base + live_list[threadIdx.x];
    const int c = static_cast<int>(i % n_c);
    const int d = static_cast<int>((i / n_c) % n_d);
    const int s = static_cast<int>(i / plane);
    const long long q_at = static_cast<long long>(s) * L * n_c + c;
    const long long d_at = static_cast<long long>(d) * n_c + c;
    out[i] = edit::pair_word<L, DIST, true>(
        qc + q_at, qr + q_at, n_c, dc + d_at, dr + d_at, plane,
        ql[static_cast<long long>(s) * n_c + c], dl[d_at], valid[d_at] != 0);
  }
}

template <int L, bool DIST>
void launch(const int* qc, const int* qr, const int* ql, const int* dc,
            const int* dr, const int* dl, const unsigned char* valid, int n_s,
            int n_d, int n_c, int* out, unsigned blocks, cudaStream_t s) {
  coverage_pairs_kernel<L, DIST><<<blocks, kThreads, 0, s>>>(
      qc, qr, ql, dc, dr, dl, valid, n_s, n_d, n_c, out);
}

}  // namespace

extern "C" {

// The [n_s, n_d, n_c] pair words of one coverage block on `stream`, with
// the distances' bits when `with_distances` is not 0. n_l (chars per token)
// must be 12 or 24. Returns cudaGetLastError() of the launch (0 on
// success), or cudaErrorInvalidValue for another n_l.
int coverage_pairs(const int* qc, const int* qr, const int* ql, const int* dc,
                   const int* dr, const int* dl, const unsigned char* valid,
                   int n_s, int n_l, int n_d, int n_c, int with_distances,
                   int* out, void* stream) {
  const long long n = static_cast<long long>(n_s) * n_d * n_c;
  if (n <= 0) return 0;
  const unsigned blocks = static_cast<unsigned>((n + kThreads - 1) / kThreads);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n_l == 12 && with_distances) {
    launch<12, true>(qc, qr, ql, dc, dr, dl, valid, n_s, n_d, n_c, out, blocks, s);
  } else if (n_l == 12) {
    launch<12, false>(qc, qr, ql, dc, dr, dl, valid, n_s, n_d, n_c, out, blocks, s);
  } else if (n_l == 24 && with_distances) {
    launch<24, true>(qc, qr, ql, dc, dr, dl, valid, n_s, n_d, n_c, out, blocks, s);
  } else if (n_l == 24) {
    launch<24, false>(qc, qr, ql, dc, dr, dl, valid, n_s, n_d, n_c, out, blocks, s);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
