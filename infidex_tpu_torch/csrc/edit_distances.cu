// The Stage-2 edit distances of the coverage program in one launch, for
// Hopper (sm_90a).
//
// Replaces the edit-distance part of the jitted coverage program,
// infidex_tpu/ops/coverage_kernel.py:640-662 over
// infidex_tpu/ops/editdistance_multi.py (batched_lev_multi twice,
// alignment_tensors, damerau_rescue five times): about 2,000 elementwise
// launches per block of candidates in the eager PyTorch version
// (ops/editdistance_multi.py coverage_distances_plain), whose
// [W, Q, D, C] band rows and [Q, L, D, C] equality tensors go through
// device memory at every step.
//
// What it computes. For every query token q < Q, doc token d < D and
// candidate c < C, from the candidate-minor tensors
//   qc, qr  int32 [Q, L, C]   the query token's chars, and reversed
//   ql      int32 [Q, C]      its length
//   dc, dr  int32 [L, D, C]   the doc token's chars, and reversed
//   dl      int32 [D, C]      its length
// the five Damerau distances dam1, dam2, pdam1, pdam2, pdam3, each int32
// [Q, D, C] (see edit_distances_cell.cuh for the cell's arithmetic). All
// integer: the result equals the plain version bit for bit.
//
// Design. One thread per (q, d, c), c fastest, so a warp's loads of one
// char position are 32 consecutive ints and its five stores coalesce. A
// thread keeps both words' chars (2 L registers), the band row (7, then 5)
// and four position masks in registers; the loops over chars and band are
// unrolled at compile time for L = 12 and L = 24, the two char widths of
// the coverage program, so every register index is static. Nothing is
// shared between threads: no shared memory, no barrier, no atomics. Cells
// with an empty query or doc token (most of a block: Q and D are padded
// widths) read no chars and run no sweep.
//
// What bounds it. Integer operations, not bytes: a live cell runs up to
// L x (7 + 5) band updates of about ten operations each, against 4 L + 2
// ints read (chars re-read across q and d come from L2) and five ints
// written. A sweep ends at the doc token's length, so the work follows the
// words, not L.

#include <cuda_runtime.h>

#include "edit_distances_cell.cuh"

namespace {

constexpr int kThreads = 128;

template <int L>
__global__ void __launch_bounds__(kThreads)
edit_distances_kernel(const int* __restrict__ qc, const int* __restrict__ qr,
                      const int* __restrict__ ql, const int* __restrict__ dc,
                      const int* __restrict__ dr, const int* __restrict__ dl,
                      int n_q, int n_d, int n_c, int* __restrict__ dam1,
                      int* __restrict__ dam2, int* __restrict__ pdam1,
                      int* __restrict__ pdam2, int* __restrict__ pdam3) {
  const long long i =
      static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  const long long n = static_cast<long long>(n_q) * n_d * n_c;
  if (i >= n) return;
  const int c = static_cast<int>(i % n_c);
  const int d = static_cast<int>((i / n_c) % n_d);
  const int q = static_cast<int>(i / (static_cast<long long>(n_c) * n_d));
  const long long q_stride = n_c;
  const long long d_stride = static_cast<long long>(n_d) * n_c;
  const long long q_at = static_cast<long long>(q) * L * n_c + c;
  const long long d_at = static_cast<long long>(d) * n_c + c;
  int out[5];
  edit::edit_cell<L>(qc + q_at, qr + q_at, q_stride, dc + d_at, dr + d_at,
                     d_stride, ql[static_cast<long long>(q) * n_c + c],
                     dl[d_at], out);
  dam1[i] = out[0];
  dam2[i] = out[1];
  pdam1[i] = out[2];
  pdam2[i] = out[3];
  pdam3[i] = out[4];
}

}  // namespace

extern "C" {

// The five [n_q, n_d, n_c] distance tensors of one coverage block on
// `stream`. n_l (chars per token) must be 12 or 24. Returns
// cudaGetLastError() of the launch (0 on success), or
// cudaErrorInvalidValue for another n_l.
int edit_distances(const int* qc, const int* qr, const int* ql, const int* dc,
                   const int* dr, const int* dl, int n_q, int n_l, int n_d,
                   int n_c, int* dam1, int* dam2, int* pdam1, int* pdam2,
                   int* pdam3, void* stream) {
  const long long n = static_cast<long long>(n_q) * n_d * n_c;
  if (n <= 0) return 0;
  const unsigned blocks = static_cast<unsigned>((n + kThreads - 1) / kThreads);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n_l == 12) {
    edit_distances_kernel<12><<<blocks, kThreads, 0, s>>>(
        qc, qr, ql, dc, dr, dl, n_q, n_d, n_c, dam1, dam2, pdam1, pdam2,
        pdam3);
  } else if (n_l == 24) {
    edit_distances_kernel<24><<<blocks, kThreads, 0, s>>>(
        qc, qr, ql, dc, dr, dl, n_q, n_d, n_c, dam1, dam2, pdam1, pdam2,
        pdam3);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
