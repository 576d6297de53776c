// The gather of one coverage block in one launch, for Hopper (sm_90a).
//
// Replaces the gather at the head of the jitted coverage program,
// infidex_tpu/ops/coverage_kernel.py:581-617 (coverage_fusion_batch: the
// per-candidate query rows, the doc token rows and the word chars, which
// XLA fuses into the program): in the eager PyTorch version
// (ops/coverage_kernel.py gather_block_plain) some forty launches per
// block of candidates (int64 index, permute, contiguous, where).
//
// What it computes. For every candidate c < C, with b = qsel[c] and
// n = text_ids[c], from the per-query tables ([B, Q, L], [B, Q], [B]; the
// fusion tokens' [B, FQ, L], [B, FQ]) and the doc token tables ([N, Dt],
// [N]; words [W, Lt]), candidate-minor (C last, every [., C] row
// contiguous):
//   qc3, qr3 [Q, L, C]      query b's chars, plain and reversed
//   qlens2, qsorted2 [Q, C], qcount [C]
//   fqc3, fqr3 [FQ, L, C], fqlens2 [FQ, C]
//   codes, offsets [D, C], adj_ws bool [D, C]   doc n's first D tokens
//   tok_count, text_len [C]
//   chars_t, chars_rev_t [L, D, C]   the first L chars of each token's
//                                    word, 0 where the token is invalid
//   lens [D, C] (0 where invalid), all_valid bool [D, C]
// A token is valid where its code is not -1 and d < tok_count. Only
// integers and bools move: the result equals the plain version exactly.
//
// Design. One thread per (candidate, slot): blockIdx.y is the slot (a
// query token, a fusion token, a doc token, or the candidate's scalars)
// and consecutive threads take consecutive candidates, so that every
// store of a [., C] row coalesces; a thread writes its slot's L chars down
// the rows, reading its word's row of the [W, Lt] tables (a doc token) or
// its query's (a query token), whose L loads are independent. Built per L
// (12 or 24) so that the char loops unroll; coverage_gather_cell.cuh has
// the arithmetic.
//
// What bounds it. Bytes: it writes every output once (most of them the
// [., L, C] char tensors) and reads table rows that neighbouring threads
// do not share (a doc's tokens, a word's chars), each a sector of its own.

#include <cuda_runtime.h>

#include "coverage_gather_cell.cuh"

namespace {

constexpr int kThreads = 256;

template <int L>
__global__ void __launch_bounds__(kThreads)
coverage_gather_kernel(const gather::Args a) {
  const int c = blockIdx.x * kThreads + threadIdx.x;
  if (c >= a.n_c) return;
  gather::slot_of<L>(a, blockIdx.y, c);
}

template <int L>
int launch(const gather::Args& a, cudaStream_t s) {
  const dim3 grid(static_cast<unsigned>((a.n_c + kThreads - 1) / kThreads),
                  static_cast<unsigned>(gather::n_slots(a)));
  coverage_gather_kernel<L><<<grid, kThreads, 0, s>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// The gathered block of n_c candidates on `stream` (gather::Args names
// the tables and outputs): n_l (chars per token) must be 12 or 24, at most
// w_cols; n_d at most d_cols. Rows are read unchecked, so the caller
// holds three invariants: every text id is in [0, n_docs) and every qsel
// in [0, n_b) (coverage_fusion_batch checks the engine's host arrays of
// both before upload), and every doc token code is -1 or in [0, n_w)
// (CoverageTables.build and append_texts write the codes and the word
// tables from one vocabulary). Returns cudaGetLastError() of the launch
// (0 on success), or cudaErrorInvalidValue for other widths.
int coverage_gather(GATHER_C_PARAMS, void* stream) {
  if (n_c <= 0) return 0;
  const gather::Args a = GATHER_ARGS;
  if (!gather::widths_ok(a, n_l)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return n_l == 12 ? launch<12>(a, s) : launch<24>(a, s);
}

}  // extern "C"
