// The fuzzy groups' presence bitset and df over a doc window, for Hopper
// (sm_90a).
//
// Replaces the presence half of the fuzzy virtual-term block,
// infidex_tpu/index/device.py:415 _fuzzy_block (:425-447: the matched
// terms' postings expanded into a flat lane space, a scatter-max of 1 into
// a dense f32 [n_grp, n_pad] presence matrix, df its row sum), which the
// port's plain version (index/device.py fuzzy_presence_plain) runs as the
// same dense f32 matrix: 4 MiB a group at 1M docs.
//
// What it computes (stage1_fuzzy_cell.cuh): a presence bitset
// [n_grp, ceil(width / 32)] of 32-bit words, bit d of row g set where doc
// doc_lo + d carries a posting of one of group g's terms, and each
// group's df, the row's popcount, as an exact integer. Deleted docs
// count (presence is taken over the raw postings); lanes outside the
// window are dropped.
//
// Design. One launch: one thread per flat lane ORs its posting's bit into
// its group's row (atomicOr: integer, so the bitset does not depend on the
// order). atomicOr returns the word before, so the one lane that turns a
// bit on knows that its group's df grew by one: the lanes of a warp that
// did so add their counts, one atomicAdd per group present in the warp
// (__match_any_sync). The bitset is 1/32 of the dense matrix (128 KiB a
// group at 1M docs), it is not read back, and no float is added anywhere.
//
// What bounds it. Bytes: the lanes' posting reads (4 B each, plus the
// term lookup, which stays in L1) and the bitset, zeroed by the caller and
// written here; at a batch's few hundred groups both are small beside the
// epilogue's [n_q, n_pad] pass.

#include <cuda_runtime.h>

#include "stage1_fuzzy_cell.cuh"

namespace {

constexpr int kMarkThreads = 256;

__global__ void __launch_bounds__(kMarkThreads)
stage1_fuzzy_mark_kernel(const fuzzy::Args a) {
  const long long i0 = static_cast<long long>(blockIdx.x) * kMarkThreads +
                       (threadIdx.x & ~31u);
  fuzzy::mark_warp(grp::this_group<32>(), a, i0);
}

}  // namespace

extern "C" {

// Presence bits and df of n_grp groups over the window [doc_lo, doc_hi),
// on `stream`; both zero on entry. starts/group hold n_terms entries, cum
// n_terms + 1 (cum[0] = 0, cum[n_terms] = n_lanes); every group id is
// below n_grp and every posting read lies inside postings_docs (the
// caller's tables come from the index's own CSR). Returns
// cudaGetLastError() after the launch (0 on success; no launch without
// groups).
int stage1_fuzzy(const int* starts, const int* group, const int* cum,
                 int n_terms, long long n_lanes, const int* postings_docs,
                 int doc_lo, int doc_hi, unsigned* bits, long long words,
                 int n_grp, int* df, void* stream) {
  if (n_grp <= 0) return 0;
  const fuzzy::Args a{starts, group, cum, n_terms, n_lanes, postings_docs,
                      doc_lo, doc_hi, bits, words, n_grp, df};
  const long long blocks =
      n_lanes > 0 ? (n_lanes + kMarkThreads - 1) / kMarkThreads : 1;
  stage1_fuzzy_mark_kernel<<<static_cast<unsigned>(blocks), kMarkThreads, 0,
                             static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
