// The LIM rows of a Stage-1 group, for Hopper (sm_90a).
//
// Replaces the low-id-matcher rows of
// infidex_tpu/index/device.py:466 _stage1_kernel_batch_chunked
// (_coverage_class :194 and _lim_rows :202: the class mask of each
// query's top distinct-term count, or'ed with the fuzzy-covered live docs,
// then a masked top_k over the id iota), which the port's plain version
// (index/device.py lim_rows_plain) runs as dense passes building a
// [n_q, n_pad] bool mask and an int64 key matrix, and a torch.topk over
// it.
//
// What it computes (stage1_lim_cell.cuh): per query, the k2 lowest ids
// below the window in the class (cnt * live >= thresh > 0, or a scoring
// fuzzy group's presence bit with live > 0, recomputed from the bitset:
// no [n_q, n_pad] mask is stored), ascending, plus id_offset, padded to
// k_out. The threshold and the offset are inputs, so a shard takes the
// global row max and writes global ids.
//
// Design. A block of 1024 threads a query walks its ids in order, 16,384
// a round: each warp counts its 512 ids' members with lane counters (its
// loads issued together; the query's scoring groups staged in shared
// memory), a prefix over the warps gives each warp its first place, and
// the warps that hold members below the k2-th read their ids again to
// place them (a ballot a warp and 32 ids). It stops after the chunk of the
// k2-th member; a query whose class has fewer reads the whole window
// once, and the segments that hold members twice.
//
// What bounds it. Bytes: the count row and the live mask up to the k2-th
// member (the whole window for a query whose class is smaller than k2),
// the presence words there, and the k_out ids written.

#include <cuda_runtime.h>

#include "stage1_lim_cell.cuh"

namespace {

__global__ void __launch_bounds__(lim::kThreads)
stage1_lim_kernel(const lim::Args a) {
  __shared__ lim::Shared sh;
  lim::row(a, blockIdx.x, &sh);
}

}  // namespace

extern "C" {

// The LIM rows of n_q queries on `stream` (lim::Args names the arrays):
// window <= width, k2 <= k_out; with has_fz, q_off has n_q + 1 entries and
// q_grp the groups they point to (each below the bitset's rows and fidf's
// length). Returns cudaGetLastError() of the launch (0 on success).
int stage1_lim(const float* cnt, long long width, int n_q, const float* live,
               const float* thresh, const unsigned* bits, long long words,
               const float* fidf, const int* q_off, const int* q_grp,
               int has_fz, long long window, int k2, int k_out, int id_offset,
               int pad, int* out, void* stream) {
  if (n_q <= 0 || k_out <= 0) return 0;
  const lim::Args a{cnt, width, n_q, live, thresh, bits, words, fidf, q_off,
                    q_grp, has_fz, window, k2, k_out, id_offset, pad, out};
  stage1_lim_kernel<<<n_q, lim::kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
