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
// Design. A query's window is cut into 1-16 id-ordered slices, a block
// of 512 threads each, the blocks of one thread block cluster. Each block
// walks its slice in order, 8,192 ids a round: each warp counts its 512
// ids' members with lane counters (its loads issued together; the query's
// scoring groups staged in shared memory), a prefix over the warps gives
// each warp its first place, and the warps that hold members below the
// k2-th read their ids again to place them into the block's list (a
// ballot a warp and 32 ids). Each block pushes its count to the others
// through distributed shared memory and stops after the chunk of its own
// k2-th member or once the slices before it hold k2; then each writes its
// list after the members of the slices before it. A query whose class is
// smaller than k2 so reads its window once with up to 16 SMs in place of
// one. The slice count (ops/_kernels.py lim_slices) allows up to four
// waves of blocks: rows end at very different times (a dense class after
// its first chunk), and shorter blocks even the load: 8 blocks a row for a
// group of 128 queries, 16 for one.
//
// What bounds it. Bytes: the count row and the live mask up to the k2-th
// member (the whole window for a query whose class is smaller than k2),
// the presence words there, and the k_out ids written.

#include <cuda_runtime.h>

#include "stage1_lim_cell.cuh"

namespace {

__global__ void __launch_bounds__(lim::kThreads, 2)
stage1_lim_kernel(const lim::Args a) {
  __shared__ lim::Shared sh;
  lim::row(a, static_cast<int>(blockIdx.x) / a.slices,
           lim::Cl(a.slices, &sh));
}

}  // namespace

extern "C" {

// The LIM rows of n_q queries on `stream` (lim::Args names the arrays),
// a cluster of `slices` blocks a query: window <= width, k2 <= k_out; with
// has_fz, q_off has n_q + 1 entries and q_grp the groups they point to
// (each below the bitset's rows and fidf's length); lists of more than
// list_keys ids in `scratch` ([n_q, slices, k2]). Returns the launch's
// error code (0 on success), or cudaErrorInvalidValue for a slice count
// or list size it does not take.
int stage1_lim(const float* cnt, long long width, int n_q, const float* live,
               const float* thresh, const unsigned* bits, long long words,
               const float* fidf, const int* q_off, const int* q_grp,
               int has_fz, long long window, int k2, int k_out, int id_offset,
               int pad, int* out, int slices, int list_keys, int* scratch,
               void* stream) {
  if (n_q <= 0 || k_out <= 0) return 0;
  if (!lim::args_ok(slices, list_keys, k2, scratch)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const lim::Args a{cnt, width, n_q, live, thresh, bits, words, fidf, q_off,
                    q_grp, has_fz, window, k2, k_out, id_offset, pad, out,
                    slices, list_keys, scratch};
  return static_cast<int>(clu::launch_clusters(
      stage1_lim_kernel, a, n_q, slices, lim::kThreads, 0,
      static_cast<cudaStream_t>(stream)));
}

// How many clusters of `slices` blocks of the LIM kernel can be resident
// at once, or minus an error code.
int stage1_lim_clusters(int slices) {
  if (!clu::slices_ok(slices)) {
    return -static_cast<int>(cudaErrorInvalidValue);
  }
  return clu::active_clusters(stage1_lim_kernel, slices, lim::kThreads, 0);
}

}  // extern "C"
