// The exact stable top-k of every row, for Hopper (sm_90a).
//
// Replaces stable_top_k, infidex_tpu/index/device.py:150 (with
// _hier_top_k :122: per-block lax.top_k, a merge, and a masked second
// top_k for the boundary tie class) on the Stage-1 path of
// _stage1_kernel_batch_chunked (:466), the pool scores
// (index/device.py:699) and the shards (parallel/sharding.py:148). The
// port's plain version (index/device.py stable_top_k_plain) builds an
// int64 key a cell, (order image << 32) + inverted id (order_keys), and
// runs one torch.topk over them: 1 GiB of keys at 128 x 1,048,576.
//
// What it computes (stage1_topk_cell.cuh): the k largest of each row by
// (score desc, id asc), exactly and in that order, for any k in
// [1, width]; ids int32 and the row's own scores. No key matrix is
// materialised.
//
// Design. A block of 1024 threads a row. A radix select on the 32-bit
// order image (a histogram in shared memory, warp-aggregated integer
// atomics) finds the k-th score's bin; where every id at or above that
// bin fits the shared-memory sort (16,384 of them), or the bin is +0.0's
// alone, it stops after one round, else it takes up to two more (12 and
// 8 bits) to the k-th score itself. An id-ordered compaction (ballots,
// per-warp counts, a prefix over the warps) collects the ids to sort and
// the boundary class's lowest ids; a bitonic sort orders the first by
// their unique 64-bit keys, in shared memory (128 KiB, dynamic), else in
// the row's slice of a global scratch buffer the caller takes from the
// torch allocator (k = 20,000 for the recall oracle, k = width on tiny
// indexes).
//
// What bounds it. Bytes: one read of the row is the least (4 B a cell);
// most rows take two (the first round and the compaction), a row whose
// k-th bin is crowded up to four. With a block a row, a batch of 128 rows
// has 128 blocks: one an SM.

#include <cuda_runtime.h>

#include "stage1_topk_cell.cuh"

namespace {

__global__ void __launch_bounds__(topk::kThreads)
stage1_topk_kernel(const topk::Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  topk::row(a, blockIdx.x, reinterpret_cast<topk::Shared*>(smem));
}

}  // namespace

extern "C" {

// The top k of n_rows rows of `width` scores on `stream` (topk::Args
// names the arrays; topk::args_ok the widths it takes). Returns
// cudaGetLastError() of the launch (0 on success), or
// cudaErrorInvalidValue for widths it does not take.
int stage1_topk(const float* scores, long long width, int n_rows, int k,
                int shared_keys, unsigned long long* scratch,
                long long scratch_cols, float* out_scores, int* out_ids,
                void* stream) {
  if (n_rows <= 0) return 0;
  if (!topk::args_ok(width, k, shared_keys, scratch, scratch_cols)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const topk::Args a{scores, width, n_rows, k, shared_keys, scratch,
                     scratch_cols, out_scores, out_ids};
  const int smem = static_cast<int>(sizeof(topk::Shared));
  cudaError_t e = cudaFuncSetAttribute(
      stage1_topk_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  stage1_topk_kernel<<<n_rows, topk::kThreads, smem,
                       static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
