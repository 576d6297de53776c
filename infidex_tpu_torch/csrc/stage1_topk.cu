// The exact stable top-k of every row, for Hopper (sm_90a).
//
// Replaces stable_top_k, infidex_tpu/index/device.py:150 (with
// _hier_top_k :122: per-block lax.top_k, a merge, and a masked second
// top_k for the boundary tie class) on the Stage-1 path of
// _stage1_kernel_batch_chunked (:466), the pool scores
// (index/device.py:699) and the shards (parallel/sharding.py:148), and the
// shards' merge (parallel/sharding.py:103 _stable_merge). The port's plain
// version (index/device.py stable_top_k_plain) builds an int64 key a
// cell, (order image << 32) + inverted id (order_keys), and runs one
// torch.topk over them: 1 GiB of keys at 128 x 1,048,576.
//
// What it computes (stage1_topk_cell.cuh): the k largest of each row by
// (score desc, id asc), exactly and in that order, for any k in
// [1, width]; ids int32 and the row's own scores. No key matrix is
// materialised.
//
// Design. A row is cut into 1-16 id-ordered slices, a block of 512
// threads each, the blocks of one thread block cluster; they combine
// through distributed shared memory, by integer counts only. A radix
// select on the 32-bit order image: each block's histogram of its slice
// (warp-aggregated integer atomics; +0.0's bin counted in registers),
// summed over the cluster, gives the k-th score's bin; where every id at
// or above that bin numbers at most shared_keys (16,384), or the bin is
// +0.0's alone, it stops after one round, else it takes up to two more (12
// and 8 bits) to the k-th score itself. The first round, the one read of
// the whole row, keeps each 512-id segment's largest image: later rounds
// and the compaction read only the segments that can hold what they look
// for. The sorted set's keys go to the run of the slice that holds them,
// the marked segments shared out over all the blocks (the best scores of a
// Stage-1 row crowd a few id ranges); the boundary class's lowest ids go
// straight to the output in id order, after the slices before (a prefix
// of the blocks' counts). Each block sorts its run (bitonic, in shared
// memory, else in a region of the row's global scratch that the caller
// takes from the torch allocator, its short strides a shared-memory tile
// at a time), and each key finds its place by binary searches in the
// other runs. The slice count fills the card (ops/_kernels.py
// topk_slices): 2 blocks a row for a group of 128 rows, 16 for a single
// row, where the old design had one block on one SM.
//
// What bounds it. Bytes: one read of the row is the least (4 B a cell);
// the first round reads it at HBM speed, and the compaction reads again
// the marked segments (about half of a bench row, where S crowds).
// Measured phases (scripts/epilogue_probe.py --trace) are in PERF.md.

#include <cuda_runtime.h>

#include "stage1_topk_cell.cuh"

namespace {

__global__ void __launch_bounds__(topk::kThreads, 2)
stage1_topk_kernel(const topk::Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  STAGE1_STAMP(static_cast<int>(blockIdx.x) / a.slices,
               static_cast<int>(blockIdx.x) % a.slices, 7);
  topk::row(a, static_cast<int>(blockIdx.x) / a.slices,
            topk::Cl(a.slices, reinterpret_cast<topk::Shared*>(smem)));
}

}  // namespace

extern "C" {

// The top k of n_rows rows of `width` scores on `stream` (topk::Args
// names the arrays; topk::args_ok the widths it takes), a cluster of
// `slices` blocks a row. Returns the launch's error code (0 on success),
// or cudaErrorInvalidValue for widths it does not take.
int stage1_topk(const float* scores, long long width, int n_rows, int k,
                int shared_keys, int run_keys, int slices,
                unsigned long long* scratch, long long scratch_cols,
                float* out_scores, int* out_ids, void* stream) {
  if (n_rows <= 0) return 0;
  if (!topk::args_ok(width, k, shared_keys, run_keys, slices, scratch,
                     scratch_cols)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const topk::Args a{scores, width, n_rows, k, shared_keys, run_keys,
                     slices, scratch, scratch_cols, out_scores, out_ids};
  return static_cast<int>(clu::launch_clusters(
      stage1_topk_kernel, a, n_rows, slices, topk::kThreads,
      topk::shared_bytes(run_keys), static_cast<cudaStream_t>(stream)));
}

// How many clusters of `slices` blocks of the top-k kernel with runs of
// `run_keys` keys in shared memory can be resident at once, or minus an
// error code.
int stage1_topk_clusters(int slices, int run_keys) {
  if (!clu::slices_ok(slices) || !topk::is_pow2(run_keys)
      || run_keys > topk::kRunKeys) {
    return -static_cast<int>(cudaErrorInvalidValue);
  }
  return clu::active_clusters(stage1_topk_kernel, slices, topk::kThreads,
                              topk::shared_bytes(run_keys));
}

#if defined(STAGE1_TRACE)
// The trace of the last launch (cluster_steps.cuh): [kTraceRows][16 ranks]
// [kTraceStamps] ns, a round's end, the S compaction's, B's, the sort's and
// the merge's. Returns the copy's error code.
int stage1_topk_trace(unsigned long long* out) {
  return static_cast<int>(cudaMemcpyFromSymbol(out, clu::trace,
                                               sizeof(clu::trace)));
}
#endif

}  // extern "C"
