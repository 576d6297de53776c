// A thread block cluster as a sequence of cluster steps, for the Stage-1
// kernels that serve one row with several blocks (stage1_topk, stage1_lim).
//
// The blocks of a cluster share one row, each an id-ordered slice of it. A
// cluster step is a function of (block rank, the block's Shared) that every
// block of the cluster runs, closed by a cluster barrier. Inside it a block
// runs block steps (block_steps.cuh) and reads or writes another block's
// Shared through peer(): on the card that is distributed shared memory
// (cooperative_groups' map_shared_rank) and the barrier barrier.cluster;
// on the host (g++, the CPU tests) the blocks' Shared are an array and the
// blocks run each step one after the other, rank 0 first.
//
// What blocks of one step write into each other's Shared is either
// disjoint words read only after the step's barrier, or a count that only
// grows and is read during the step only to stop a scan early (a stale
// value stops it later, never with another result). So the host build
// computes what the card computes.
//
// Loops around cluster steps must be cluster-uniform: their bounds come
// from arguments or from words that every block computes alike.

#pragma once

#include "block_steps.cuh"

#if defined(__CUDACC__)
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#endif

// Built with -DSTAGE1_TRACE (scripts/epilogue_probe.py --trace), thread 0
// of each block of the first kTraceRows rows writes the card's clock (ns)
// at the points a kernel marks with STAGE1_STAMP; otherwise a mark is
// nothing.
#if defined(__CUDA_ARCH__) && defined(STAGE1_TRACE)
#define STAGE1_STAMP(row, rank, i)                                         \
  do {                                                                     \
    if (threadIdx.x == 0 && (row) < clu::kTraceRows) {                     \
      unsigned long long t_;                                               \
      asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t_));               \
      clu::trace[((row) * 16 + (rank)) * clu::kTraceStamps + (i)] = t_;    \
    }                                                                      \
  } while (0)
#else
#define STAGE1_STAMP(row, rank, i) ((void)0)
#endif

namespace clu {

#if defined(__CUDACC__) && defined(STAGE1_TRACE)
constexpr int kTraceRows = 64;
constexpr int kTraceStamps = 8;
static __device__ unsigned long long trace[kTraceRows * 16 * kTraceStamps];
#endif

template <class S>
struct Cluster {
  int size;                 // blocks of the cluster (a row's slices)
  S* own = nullptr;         // on the card: this block's Shared
  S* const* all = nullptr;  // on the host: every block's
  GRP_HD Cluster(int n, S* sh) : size(n), own(sh) {}
  GRP_HD Cluster(int n, S* const* sh) : size(n), all(sh) {}
  // Block b's Shared (on the card through distributed shared memory).
  GRP_HD S* peer(int b) const {
#if defined(__CUDA_ARCH__)
    return cooperative_groups::this_cluster().map_shared_rank(own, b);
#else
    return all[b];
#endif
  }
  // Where words that every block computes alike are read between steps:
  // this block's Shared (on the host block 0's).
  GRP_HD S* uniform() const {
#if defined(__CUDA_ARCH__)
    return own;
#else
    return all[0];
#endif
  }
};

// f(rank, the block's Shared) for every block of the cluster (on the card:
// this block), then a cluster barrier.
template <class S, class F>
GRP_HD void step(const Cluster<S>& c, const F& f) {
#if defined(__CUDA_ARCH__)
  namespace cg = cooperative_groups;
  f(static_cast<int>(cg::this_cluster().block_rank()), c.own);
  cg::this_cluster().sync();
#else
  for (int b = 0; b < c.size; ++b) f(b, c.all[b]);
#endif
}

// A word that another block may be writing while this one reads it.
GRP_HD int read_live(const int* p) {
#if defined(__CUDA_ARCH__)
  return *static_cast<const volatile int*>(p);
#else
  return *p;
#endif
}

// The ids of a slice of `slices` over ids [0, n): a multiple of `align`
// (the last slice may be shorter, or empty).
GRP_HD long long slice_len(long long n, int slices, int align) {
  const long long len = (n + slices - 1) / slices;
  return (len + align - 1) / align * align;
}

// [lo, hi): slice `rank` of `slices` over ids [0, n).
GRP_HD void slice_of(long long n, int slices, int rank, int align,
                     long long* lo, long long* hi) {
  const long long len = slice_len(n, slices, align);
  *lo = len * rank < n ? len * rank : n;
  *hi = *lo + len < n ? *lo + len : n;
}

// Whether `slices` is a cluster size the kernels take: 1, 2, 4, 8 or 16.
GRP_HD bool slices_ok(int slices) {
  return slices >= 1 && slices <= 16 && (slices & (slices - 1)) == 0;
}

#if defined(__CUDACC__)
// Launches kernel(a) on `stream` as n_rows clusters of `slices` blocks of
// `threads`, each with `smem` bytes of dynamic shared memory (clusters of
// more than 8 blocks are allowed). Returns the launch's error code.
template <class A>
inline cudaError_t launch_clusters(void (*kernel)(A), const A& a, int n_rows,
                                   int slices, int threads, int smem,
                                   cudaStream_t stream) {
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e == cudaSuccess && slices > 8) {
    e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  }
  if (e != cudaSuccess) return e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(n_rows) * slices);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = static_cast<size_t>(smem);
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = static_cast<unsigned>(slices);
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, kernel, a);
  return e != cudaSuccess ? e : cudaGetLastError();
}

// How many clusters of `slices` blocks of kernel can be resident at once
// (cudaOccupancyMaxActiveClusters), or minus the error code.
template <class A>
inline int active_clusters(void (*kernel)(A), int slices, int threads,
                           int smem) {
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e == cudaSuccess && slices > 8) {
    e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  }
  if (e != cudaSuccess) return -static_cast<int>(e);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(slices));
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = static_cast<size_t>(smem);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = static_cast<unsigned>(slices);
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int n = 0;
  e = cudaOccupancyMaxActiveClusters(&n, kernel, &cfg);
  return e != cudaSuccess ? -static_cast<int>(e) : n;
}
#endif

}  // namespace clu
