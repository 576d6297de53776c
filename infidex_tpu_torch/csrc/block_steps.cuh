// A thread block as a sequence of steps, for the Stage-1 epilogue kernels
// (stage1_fuzzy, stage1_epilogue, stage1_topk, stage1_lim).
//
// A step is a function of (warp, warp index) that every warp of the block
// runs, closed by a barrier: on the card each warp runs it at once and
// __syncthreads() follows; on the host (g++, the CPU tests) the warps run
// one after the other, and the lanes of a warp one after the other inside
// each collective of lane_group.cuh. Warps of one step write disjoint
// words or combine by integer atomics, whose result does not depend on
// their order, so the host build computes what the card computes.
//
// Loops around steps must be block-uniform: their bounds come from
// arguments or from shared words written in an earlier step.

#pragma once

#include "lane_group.cuh"

namespace blk {

using Warp = grp::Group<32>;

// f(warp, w) for every warp w < n_warps of the block, then a barrier.
template <class F>
GRP_HD void step(int n_warps, const F& f) {
#if defined(__CUDA_ARCH__)
  (void)n_warps;
  f(grp::this_group<32>(), static_cast<int>(threadIdx.x) >> 5);
  __syncthreads();
#else
  for (int w = 0; w < n_warps; ++w) f(Warp{}, w);
#endif
}

// f(l) for each lane l of the warp (on the card: this thread's lane).
template <class F>
GRP_HD void lanes(const Warp& g, const F& f) {
  grp::each(g, 32, f);
}

// A value per lane that lives from one collective to the next within a
// step: a register on the card, an array over the lanes on the host.
template <class T>
struct Lanes {
#if defined(__CUDA_ARCH__)
  T v;
  __device__ __forceinline__ T& operator[](int) { return v; }
#else
  T v[32];
  T& operator[](int l) { return v[l]; }
#endif
};

// Bits of the lanes below lane l.
GRP_HD unsigned below(int l) { return (1u << l) - 1u; }

// The sum of val(l) over the lanes (ints: exact in any order).
template <class F>
GRP_HD int sum_int(const Warp& g, const F& val) {
#if defined(__CUDA_ARCH__)
  return __reduce_add_sync(g.mask, val(g.lane));
#else
  int s = 0;
  for (int l = 0; l < 32; ++l) s += val(l);
  return s;
#endif
}

// The largest val(l) over the lanes, of unsigned ints.
template <class F>
GRP_HD unsigned max_uint(const Warp& g, const F& val) {
#if defined(__CUDA_ARCH__)
  return __reduce_max_sync(g.mask, val(g.lane));
#else
  unsigned m = val(0);
  for (int l = 1; l < 32; ++l) {
    const unsigned v = val(l);
    m = v > m ? v : m;
  }
  return m;
#endif
}

// Integer atomics (plain on the host, where warps run in turn).
GRP_HD void atomic_add(int* p, int v) {
#if defined(__CUDA_ARCH__)
  atomicAdd(p, v);
#else
  *p += v;
#endif
}

GRP_HD void atomic_max(int* p, int v) {
#if defined(__CUDA_ARCH__)
  atomicMax(p, v);
#else
  if (v > *p) *p = v;
#endif
}

GRP_HD void atomic_max(unsigned* p, unsigned v) {
#if defined(__CUDA_ARCH__)
  atomicMax(p, v);
#else
  if (v > *p) *p = v;
#endif
}

// *p |= v; returns the word before
GRP_HD unsigned atomic_or(unsigned* p, unsigned v) {
#if defined(__CUDA_ARCH__)
  return atomicOr(p, v);
#else
  const unsigned old = *p;
  *p |= v;
  return old;
#endif
}

// Adds one to counts[key(l)] for each lane l whose key is not negative,
// the lanes of one key by one atomic add (ints: exact in any order).
template <class F>
GRP_HD void count_keys(const Warp& g, int* counts, const F& key) {
#if defined(__CUDA_ARCH__)
  const int k = key(g.lane);
  const unsigned peers = __match_any_sync(g.mask, k);
  if (k >= 0 && g.lane == __ffs(static_cast<int>(peers)) - 1) {
    atomicAdd(counts + k, __popc(peers));
  }
#else
  for (int l = 0; l < 32; ++l) {
    const int k = key(l);
    if (k >= 0) counts[k] += 1;
  }
#endif
}

GRP_HD int popc(unsigned m) { return grp::popc(m); }

// Reserves n slots at *counter for the warp: the old value, on every lane
// (lane 0 adds; a shuffle shares it).
GRP_HD int append(const Warp& g, int* counter, int n) {
#if defined(__CUDA_ARCH__)
  int base = 0;
  if (g.lane == 0) base = atomicAdd(counter, n);
  return __shfl_sync(g.mask, base, 0);
#else
  (void)g;
  const int base = *counter;
  *counter += n;
  return base;
#endif
}

// f32 operations rounded one at a time (the host build compiles with
// -ffp-contract=off), as the plain PyTorch versions round them.
GRP_HD float fadd(float a, float b) {
#if defined(__CUDA_ARCH__)
  return __fadd_rn(a, b);
#else
  return a + b;
#endif
}

GRP_HD float fmul(float a, float b) {
#if defined(__CUDA_ARCH__)
  return __fmul_rn(a, b);
#else
  return a * b;
#endif
}

GRP_HD unsigned float_bits(float x) {
#if defined(__CUDA_ARCH__)
  return __float_as_uint(x);
#else
  unsigned b;
  __builtin_memcpy(&b, &x, sizeof b);
  return b;
#endif
}

// Bit i of a bitset row of 32-bit words.
GRP_HD bool bit_of(const unsigned* row, long long i) {
  return (row[i >> 5] >> (i & 31)) & 1u;
}

}  // namespace blk
