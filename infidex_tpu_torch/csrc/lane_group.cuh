// A group of G lanes of one warp that work on one item together, and the
// few collectives the coverage kernels need over it: a ballot, the first
// index that passes a test, any / all / count, the largest value (of
// floats or of ints), and a loop that shares indices out over the lanes.
//
// On the card (device code) a collective is a warp intrinsic over the
// group's lanes. On the host (g++, the CPU tests) a group is one thread:
// it runs each per-lane function for lane 0, 1, ..., G - 1 in turn and
// combines the results the same way, so the host build runs the lane code
// as the card does, phase by phase.
//
// A per-lane function takes the lane (ballot, max_of, max_int) or an index i < n
// that the lanes share out, lane l taking i = l, l + G, l + 2G, ...
// (first, any, all, count, each). Every lane of a group calls the same
// collectives in the same order: their control flow depends only on values
// the whole group holds.

#pragma once

#if defined(__CUDACC__)
#include <cuda_pipeline.h>
#define GRP_HD __host__ __device__ __forceinline__
#else
#define GRP_HD inline
#endif

namespace grp {

template <int G>
struct Group {
  static_assert(G >= 1 && G <= 32 && (G & (G - 1)) == 0,
                "a group is 1, 2, 4, 8, 16 or 32 lanes");
  int lane = 0;        // this thread's lane (0 on the host)
  unsigned mask = 0u;  // the group's lanes in its warp
  int base = 0;        // the first of them
};

#if defined(__CUDACC__)
// The group of G lanes that holds this thread: lanes [base, base + G) of
// its warp (blockDim.x a multiple of 32).
template <int G>
__device__ __forceinline__ Group<G> this_group() {
  Group<G> g;
  const int w = static_cast<int>(threadIdx.x) & 31;
  g.lane = w & (G - 1);
  g.base = w - g.lane;
  g.mask = (0xffffffffu >> (32 - G)) << g.base;
  return g;
}
#endif

GRP_HD int ctz(unsigned m) {
#if defined(__CUDA_ARCH__)
  return __ffs(static_cast<int>(m)) - 1;
#else
  return __builtin_ctz(m);
#endif
}

GRP_HD int popc(unsigned m) {
#if defined(__CUDA_ARCH__)
  return __popc(m);
#else
  return __builtin_popcount(m);
#endif
}

// Bit l is pred(l), for each lane l of the group.
template <int G, class F>
GRP_HD unsigned ballot(const Group<G>& g, const F& pred) {
#if defined(__CUDA_ARCH__)
  return (__ballot_sync(g.mask, pred(g.lane)) & g.mask) >> g.base;
#else
  unsigned m = 0u;
  for (int l = 0; l < G; ++l) m |= (pred(l) ? 1u : 0u) << l;
  return m;
#endif
}

// The largest val(l) over the lanes, by a butterfly of `a > b ? a : b`:
// the same value in any order for values that are not NaN and not -0.
template <int G, class F>
GRP_HD float max_of(const Group<G>& g, const F& val) {
#if defined(__CUDA_ARCH__)
  float v = val(g.lane);
#pragma unroll
  for (int o = G / 2; o > 0; o >>= 1) {
    const float w = __shfl_xor_sync(g.mask, v, o);
    v = w > v ? w : v;
  }
  return v;
#else
  float v[G];
  for (int l = 0; l < G; ++l) v[l] = val(l);
  for (int o = G / 2; o > 0; o >>= 1) {
    float next[G];
    for (int l = 0; l < G; ++l) {
      next[l] = v[l ^ o] > v[l] ? v[l ^ o] : v[l];
    }
    for (int l = 0; l < G; ++l) v[l] = next[l];
  }
  return v[0];
#endif
}

// The largest val(l) over the lanes, of ints: exact in any order.
template <int G, class F>
GRP_HD int max_int(const Group<G>& g, const F& val) {
#if defined(__CUDA_ARCH__)
  return __reduce_max_sync(g.mask, val(g.lane));
#else
  int v = val(0);
  for (int l = 1; l < G; ++l) {
    const int w = val(l);
    v = w > v ? w : v;
  }
  return v;
#endif
}

// The first i in [lo, n) with pred(i), else n: the lanes test G indices a
// round, lane l index lo + l of the first round.
template <int G, class F>
GRP_HD int first(const Group<G>& g, int lo, int n, const F& pred) {
  for (int i0 = lo; i0 < n; i0 += G) {
    const unsigned m =
        ballot(g, [&](int l) { return i0 + l < n && pred(i0 + l); });
    if (m != 0u) return i0 + ctz(m);
  }
  return n;
}

template <int G, class F>
GRP_HD bool any(const Group<G>& g, int n, const F& pred) {
  return first(g, 0, n, pred) < n;
}

template <int G, class F>
GRP_HD bool all(const Group<G>& g, int n, const F& pred) {
  return first(g, 0, n, [&](int i) { return !pred(i); }) == n;
}

// How many i < n pass pred.
template <int G, class F>
GRP_HD int count(const Group<G>& g, int n, const F& pred) {
  int k = 0;
  for (int i0 = 0; i0 < n; i0 += G) {
    k += popc(ballot(g, [&](int l) { return i0 + l < n && pred(i0 + l); }));
  }
  return k;
}

// f(i) for every i < n, lane l taking l, l + G, ...
template <int G, class F>
GRP_HD void each(const Group<G>& g, int n, const F& f) {
#if defined(__CUDA_ARCH__)
  for (int i = g.lane; i < n; i += G) f(i);
#else
  for (int l = 0; l < G; ++l) {
    for (int i = l; i < n; i += G) f(i);
  }
#endif
}

// What a lane wrote before this, the group's other lanes read after it.
template <int G>
GRP_HD void sync(const Group<G>& g) {
#if defined(__CUDA_ARCH__)
  __syncwarp(g.mask);
#else
  (void)g;
#endif
}

// The lane that writes the group's result.
template <int G>
GRP_HD bool leader(const Group<G>& g) {
  return g.lane == 0;
}

// A 4-byte word of global memory into shared memory: on the card an
// asynchronous copy (cp.async) that copy_wait() waits for, so that a
// thread's copies are all in flight at once; on the host at once.
template <class T>
GRP_HD void copy_async(T* dst, const T* src) {
  static_assert(sizeof(T) == 4, "4-byte words");
#if defined(__CUDA_ARCH__)
  __pipeline_memcpy_async(dst, src, 4);
#else
  *dst = *src;
#endif
}

// This thread's copy_async copies have landed.
GRP_HD void copy_wait() {
#if defined(__CUDA_ARCH__)
  __pipeline_commit();
  __pipeline_wait_prior(0);
#endif
}

}  // namespace grp
