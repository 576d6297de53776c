// Signature match of the fuzzy (LD1) term expansion, for Hopper (sm_90a).
//
// Replaces infidex_tpu/ops/fuzzy.py:_match_kernel, the jitted XLA program
// that the reference runs on the TPU's matrix unit: an int8 [T,128]x[128,V]
// product of common-bit counts, a pass mask, and a top-k over negated ids.
//
// What it computes. For query-token row r and every vocabulary id v in
// ascending order, v passes when
//     common = popcount(qsig[r] & sig[v])            (128-bit signatures)
//     elig[v] && common >= qpop[r] - 3 && common >= vpop[v] - 3
//             && |vlen[v] - qlen[r]| <= 1.
// Row r of `out` receives the first `cap` passing ids in ascending order,
// then `v_pad` (the vocabulary axis length) in every slot left. Pad token
// rows (qpop = qlen = 0) match only eligible terms of length <= 1, which
// the eligibility rule (length >= min_len) excludes.
//
// Design. A signature is 4 x uint32 (16 bytes, one uint4 load); `common`
// is the sum of four __popc, exact. One block per token row walks the
// vocabulary in id order, a tile of kTile ids at a time: each thread tests
// kPerThread ids, strided by the block width so that neighbouring threads
// load neighbouring signatures. The pass flags of a tile are ranked in id
// order by one block-wide prefix sum of a packed 64-bit value that holds
// the thread's kPerThread flags in 16-bit fields (a field sums at most
// kThreads = 256 flags, so no field carries into the next). Passing ids
// are written at their rank; the block stops once `cap` ids are out. No
// atomics: the output is deterministic by construction. The reference's
// f32 negated-id top-k (a TPU workaround, exact only below 2^24 ids) has
// no counterpart.
//
// What bounds it. Each row reads 25 bytes per vocabulary id (signature,
// vpop, vlen, elig): ~9 MB at 350k ids, which the 50 MB L2 keeps for all
// rows of a launch, so the kernel is bound by L2 bandwidth and the
// per-tile block synchronisation. Rows run in parallel, one block each.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kPerThread = 4;
constexpr int kTile = kThreads * kPerThread;

__device__ __forceinline__ int field(unsigned long long x, int j) {
  return static_cast<int>((x >> (16 * j)) & 0xFFFFull);
}

__global__ void __launch_bounds__(kThreads)
fuzzy_match_kernel(const uint4* __restrict__ sig,
                   const int* __restrict__ vpop,
                   const int* __restrict__ vlen,
                   const unsigned char* __restrict__ elig,
                   const uint4* __restrict__ qsig,
                   const int* __restrict__ qpop,
                   const int* __restrict__ qlen,
                   int v_pad, int cap, int* __restrict__ out) {
  __shared__ unsigned long long warp_tot[kWarps];
  const int row = blockIdx.x;
  const uint4 q = qsig[row];
  const int qp = qpop[row];
  const int ql = qlen[row];
  int* o = out + static_cast<long long>(row) * cap;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;

  int written = 0;  // ids ranked so far; the same value in every thread
  for (int tile = 0; tile < v_pad && written < cap; tile += kTile) {
    unsigned long long packed = 0;
    int ids[kPerThread];
#pragma unroll
    for (int j = 0; j < kPerThread; ++j) {
      const int v = tile + j * kThreads + threadIdx.x;
      ids[j] = v;
      bool ok = false;
      if (v < v_pad && elig[v]) {
        const uint4 s = __ldg(sig + v);
        const int common = __popc(q.x & s.x) + __popc(q.y & s.y) +
                           __popc(q.z & s.z) + __popc(q.w & s.w);
        ok = common >= qp - 3 && common >= __ldg(vpop + v) - 3 &&
             abs(__ldg(vlen + v) - ql) <= 1;
      }
      packed |= static_cast<unsigned long long>(ok) << (16 * j);
    }
    // block-wide inclusive scan of the packed flag counts (thread order)
    unsigned long long incl = packed;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const unsigned long long y = __shfl_up_sync(0xFFFFFFFFu, incl, d);
      if (lane >= d) incl += y;
    }
    if (lane == 31) warp_tot[warp] = incl;
    __syncthreads();
    unsigned long long before = 0, total = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const unsigned long long t = warp_tot[w];
      if (w < warp) before += t;
      total += t;
    }
    const unsigned long long excl = before + incl - packed;
    // id order within the tile is (j, thread): sub-round j's passers
    // follow every passer of sub-rounds < j
#pragma unroll
    for (int j = 0; j < kPerThread; ++j) {
      if ((packed >> (16 * j)) & 1ull) {
        const int p = written + field(excl, j);
        if (p < cap) o[p] = ids[j];
      }
      written += field(total, j);
    }
    __syncthreads();  // warp_tot is rewritten by the next tile
  }
  for (int i = min(written, cap) + threadIdx.x; i < cap; i += kThreads) {
    o[i] = v_pad;
  }
}

}  // namespace

extern "C" {

// Launch the match of n_rows token rows against a vocabulary of v_pad ids
// on `stream`; `out` is int32 [n_rows, cap]. Returns cudaGetLastError() of
// the launch (0 on success).
int fuzzy_match(const void* sig, const int* vpop, const int* vlen,
                const unsigned char* elig, const void* qsig, const int* qpop,
                const int* qlen, int n_rows, int v_pad, int cap, int* out,
                void* stream) {
  if (n_rows <= 0 || cap <= 0) return 0;
  fuzzy_match_kernel<<<n_rows, kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint4*>(sig), vpop, vlen, elig,
      static_cast<const uint4*>(qsig), qpop, qlen, v_pad, cap, out);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
