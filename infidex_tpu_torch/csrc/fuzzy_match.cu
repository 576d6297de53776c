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
// What bounds it. The vocabulary is 25 B an id (signature 16, vpop 4,
// vlen 4, elig 1): 8.5 MB at 340k ids. Read once, with the T x cap int32
// output (48 x 8192 x 4 B = 1.6 MB) written once, that is ~10.1 MB, ~3 us
// at 3.35 TB/s; the work is 4 ANDs and 4 popcounts per (row, id), ~16M
// pairs at T = 48, some tens of microseconds of integer issue. The first
// design ran one block per token row, each walking all ids in tiles with
// two block barriers a tile: with 48 rows 84 of the 132 SMs idled, and the
// vocabulary went through L2 once per row (~408 MB at 48 rows).
//
// Design: the vocabulary is split across blocks and read from HBM once.
//  * Pass 1 (fuzzy_pass_mask_kernel), a grid over vocabulary tiles of
//    kTile ids: each thread loads its kPerThread ids' signature, vpop,
//    vlen and elig into registers once, then loops over every token row,
//    the rows staged in shared memory kRowsStaged at a time. A warp's 32
//    flags for one row become one __ballot_sync word of the pass mask
//    [T, words] (bit b of word w is id 32 w + b); no block barrier inside
//    the row loop.
//  * Pass 2 (fuzzy_place_kernel), one block per token row: each thread
//    takes a contiguous run of the row's mask words (~42 KB a row at 340k
//    ids, from L2), counts their bits, and one block-wide exclusive scan
//    gives every thread the rank of its first passing id; it then writes
//    its ids at their ranks below `cap` and the block fills the row's tail
//    with v_pad. The scan of per-tile counts and the placement are folded
//    into this one pass: a row's mask is small enough that one block reads
//    all of it, so no per-(row, tile) count table or third launch is
//    needed.
// No atomics: the output is deterministic by construction. The reference's
// f32 negated-id top-k (a TPU workaround, exact only below 2^24 ids) has
// no counterpart. A signature is 4 x uint32 (16 bytes, one uint4 load);
// `common` is the sum of four __popc, exact.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kPerThread = 2;
constexpr int kTile = kThreads * kPerThread;   // FUZZY_TILE in ops/_kernels.py
constexpr int kWordsPerTile = kTile / 32;
constexpr int kWarps = kThreads / 32;
constexpr int kRowsStaged = 256;
constexpr int kPlaceThreads = 1024;
constexpr unsigned kFull = 0xFFFFFFFFu;

__global__ void __launch_bounds__(kThreads)
fuzzy_pass_mask_kernel(const uint4* __restrict__ sig,
                       const int* __restrict__ vpop,
                       const int* __restrict__ vlen,
                       const unsigned char* __restrict__ elig,
                       const uint4* __restrict__ qsig,
                       const int* __restrict__ qpop,
                       const int* __restrict__ qlen, int n_rows, int v_pad,
                       int words_per_row, unsigned* __restrict__ mask) {
  __shared__ uint4 s_qsig[kRowsStaged];
  __shared__ int s_qpop[kRowsStaged];
  __shared__ int s_qlen[kRowsStaged];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;

  // this thread's ids: sub-tile j holds ids [tile + j*kThreads, +kThreads),
  // so warp w's 32 ids of sub-tile j are one mask word
  uint4 s[kPerThread];
  int vp[kPerThread], vl[kPerThread];
  bool el[kPerThread];
#pragma unroll
  for (int j = 0; j < kPerThread; ++j) {
    const int v = blockIdx.x * kTile + j * kThreads + threadIdx.x;
    el[j] = v < v_pad && elig[v];
    s[j] = el[j] ? __ldg(sig + v) : make_uint4(0u, 0u, 0u, 0u);
    vp[j] = el[j] ? __ldg(vpop + v) : 0;
    vl[j] = el[j] ? __ldg(vlen + v) : 0;
  }
  const int word0 = blockIdx.x * kWordsPerTile + warp;

  for (int r0 = 0; r0 < n_rows; r0 += kRowsStaged) {
    const int nr = min(kRowsStaged, n_rows - r0);
    __syncthreads();  // the previous stage's rows are no longer read
    for (int i = threadIdx.x; i < nr; i += kThreads) {
      s_qsig[i] = qsig[r0 + i];
      s_qpop[i] = qpop[r0 + i];
      s_qlen[i] = qlen[r0 + i];
    }
    __syncthreads();
    for (int i = 0; i < nr; ++i) {
      const uint4 q = s_qsig[i];
      const int qp = s_qpop[i] - 3;
      const int ql = s_qlen[i];
      unsigned* row = mask + static_cast<long long>(r0 + i) * words_per_row;
#pragma unroll
      for (int j = 0; j < kPerThread; ++j) {
        const int common = __popc(q.x & s[j].x) + __popc(q.y & s[j].y) +
                           __popc(q.z & s[j].z) + __popc(q.w & s[j].w);
        const bool ok = el[j] && common >= qp && common >= vp[j] - 3 &&
                        abs(vl[j] - ql) <= 1;
        const unsigned word = __ballot_sync(kFull, ok);
        if (lane == 0) row[word0 + j * kWarps] = word;
      }
    }
  }
}

__global__ void __launch_bounds__(kPlaceThreads)
fuzzy_place_kernel(const unsigned* __restrict__ mask, int words_per_row,
                   int v_pad, int cap, int* __restrict__ out) {
  __shared__ int warp_incl[kPlaceThreads / 32];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const unsigned* m = mask + static_cast<long long>(blockIdx.x) *
                                 words_per_row;
  int* o = out + static_cast<long long>(blockIdx.x) * cap;

  // a contiguous run of words per thread, in thread order = id order
  const int per = (words_per_row + kPlaceThreads - 1) / kPlaceThreads;
  const int w0 = min(static_cast<int>(threadIdx.x) * per, words_per_row);
  const int w1 = min(w0 + per, words_per_row);
  int local = 0;
  for (int w = w0; w < w1; ++w) local += __popc(m[w]);

  // block-wide exclusive scan of `local`
  int incl = local;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int y = __shfl_up_sync(kFull, incl, d);
    if (lane >= d) incl += y;
  }
  if (lane == 31) warp_incl[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    int t = warp_incl[lane];
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int y = __shfl_up_sync(kFull, t, d);
      if (lane >= d) t += y;
    }
    warp_incl[lane] = t;
  }
  __syncthreads();
  const int total = warp_incl[kPlaceThreads / 32 - 1];
  int pos = (warp > 0 ? warp_incl[warp - 1] : 0) + incl - local;

  for (int w = w0; w < w1 && pos < cap; ++w) {
    unsigned bits = m[w];
    while (bits != 0u && pos < cap) {
      o[pos++] = w * 32 + __ffs(bits) - 1;
      bits &= bits - 1u;
    }
  }
  for (int i = min(total, cap) + threadIdx.x; i < cap; i += kPlaceThreads) {
    o[i] = v_pad;
  }
}

}  // namespace

extern "C" {

// Match n_rows token rows against a vocabulary of v_pad ids on `stream`:
// pass 1 writes the pass mask (`mask`, uint32 [n_rows, words_per_row],
// words_per_row = ceil(v_pad / kTile) * kTile / 32), pass 2 fills `out`,
// int32 [n_rows, cap]. Returns the first non-zero cudaGetLastError() of the
// two launches (0 on success).
int fuzzy_match(const void* sig, const int* vpop, const int* vlen,
                const unsigned char* elig, const void* qsig, const int* qpop,
                const int* qlen, int n_rows, int v_pad, int cap,
                int words_per_row, void* mask, int* out, void* stream) {
  if (n_rows <= 0 || cap <= 0) return 0;
  const int n_tiles = (v_pad + kTile - 1) / kTile;
  if (words_per_row != n_tiles * kWordsPerTile) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  unsigned* m = static_cast<unsigned*>(mask);
  fuzzy_pass_mask_kernel<<<n_tiles, kThreads, 0, s>>>(
      static_cast<const uint4*>(sig), vpop, vlen, elig,
      static_cast<const uint4*>(qsig), qpop, qlen, n_rows, v_pad,
      words_per_row, m);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  fuzzy_place_kernel<<<n_rows, kPlaceThreads, 0, s>>>(m, words_per_row,
                                                      v_pad, cap, out);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
