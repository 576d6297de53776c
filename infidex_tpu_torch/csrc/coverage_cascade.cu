// The Stage-2 matcher cascade of the coverage program in one launch, for
// Hopper (sm_90a).
//
// Replaces the fori_loop mask algebra of the jitted coverage program,
// infidex_tpu/ops/coverage_kernel.py:689-1030 (whole word -> joined word
// -> prefix/suffix -> fuzzy word, with single-consumption token
// deactivation): about 2,900 elementwise launches per block of candidates
// in the eager PyTorch version (ops/coverage_kernel.py
// coverage_cascade_plain), each over [Q, C] or [D, C] boolean tensors in
// device memory.
//
// What it computes. For every candidate c < C, from the pair words of
// csrc/coverage_pairs.cu (int32 [Q, D, C]) and the candidate-minor tensors
//   lens, offsets, codes, first_char  int32 [D, C]   doc tokens
//   tok_count                         int32 [C]
//   qlens, qsorted                    int32 [Q, C]   query tokens
//   qc                                int32 [Q, L, C] (its first chars)
//   qcount                            int32 [C]
// the matcher state after the four matchers: term_matched f32 [Q, C],
// term_has_whole / joined / prefix bool [Q, C], term_first_pos int32
// [Q, C], word_hits and cov_count int32 [C] (coverage_cascade_cell.cuh has
// the arithmetic). Integers equal the plain version; term_matched is
// bit-equal (adds in loop order, __fadd_rn / __fmul_rn).
//
// Design. A group of G = min(D, 32) lanes per candidate, lanes over its
// doc tokens (coverage_cascade_cell.cuh): 4 candidates a warp at D 8, 2 at
// D 16, 1 at D 64 with two tokens a lane; built per D. Each step over doc
// tokens ("the first active token that ...", "the longest, then the
// first") is a test per lane and one warp collective; only the order over
// query tokens stays sequential. A block of kTile = 8 candidates (8 G
// threads: 64, 128 or 256, every one of them computing) first copies the
// rows its candidates read into shared memory: neighbouring threads on
// neighbouring candidates of a row, every 4-byte copy in flight at once
// (cp.async), and of the pair words and doc rows only those below the
// tile's largest query-token and doc-token counts. term_matched and
// term_first_pos, indexed by token indices known only at run time (the
// length-sorted order of stage 3), live there too, beside a scratch row per
// doc token for the doc-joined pass.
//
// What bounds it. Bytes at the real token counts (the pair words are most
// of its input); in practice the latency of the copy, then of the group's
// chain of dependent collectives (about 3 per query token and matcher).

#include <cuda_runtime.h>

#include <atomic>

#include "coverage_cascade_cell.cuh"

namespace {

constexpr int kQMax = 16;

template <int D>
__host__ __device__ constexpr int group_lanes() { return D < 32 ? D : 32; }

template <int D>
__global__ void __launch_bounds__(cascade::kTile * group_lanes<D>())
coverage_cascade_kernel(const cascade::Args a) {
  constexpr int G = group_lanes<D>();
  extern __shared__ int tile[];
  const int c0 = blockIdx.x * cascade::kTile;
  const int t = static_cast<int>(threadIdx.x) / G;
  cascade::stage<D>(a, c0, threadIdx.x, blockDim.x, tile);
  __syncthreads();
  if (c0 + t >= a.n_c) return;   // the whole group
  const cascade::In in = cascade::tile_in<D>(a, tile, c0, t);
  cascade::candidate<D, G>(grp::this_group<G>(), in, a, c0 + t);
}

template <int D>
int launch(const cascade::Args& a, cudaStream_t s) {
  // the widest tile (Q 16, D 64) takes 51,264 bytes: above 48 KB a kernel
  // must be allowed its dynamic shared memory first, once per device. Host
  // threads launch concurrently (the caller holds no lock): the bits are
  // atomic, and two threads that both find a bit clear both set the
  // attribute, which does no harm.
  static std::atomic<unsigned long long> allowed{0ull};   // a bit per device
  const int bytes = 4 * cascade::layout<D>(a.n_q).ints;
  int device = 0;
  cudaError_t rc = cudaGetDevice(&device);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  if (device >= 64 ||
      !((allowed.load(std::memory_order_acquire) >> device) & 1ull)) {
    rc = cudaFuncSetAttribute(coverage_cascade_kernel<D>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              4 * cascade::layout<D>(kQMax).ints);
    if (rc != cudaSuccess) return static_cast<int>(rc);
    if (device < 64) {
      allowed.fetch_or(1ull << device, std::memory_order_release);
    }
  }
  const unsigned blocks =
      static_cast<unsigned>((a.n_c + cascade::kTile - 1) / cascade::kTile);
  coverage_cascade_kernel<D>
      <<<blocks, cascade::kTile * group_lanes<D>(), bytes, s>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// The matcher state of n_c candidates on `stream`. n_d (doc tokens per
// candidate) must be 8, 16 or 64 and n_q at most 16; `cfg` holds the nine
// ints of cascade::Config in order. Returns cudaGetLastError() of the
// launch or of its set-up (0 on success), or cudaErrorInvalidValue for
// other widths.
int coverage_cascade(const int* pairs, const int* lens, const int* offsets,
                     const int* codes, const int* first_char,
                     const int* tok_count, const int* qlens,
                     const int* qsorted, const int* qc, const int* qcount,
                     int n_q, int n_l, int n_d, int n_c, const int* cfg,
                     float* term_matched, unsigned char* has_whole,
                     unsigned char* has_joined, unsigned char* has_prefix,
                     int* first_pos, int* word_hits, int* cov_count,
                     void* stream) {
  if (n_c <= 0) return 0;
  if (n_q < 1 || n_q > kQMax) return static_cast<int>(cudaErrorInvalidValue);
  const cascade::Args a = {
      pairs, lens, offsets, codes, first_char, tok_count, qlens, qsorted, qc,
      qcount, n_q, n_l, n_c,
      {cfg[0], cfg[1], cfg[2], cfg[3], cfg[4], cfg[5], cfg[6], cfg[7],
       cfg[8]},
      term_matched, has_whole, has_joined, has_prefix, first_pos, word_hits,
      cov_count};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n_d == 8) return launch<8>(a, s);
  if (n_d == 16) return launch<16>(a, s);
  if (n_d == 64) return launch<64>(a, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
