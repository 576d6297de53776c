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
// Design. One thread per candidate. The active query tokens are a 16-bit
// mask and the active doc tokens a D-bit mask in registers (one 32-bit word
// at D = 8 and 16, one 64-bit word at D = 64; the kernel is built per D);
// "first true" is a find-first-set and loops walk set bits only, so a
// thread's work follows its candidate's real token counts. A thread's reads
// depend on its masks, one after the other, and a block of candidates gives
// the card few threads, so the latency of each read is what counts: a block
// of 128 threads first copies everything its tile of 32 candidates needs
// into shared memory (coalesced rows of 32 ints; of the pair words only the
// rows below the tile's largest query and doc token counts), then one warp
// runs the 32 candidates out of shared memory. term_matched and
// term_first_pos, indexed by token indices known only at run time (the
// length-sorted order of stage 3), live there too as [Q][32]: no local
// memory, no bank conflict.
//
// What bounds it. Bytes at the real token counts (the pair words are most
// of its input), latency in practice: 32 of a block's 128 threads compute.

#include <cuda_runtime.h>

#include <atomic>

#include "coverage_cascade_cell.cuh"

namespace {

constexpr int kTile = 32;      // candidates per block
constexpr int kThreads = 128;
constexpr int kQMax = 16;

// rows [0, rows) of a [rows, n_c] tensor, columns c0 .. c0 + width, into a
// [rows, kTile] tile
__device__ __forceinline__ void copy_rows(int* dst, const int* src, int rows,
                                          long long row_stride, int c0,
                                          int width) {
  for (int i = threadIdx.x; i < rows * kTile; i += kThreads) {
    const int row = i / kTile, col = i % kTile;
    if (col < width) dst[i] = src[row * row_stride + c0 + col];
  }
}

// ints of shared memory a block needs
__host__ __device__ constexpr int tile_ints(int n_q, int n_d) {
  return kTile * (n_q * n_d + 4 * n_d + 5 * n_q) + 2;
}

template <int D>
__global__ void __launch_bounds__(kThreads)
coverage_cascade_kernel(const int* __restrict__ pairs,
                        const int* __restrict__ lens,
                        const int* __restrict__ offsets,
                        const int* __restrict__ codes,
                        const int* __restrict__ first_char,
                        const int* __restrict__ tok_count,
                        const int* __restrict__ qlens,
                        const int* __restrict__ qsorted,
                        const int* __restrict__ qc,
                        const int* __restrict__ qcount, int n_q, int n_l,
                        int n_c, cascade::Config cfg,
                        float* __restrict__ term_matched,
                        unsigned char* __restrict__ has_whole,
                        unsigned char* __restrict__ has_joined,
                        unsigned char* __restrict__ has_prefix,
                        int* __restrict__ first_pos,
                        int* __restrict__ word_hits,
                        int* __restrict__ cov_count) {
  extern __shared__ int tile[];
  int* s_pairs = tile;
  int* s_lens = s_pairs + n_q * D * kTile;
  int* s_offsets = s_lens + D * kTile;
  int* s_codes = s_offsets + D * kTile;
  int* s_first = s_codes + D * kTile;
  int* s_qlens = s_first + D * kTile;
  int* s_qsorted = s_qlens + n_q * kTile;
  int* s_qfirst = s_qsorted + n_q * kTile;
  float* s_tm = reinterpret_cast<float*>(s_qfirst + n_q * kTile);
  int* s_fp = s_qfirst + 2 * n_q * kTile;
  int* s_max = s_fp + n_q * kTile;   // the tile's largest token counts

  const int c0 = blockIdx.x * kTile;
  const int width = n_c - c0 < kTile ? n_c - c0 : kTile;
  const int lane = threadIdx.x;
  int my_tok = 0, my_q = 0;
  if (lane < width) {
    my_tok = tok_count[c0 + lane];
    my_q = qcount[c0 + lane];
  }
  if (threadIdx.x < 32) {
    int max_tok = my_tok, max_q = my_q;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      max_tok = max(max_tok, __shfl_xor_sync(0xffffffffu, max_tok, o));
      max_q = max(max_q, __shfl_xor_sync(0xffffffffu, max_q, o));
    }
    if (lane == 0) {
      s_max[0] = min(max(max_tok, 0), D);
      s_max[1] = min(max(max_q, 0), n_q);
    }
  }
  __syncthreads();
  const int max_tok = s_max[0], max_q = s_max[1];
  // pair words: rows (q, d) with q < max_q, d < max_tok
  for (int q = 0; q < max_q; ++q) {
    copy_rows(s_pairs + q * D * kTile, pairs + static_cast<long long>(q) * D * n_c,
              max_tok, n_c, c0, width);
  }
  copy_rows(s_lens, lens, max_tok, n_c, c0, width);
  copy_rows(s_offsets, offsets, max_tok, n_c, c0, width);
  copy_rows(s_codes, codes, max_tok, n_c, c0, width);
  copy_rows(s_first, first_char, max_tok, n_c, c0, width);
  copy_rows(s_qlens, qlens, n_q, n_c, c0, width);
  copy_rows(s_qsorted, qsorted, n_q, n_c, c0, width);
  copy_rows(s_qfirst, qc, n_q, static_cast<long long>(n_l) * n_c, c0, width);
  __syncthreads();
  if (lane >= width) return;

  cascade::In in;
  in.pairs = s_pairs + lane;
  in.lens = s_lens + lane;
  in.offsets = s_offsets + lane;
  in.codes = s_codes + lane;
  in.first_char = s_first + lane;
  in.qlens = s_qlens + lane;
  in.qsorted = s_qsorted + lane;
  in.qfirst = s_qfirst + lane;
  in.qfirst_stride = kTile;
  in.stride = kTile;
  in.tok_count = my_tok;
  in.qcount = my_q;
  cascade::Out out;
  cascade::candidate<D>(in, n_q, cfg, s_tm + lane, s_fp + lane, kTile, out);
  const int c = c0 + lane;
  for (int i = 0; i < n_q; ++i) {
    const long long at = static_cast<long long>(i) * n_c + c;
    term_matched[at] = s_tm[i * kTile + lane];
    first_pos[at] = s_fp[i * kTile + lane];
    has_whole[at] = (out.has_whole >> i) & 1u;
    has_joined[at] = (out.has_joined >> i) & 1u;
    has_prefix[at] = (out.has_prefix >> i) & 1u;
  }
  word_hits[c] = out.word_hits;
  cov_count[c] = out.cov_count;
}

template <int D>
int launch(const int* pairs, const int* lens, const int* offsets,
           const int* codes, const int* first_char, const int* tok_count,
           const int* qlens, const int* qsorted, const int* qc,
           const int* qcount, int n_q, int n_l, int n_c,
           const cascade::Config& cfg, float* term_matched,
           unsigned char* has_whole, unsigned char* has_joined,
           unsigned char* has_prefix, int* first_pos, int* word_hits,
           int* cov_count, cudaStream_t s) {
  // the widest tile (Q 16, D 64) takes 174 KB: above 48 KB a kernel must
  // be allowed its dynamic shared memory first, once per device. Host
  // threads launch concurrently (the caller holds no lock): the bits are
  // atomic, and two threads that both find a bit clear both set the
  // attribute, which does no harm.
  static std::atomic<unsigned long long> allowed{0ull};   // a bit per device
  const int bytes = 4 * tile_ints(n_q, D);
  int device = 0;
  cudaError_t rc = cudaGetDevice(&device);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  if (device >= 64 ||
      !((allowed.load(std::memory_order_acquire) >> device) & 1ull)) {
    rc = cudaFuncSetAttribute(coverage_cascade_kernel<D>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              4 * tile_ints(kQMax, D));
    if (rc != cudaSuccess) return static_cast<int>(rc);
    if (device < 64) {
      allowed.fetch_or(1ull << device, std::memory_order_release);
    }
  }
  const unsigned blocks = static_cast<unsigned>((n_c + kTile - 1) / kTile);
  coverage_cascade_kernel<D><<<blocks, kThreads, bytes, s>>>(
      pairs, lens, offsets, codes, first_char, tok_count, qlens, qsorted, qc,
      qcount, n_q, n_l, n_c, cfg, term_matched, has_whole, has_joined,
      has_prefix, first_pos, word_hits, cov_count);
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
  const cascade::Config config = {cfg[0], cfg[1], cfg[2], cfg[3], cfg[4],
                                  cfg[5], cfg[6], cfg[7], cfg[8]};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define CASCADE_LAUNCH(D)                                                     \
  launch<D>(pairs, lens, offsets, codes, first_char, tok_count, qlens,        \
            qsorted, qc, qcount, n_q, n_l, n_c, config, term_matched,         \
            has_whole, has_joined, has_prefix, first_pos, word_hits,          \
            cov_count, s)
  if (n_d == 8) return CASCADE_LAUNCH(8);
  if (n_d == 16) return CASCADE_LAUNCH(16);
  if (n_d == 64) return CASCADE_LAUNCH(64);
#undef CASCADE_LAUNCH
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
