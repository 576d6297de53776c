// The pair kernel of the coverage program for Hopper (sm_90a): everything
// Stage 2 needs about each (query word, doc word) pair of a block of
// candidates, from one read of the two words' characters, in one launch
// for the coverage block's Q tokens and its fusion (FQ) tokens together.
//
// Replaces, in the jitted coverage program, the pairwise word relations
// (infidex_tpu/ops/coverage_kernel.py:466 _pairwise_primitives and :526
// _q_startswith_d_t) and the edit distances (:640-662 over
// infidex_tpu/ops/editdistance_multi.py): in eager PyTorch about 200
// launches per call for the relations and 2,000 for the distances
// (ops/coverage_kernel.py coverage_pairs_plain), whose [S, L, D, C]
// equality tensors and [W, S, D, C] band rows go through device memory.
//
// What it computes. For every query token s, doc token d < D and
// candidate c < C, from the candidate-minor tensors
//   qc, qr  int32 [S, L, C]   the query token's chars, and reversed
//   ql      int32 [S, C]      its length
//   dc, dr  int32 [L, D, C]   the doc token's chars, and reversed
//   dl      int32 [D, C]      its length
//   valid   bool  [D, C]      whether the doc token exists
// one int32 [S, D, C]: six relation bits, the common-prefix length and,
// for the Q tokens, the five Damerau distances in three bits each
// (edit_distances_cell.cuh has the layout and the arithmetic). All
// integer: the result equals the plain version bit for bit. The FQ tokens
// (relations only) are further query slots of the same launch.
//
// Design (edit_distances_cell.cuh, pairs::block), against what held the
// earlier one-thread-a-cell kernel back (a block of 256 consecutive
// cells held about one live cell a warp, as C is the minor axis; every
// live cell compared L x L chars for "contains" and again for its masks,
// and swept twelve band cells of about ten operations a doc char):
//   * a block takes a tile of T candidates (a power of two up to 64; fewer
//     where the card would get fewer than kBlocksPerSm blocks a
//     multiprocessor, or shared memory would pass 64 KB) and copies their
//     rows into shared memory with cp.async: lengths first, then only the
//     chars inside each word;
//   * cells with an empty word get their word in closed form while the
//     chars are in flight; the others are listed (a ballot and one shared atomic a
//     warp) and dealt to the threads, so warps run full of live cells;
//   * a live cell compares each doc char with the query word's chars once
//     (min(ql, L) or L / 2 compares) and feeds that equality mask to the
//     position masks, the Shift-And "contains" and a bit-parallel
//     Levenshtein (about fifteen operations a doc char), which gives every
//     distance the band sweeps gave, bit for bit.
//
// What bounds it. Integer operations of the live cells (about 2 L + 30 a
// doc char with distances, then five rescues) against the words' chars
// read once and one int written a cell.

#include <cuda_runtime.h>

#include <atomic>

#include "edit_distances_cell.cuh"

namespace {

template <int L>
__global__ void __launch_bounds__(pairs::kThreads)
coverage_pairs_kernel(const pairs::Args a, int lt) {
  extern __shared__ int smem[];
  pairs::block<L>(a, lt, static_cast<int>(blockIdx.x) << lt,
                  static_cast<int>(threadIdx.x), pairs::kThreads, smem);
}

template <int L>
int launch(const pairs::Args& a, cudaStream_t s) {
  static std::atomic<unsigned long long> allowed{0ull};   // a bit per device
  int device = 0, n_sm = 0;
  cudaError_t rc = cudaGetDevice(&device);
  if (rc == cudaSuccess) {
    rc = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount,
                                device);
  }
  if (rc != cudaSuccess) return static_cast<int>(rc);
  const int n_slots = a.n_s + a.n_f;
  const int t = pairs::tile_candidates(L, n_slots, a.n_d, a.n_c,
                                       pairs::kBlocksPerSm * n_sm);
  if (t == 0) return static_cast<int>(cudaErrorInvalidValue);
  int lt = 0;
  while ((1 << lt) < t) ++lt;
  const int bytes = 4 * pairs::layout(L, n_slots, a.n_d, t).ints;
  // above 48 KB a kernel must be allowed its dynamic shared memory first,
  // once per device (host threads launch concurrently: the bits are
  // atomic, and setting the attribute twice does no harm)
  if (bytes > 48 * 1024 &&
      (device >= 64 ||
       !((allowed.load(std::memory_order_acquire) >> device) & 1ull))) {
    rc = cudaFuncSetAttribute(coverage_pairs_kernel<L>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              pairs::kSmemMax);
    if (rc != cudaSuccess) return static_cast<int>(rc);
    if (device < 64) {
      allowed.fetch_or(1ull << device, std::memory_order_release);
    }
  }
  const unsigned blocks = static_cast<unsigned>((a.n_c + t - 1) / t);
  coverage_pairs_kernel<L><<<blocks, pairs::kThreads, bytes, s>>>(a, lt);
  return static_cast<int>(cudaGetLastError());
}

int run(const pairs::Args& a, int n_l, void* stream) {
  if (a.n_c <= 0 || a.n_d <= 0 || a.n_s + a.n_f <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n_l == 12) return launch<12>(a, s);
  if (n_l == 24) return launch<24>(a, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

extern "C" {

// The [n_s, n_d, n_c] pair words of one set of query tokens on `stream`,
// with the distances' bits when `with_distances` is not 0. n_l (chars per
// token) must be 12 or 24, lengths at most n_l (the distances hold up to
// 31, as the plain version's). Returns cudaGetLastError() of the launch (0
// on success), or cudaErrorInvalidValue for another n_l or widths whose
// tile does not fit shared memory.
int coverage_pairs(const int* qc, const int* qr, const int* ql, const int* dc,
                   const int* dr, const int* dl, const unsigned char* valid,
                   int n_s, int n_l, int n_d, int n_c, int with_distances,
                   int* out, void* stream) {
  const pairs::Args a{qc, qr, ql, nullptr, nullptr, nullptr, dc, dr, dl,
                      valid, n_s, 0, n_d, n_c, with_distances != 0, out,
                      nullptr};
  return run(a, n_l, stream);
}

// One coverage block's pair words in one launch: [n_s, n_d, n_c] of the Q
// tokens with distances into `out`, [n_f, n_d, n_c] of the fusion tokens
// without into `fout`, over the same doc tokens. As coverage_pairs
// otherwise.
int coverage_pair_block(const int* qc, const int* qr, const int* ql, int n_s,
                        const int* fqc, const int* fqr, const int* fql,
                        int n_f, const int* dc, const int* dr, const int* dl,
                        const unsigned char* valid, int n_l, int n_d,
                        int n_c, int* out, int* fout, void* stream) {
  const pairs::Args a{qc, qr, ql, fqc, fqr, fql, dc, dr, dl, valid,
                      n_s, n_f, n_d, n_c, 1, out, fout};
  return run(a, n_l, stream);
}

}  // extern "C"
