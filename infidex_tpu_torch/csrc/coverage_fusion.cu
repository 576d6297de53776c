// The scorer + fusion program of the coverage program in one launch, for
// Hopper (sm_90a).
//
// Replaces the rest of the jitted coverage program after its matcher
// cascade, infidex_tpu/ops/coverage_kernel.py:1079-1184 (CoverageScorer,
// the pack) with _fusion_signals :1187, _single_term_lexical_sim :1305,
// _single_char_last_boost :1389 and _fusion_score_impl :1435: about 1,100
// elementwise launches per block of candidates in the eager PyTorch
// version (ops/coverage_kernel.py coverage_fusion_plain), each over [Q, C],
// [FQ, D, C] or [L, D, C] tensors in device memory.
//
// What it computes. For every candidate c < C, from the cascade's state
// (term_matched f32, three flag rows, term_first_pos [Q, C], word_hits and
// cov_count [C]), the Damerau distances of query token 0 in the pair words
// [Q, D, C], the fusion tokens' relation words [FQ, D, C], its doc tokens
// (chars and reversed chars [L, D, C], lengths, adjacency and validity
// [D, C], token count, text length) and its query's rows of the per-query
// tables ([B, Q], [B, FQ], [B, FQ, L], [B], through the int64 qsel): the
// fusion score and tiebreaker, packed as [2, C] (score, tie<<16 | hits<<8 |
// lcs) or [3, C] (score, tie, hits). coverage_fusion_cell.cuh has the
// arithmetic; the result is bit-equal to the plain version (every f32
// operation rounded on its own, in its order).
//
// Design. A group of G = min(D, 32) lanes per candidate, lanes over its
// doc tokens (coverage_fusion_cell.cuh): 4 candidates a warp at D 8, 2 at
// D 16, 1 at D 64 with two tokens a lane; built per (L, D) so that the
// loops over a token's chars have compile-time bounds, with Q and FQ
// run-time widths. A block of kTile = 8 candidates (8 G threads: 64, 128
// or 256) first reads each candidate's scalars, then copies the rows its
// candidates read into shared memory: neighbouring threads on neighbouring
// candidates of a row, every 4-byte copy in flight at once (cp.async), and
// only the rows below the tile's largest token, query-token and
// fusion-token counts; the candidates' query rows too. The doc chars,
// which only the anchor stem (three rows), the single-char boost (one
// char) and single-token candidates' similarity read, are read in place.
// The per-token tests of every signal then run a token a lane and combine
// by ballots; the scorer and the fusion score run on every lane of the
// group alike, out of shared memory (at most 46,384 bytes a block, at Q =
// FQ = 16 and D 64).
//
// What bounds it. Bytes at the real token counts (the fusion tokens'
// relation words are most of its input); in practice the latency of the
// copy, then of the group's dependent steps.

#include <cuda_runtime.h>

#include "coverage_fusion_cell.cuh"

namespace {

constexpr int kSharedMax = 48 * 1024;   // without an opt-in

template <int D>
__host__ __device__ constexpr int group_lanes() { return D < 32 ? D : 32; }

template <int L, int D>
__global__ void __launch_bounds__(fusion::kTile * group_lanes<D>())
coverage_fusion_kernel(const fusion::Args a) {
  constexpr int G = group_lanes<D>();
  extern __shared__ int tile[];
  const int c0 = blockIdx.x * fusion::kTile;
  const int t = static_cast<int>(threadIdx.x) / G;
  const bool live = c0 + t < a.n_c;
  // the candidate's scalars first: their reads overlap the tile's copy
  fusion::In in;
  if (live) in = fusion::tile_in<L, D>(a, tile, c0, t);
  fusion::stage<D>(a, c0, threadIdx.x, blockDim.x, tile);
  __syncthreads();
  if (!live) return;   // the whole group
  fusion::candidate<L, D, G>(grp::this_group<G>(), in, a.cfg,
                             a.packed_lcs != 0, a.out + c0 + t, a.n_c);
}

template <int L, int D>
int launch(const fusion::Args& a, cudaStream_t s) {
  const int bytes = fusion::layout<D>(a.n_q, a.n_fq).bytes;
  if (bytes > kSharedMax) return static_cast<int>(cudaErrorInvalidValue);
  const unsigned blocks =
      static_cast<unsigned>((a.n_c + fusion::kTile - 1) / fusion::kTile);
  coverage_fusion_kernel<L, D>
      <<<blocks, fusion::kTile * group_lanes<D>(), bytes, s>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// The packed fusion result of n_c candidates on `stream`: out is f32
// [2, n_c] with packed_lcs, else [3, n_c]. n_l (chars per token) must be 12
// or 24, n_d (doc tokens) 8, 16 or 64, n_q and n_fq (query-token widths)
// 1 to 16; every qsel below the rows of the per-query tables. `cfg` holds
// min_word_size and cover_whole_query. Returns cudaGetLastError() of the
// launch (0 on success), or cudaErrorInvalidValue for other widths.
int coverage_fusion(const float* term_matched, const unsigned char* has_whole,
                    const unsigned char* has_joined,
                    const unsigned char* has_prefix, const int* first_pos,
                    const int* word_hits, const int* cov_count,
                    const int* pairs, const int* fq_pairs, const int* chars,
                    const int* chars_rev, const int* lens,
                    const unsigned char* adj_ws, const unsigned char* valid,
                    const int* tok_count, const int* text_len,
                    const int* q_lens, const float* q_idf, const float* q_widf,
                    const int* q_count, const int* fq_chars,
                    const int* fq_rev, const int* fq_lens,
                    const int* fq_count, const unsigned char* last_alpha,
                    const int* query_len, const long long* qsel,
                    const float* lcs,
                    const float* base, int n_q, int n_fq, int n_l, int n_d,
                    int n_c, const int* cfg, int packed_lcs, float* out,
                    void* stream) {
  if (n_c <= 0) return 0;
  if (n_q < 1 || n_q > 16 || n_fq < 1 || n_fq > 16) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const fusion::Args a = {
      term_matched, has_whole, has_joined, has_prefix, first_pos, word_hits,
      cov_count,    pairs,     fq_pairs,   chars,      chars_rev, lens,
      adj_ws,       valid,     tok_count,  text_len,   q_lens,    q_idf,
      q_widf,       q_count,   fq_chars,   fq_rev,     fq_lens,   fq_count,
      last_alpha,   query_len, qsel,       lcs,        base,      n_q,
      n_fq,         n_c,       packed_lcs, {cfg[0], cfg[1]},      out};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n_l == 12) {
    if (n_d == 8) return launch<12, 8>(a, s);
    if (n_d == 16) return launch<12, 16>(a, s);
    if (n_d == 64) return launch<12, 64>(a, s);
  } else if (n_l == 24) {
    if (n_d == 8) return launch<24, 8>(a, s);
    if (n_d == 16) return launch<24, 16>(a, s);
    if (n_d == 64) return launch<24, 64>(a, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
