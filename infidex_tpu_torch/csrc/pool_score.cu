// Exact BM25+ of host-selected candidate pools (device pool scoring), for
// Hopper (sm_90a).
//
// Replaces infidex_tpu/index/device.py:_pool_score_kernel (jitted XLA, the
// device half of INFIDEX_TPU_POOL_DEVICE=1), up to its top-k: the top-k
// over pool positions and the gather of the ids stay in PyTorch
// (index/device.py stable_top_k), as in the reference.
//
// What it computes. Job b has an ascending pool of doc ids
// pool[b, 0:Pp] (valid where pool_valid) and up to T query terms, each a
// doc-sorted posting range [term_starts[b,t], +term_lens[b,t]) of the FULL
// base CSR (no champion clipping) with its idf. For every (b, p):
//     norm  = K1 * ((1 - B) + B * (dl / avgdl))    dl = doc_lengths[doc], 1 if <= 0
//     score = sum over t, in term order, where the doc carries term t:
//             idf * ((tf * (K1 + 1)) / (tf + norm) + DELTA)
// tf is the posting's uint8 weight. The doc is found by a binary search of
// exactly kBsearchBits = 21 steps (the reference's _POOL_BSEARCH_BITS),
// which covers posting ranges of up to 2^21 docs. Every product, quotient
// and sum is written with __fmul_rn / __fdiv_rn / __fadd_rn in the
// reference's operation order, so the compiler can neither contract nor
// reorder them: the scores are bit-equal to the host scorer
// (index/candidates.py score_pool and its native twin in native/_lib.cpp)
// and to the plain PyTorch version (ops/pool_score.py pool_score_plain).
//
// Design. One thread per (job, pool position); a block's threads hold
// consecutive positions of one job, ascending docs, so the first probes of
// a search read the same posting for the whole warp (one broadcast load)
// and later probes spread out only as the docs do. Pad positions skip the
// search. No shared memory, no atomics: each thread owns its output.
//
// What bounds it. Memory latency: each (slot, term) search is 21 dependent
// random 4-byte reads (plus one for the match and one byte of weight) into
// a posting array far larger than L2 at 1M docs. The least bytes the work
// must move are the pools, their doc lengths, the term tables, one posting
// read per (slot, term) and the scores; the search reads ~22 times the
// posting bytes of that bound.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBsearchBits = 21;
constexpr float kK1 = 1.2f;
constexpr float kB = 0.75f;
constexpr float kDelta = 1.0f;

__global__ void __launch_bounds__(kThreads)
pool_score_kernel(const int* __restrict__ pool,
                  const bool* __restrict__ pool_valid,
                  const int* __restrict__ term_starts,
                  const int* __restrict__ term_lens,
                  const float* __restrict__ term_idf,
                  int n_jobs, int p_pad, int t_pad,
                  const int* __restrict__ docs, long long n_postings,
                  const uint8_t* __restrict__ weights,
                  const float* __restrict__ doc_lengths,
                  const float* __restrict__ avgdl_ptr,
                  float* __restrict__ out) {
  const long long i = static_cast<long long>(blockIdx.x) * kThreads +
                      threadIdx.x;
  if (i >= static_cast<long long>(n_jobs) * p_pad) return;
  if (!pool_valid[i]) {
    out[i] = 0.0f;
    return;
  }
  const int b = static_cast<int>(i / p_pad);
  const int doc = pool[i];
  float avgdl = *avgdl_ptr;
  if (avgdl < 1e-9f) avgdl = 1e-9f;
  float dl = __ldg(doc_lengths + doc);
  if (dl <= 0.0f) dl = 1.0f;
  const float norm =
      __fmul_rn(kK1, __fadd_rn(1.0f - kB, __fmul_rn(kB, __fdiv_rn(dl, avgdl))));
  const float k1p1 = kK1 + 1.0f;
  float score = 0.0f;
  for (int t = 0; t < t_pad; ++t) {
    const long long s = term_starts[b * t_pad + t];
    const int n = term_lens[b * t_pad + t];
    if (n <= 0) continue;  // no posting can match: the reference adds 0
    int lo = 0, hi = n;
    for (int step = 0; step < kBsearchBits; ++step) {
      const int mid = (lo + hi) >> 1;
      const long long at = min(s + mid, n_postings - 1);
      if (__ldg(docs + at) < doc) {
        lo = mid + 1;
      } else {
        hi = mid;
      }
    }
    const long long at = min(s + lo, n_postings - 1);
    if (lo < n && __ldg(docs + at) == doc) {
      const float tf = static_cast<float>(__ldg(weights + at));
      const float c = __fmul_rn(
          term_idf[b * t_pad + t],
          __fadd_rn(__fdiv_rn(__fmul_rn(tf, k1p1), __fadd_rn(tf, norm)),
                    kDelta));
      score = __fadd_rn(score, c);
    }
  }
  out[i] = score;
}

}  // namespace

extern "C" {

// Score n_jobs pools of p_pad slots over t_pad terms on `stream`; writes
// out[n_jobs * p_pad]. Returns cudaGetLastError() of the launch (0 on
// success).
int pool_score(const int* pool, const bool* pool_valid, const int* term_starts,
               const int* term_lens, const float* term_idf, int n_jobs,
               int p_pad, int t_pad, const int* docs, long long n_postings,
               const uint8_t* weights, const float* doc_lengths,
               const float* avgdl, float* out, void* stream) {
  const long long n = static_cast<long long>(n_jobs) * p_pad;
  if (n <= 0) return 0;
  const unsigned blocks = static_cast<unsigned>((n + kThreads - 1) / kThreads);
  pool_score_kernel<<<blocks, kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      pool, pool_valid, term_starts, term_lens, term_idf, n_jobs, p_pad, t_pad,
      docs, n_postings, weights, doc_lengths, avgdl, out);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
