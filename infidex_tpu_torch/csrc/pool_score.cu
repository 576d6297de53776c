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
// doc-sorted, duplicate-free posting range [term_starts[b,t],
// +term_lens[b,t]) inside the FULL base CSR (no champion clipping) with
// its idf. For every (b, p):
//     norm  = K1 * ((1 - B) + B * (dl / avgdl))    dl = doc_lengths[doc], 1 if <= 0
//     score = sum over t, in term order, where the doc carries term t:
//             idf * ((tf * (K1 + 1)) / (tf + norm) + DELTA)
// tf is the posting's uint8 weight. Every product, quotient and sum is
// written with __fmul_rn / __fdiv_rn / __fadd_rn in the reference's
// operation order, so the compiler can neither contract nor reorder them:
// the scores are bit-equal to the host scorer (index/candidates.py
// score_pool and its native twin in native/_lib.cpp) and to the plain
// PyTorch version (ops/pool_score.py pool_score_plain).
//
// The search. The reference finds the doc by a binary search of exactly 21
// steps, which reaches the range's lower bound for ranges of fewer than
// 2^21 postings. The lower bound in a sorted duplicate-free range is
// unique, so any exact search gives the same posting and the same tf; the
// searches here run until they converge, for a range of any length (the
// plain version takes as many steps as its longest range needs, never
// fewer than 21, so the two agree there too).
//
// Design. One block per (job, tile of kThreads consecutive pool slots),
// one thread per slot; each thread owns its slot's score and adds the
// terms in order. The first design (one thread per slot, 21 dependent
// 4-byte probes per term into a posting array far larger than L2) was
// bound by memory latency. Here a tile does, per group of kTermGroup
// terms:
//   1. the doc span [first, last] of the tile's VALID slots (pad slots
//      carry no doc and do not widen it; a tile without a valid slot
//      writes zeros and ends);
//   2. two searches per term, all terms at once, each by kLanes
//      neighbouring threads that probe kLanes evenly spaced postings a
//      step (the range shrinks kLanes + 1 times a step, not 2 times): the
//      term's range narrowed to [lower_bound(first), upper_bound(last)),
//      the only postings a doc of this tile can match. Terms whose
//      narrowed range is empty drop out;
//   3. per slot, the posting of each remaining term: where the narrowed
//      range fits a buffer (kCap postings), it is copied (docs, and the
//      uint8 weights as aligned 4-byte words) into shared memory by
//      coalesced cp.async loads, double-buffered, the copy of the next
//      term in flight while every thread searches the current one in
//      shared memory. A longer narrowed range is searched in global
//      memory inside its narrowed bounds, kIlp terms in lock step, so
//      that a thread has kIlp independent loads in flight where the first
//      design waited for one;
//   4. the matches' contributions added in term order (the matches are
//      kept as a bit mask and packed weights in registers until then).
// No atomics: the result does not depend on the schedule.
//
// What bounds it. Bytes, in 32-byte sectors. The least bytes the work
// must move count one 4-byte posting per (slot, term). But a term is
// usually much denser than the pool: on the tier jobs of a 1M-doc index a
// tile's narrowed range holds about ten postings per slot
// (scripts/kernel_ab.py reports the ranges), so a per-slot search ends in
// a sector of its own for nearly every slot and touches about every
// sector of the range, and the copy reads every sector of it by
// construction: either way the range's postings cross the memory bus
// once, ten times the bytes of that bound. Step 3 takes most of the
// kernel's time whichever way a range is read; kCap sits between the
// two (copying suits short ranges, searching long ones, and larger
// buffers cost resident blocks).

#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;    // slots of a tile, one per thread
constexpr int kTermGroup = 32;   // terms narrowed together: one 32-bit mask
constexpr int kCap = 2048;       // postings of a range that a buffer holds
constexpr int kIlp = 4;          // global searches a thread runs in lock step
// threads that share one narrowing search (two searches per term)
constexpr int kLanes = kThreads / (2 * kTermGroup);
static_assert(kLanes * 2 * kTermGroup == kThreads && 32 % kLanes == 0,
              "a narrowing search's threads lie in one warp");
constexpr float kK1 = 1.2f;
constexpr float kB = 0.75f;
constexpr float kDelta = 1.0f;

// first index in a[0:n) whose value is >= key
__device__ __forceinline__ int lower_bound(const int* a, int n, int key) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (a[mid] < key) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return lo;
}

__global__ void __launch_bounds__(kThreads)
pool_score_kernel(const int* __restrict__ pool,
                  const bool* __restrict__ pool_valid,
                  const int* __restrict__ term_starts,
                  const int* __restrict__ term_lens,
                  const float* __restrict__ term_idf,
                  int tiles, int p_pad, int t_pad,
                  const int* __restrict__ docs, long long n_postings,
                  const uint8_t* __restrict__ weights,
                  const float* __restrict__ doc_lengths,
                  const float* __restrict__ avgdl_ptr,
                  float* __restrict__ out) {
  __shared__ int s_docs[2][kCap];
  __shared__ uint32_t s_wts[2][kCap / 4 + 2];
  __shared__ long long s_start[kTermGroup];   // a term's range start
  __shared__ int s_bound[2 * kTermGroup];     // its narrowed [lo, hi)
  __shared__ long long s_at[kTermGroup];      // live terms: absolute start,
  __shared__ int s_len[kTermGroup];           //   length
  __shared__ int s_term[kTermGroup];          //   and term slot, in order
  __shared__ int s_staged[kTermGroup];        // the live terms that fit a
  __shared__ int s_long[kTermGroup];          //   buffer, and the others
  __shared__ int s_live, s_n_staged, s_n_long;
  __shared__ int s_red[2][kThreads / 32];
  __shared__ int s_span[2];

  const int tid = threadIdx.x;
  const int b = blockIdx.x / tiles;
  const int slot = (blockIdx.x % tiles) * kThreads + tid;
  const bool inside = slot < p_pad;
  const long long i = static_cast<long long>(b) * p_pad + slot;
  const bool valid = inside && pool_valid[i];
  const int doc = valid ? pool[i] : 0;

  if (!__syncthreads_or(valid)) {  // no valid slot in the tile
    if (inside) out[i] = 0.0f;
    return;
  }
  // 1. the doc span of the tile's valid slots
  int dmin = valid ? doc : INT_MAX;
  int dmax = valid ? doc : -1;
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) {
    dmin = min(dmin, __shfl_xor_sync(0xffffffffu, dmin, d));
    dmax = max(dmax, __shfl_xor_sync(0xffffffffu, dmax, d));
  }
  if ((tid & 31) == 0) {
    s_red[0][tid >> 5] = dmin;
    s_red[1][tid >> 5] = dmax;
  }
  __syncthreads();
  if (tid == 0) {
    int lo = INT_MAX, hi = -1;
    for (int w = 0; w < kThreads / 32; ++w) {
      lo = min(lo, s_red[0][w]);
      hi = max(hi, s_red[1][w]);
    }
    s_span[0] = lo;
    s_span[1] = hi;
  }
  __syncthreads();
  const int first = s_span[0], last = s_span[1];

  float norm = 0.0f;
  if (valid) {
    float avgdl = *avgdl_ptr;
    if (avgdl < 1e-9f) avgdl = 1e-9f;
    float dl = __ldg(doc_lengths + doc);
    if (dl <= 0.0f) dl = 1.0f;
    norm = __fmul_rn(
        kK1, __fadd_rn(1.0f - kB, __fmul_rn(kB, __fdiv_rn(dl, avgdl))));
  }
  const float k1p1 = kK1 + 1.0f;
  float score = 0.0f;
  const int* job_starts = term_starts + static_cast<long long>(b) * t_pad;
  const int* job_lens = term_lens + static_cast<long long>(b) * t_pad;
  const float* job_idf = term_idf + static_cast<long long>(b) * t_pad;
  uint8_t(*wts_bytes)[sizeof(s_wts[0])] =
      reinterpret_cast<uint8_t(*)[sizeof(s_wts[0])]>(s_wts);

  // the copy of live term `a` of the group into buffer `buf`, as one
  // cp.async group
  auto stage = [&](int a, int buf) {
    const int len = s_len[a];
    const long long at = s_at[a];
    for (int e = tid; e < len; e += kThreads) {
      __pipeline_memcpy_async(&s_docs[buf][e], docs + at + e, 4);
    }
    // weights as aligned 4-byte words from the word that holds `at`
    const long long word0 = at & ~3LL;
    const int n_words = (static_cast<int>(at - word0) + len + 3) >> 2;
    for (int w = tid; w < n_words; w += kThreads) {
      const long long g = word0 + 4LL * w;
      if (g + 4 <= n_postings) {
        __pipeline_memcpy_async(&s_wts[buf][w], weights + g, 4);
      } else {  // the array's last, partial word
        for (int e = 0; g + e < n_postings; ++e) {
          wts_bytes[buf][4 * w + e] = weights[g + e];
        }
      }
    }
    __pipeline_commit();
  };

  for (int g0 = 0; g0 < t_pad; g0 += kTermGroup) {
    const int g_n = min(kTermGroup, t_pad - g0);
    // 2. narrow every term of the group to the tile's doc span: search
    // 2k is term k's lower bound of `first`, 2k + 1 its upper bound of
    // `last`, each by kLanes threads of one warp
    {
      const int search = tid / kLanes, gl = tid % kLanes;
      const int lane0 = (tid & 31) - gl;
      const int k = search >> 1;
      const bool upper = search & 1;
      const int key = upper ? last : first;
      long long s = 0, n = 0;
      if (k < g_n) {
        s = job_starts[g0 + k];
        n = job_lens[g0 + k];
        // a range is inside the CSR; never read past the array
        if (s < 0 || s >= n_postings) n = 0;
        n = max(0LL, min(n, n_postings - s));
      }
      // invariant: every posting before lo is below the bound, every one
      // from hi on is not
      int lo = 0, hi = static_cast<int>(n);
      while (__any_sync(0xffffffffu, hi > lo)) {
        const int len = hi - lo;
        const int stride = (len + kLanes) / (kLanes + 1);
        const int idx = lo + (gl + 1) * stride - 1;
        bool below = false;
        if (len > 0 && idx < hi) {
          const int v = __ldg(docs + s + idx);
          below = upper ? v <= key : v < key;
        }
        const unsigned votes = __ballot_sync(0xffffffffu, below);
        const int c = __popc((votes >> lane0) & ((1u << kLanes) - 1u));
        if (len > 0) {
          if (c < kLanes) hi = min(lo + (c + 1) * stride - 1, hi);
          lo += c * stride;
        }
      }
      if (gl == 0 && k < g_n) {
        s_bound[search] = lo;
        if (!upper) s_start[k] = s;
      }
    }
    __syncthreads();
    if (tid == 0) {
      int n_live = 0, n_staged = 0, n_long = 0;
      for (int k = 0; k < g_n; ++k) {
        const int lo = s_bound[2 * k], hi = s_bound[2 * k + 1];
        if (hi > lo) {
          s_at[n_live] = s_start[k] + lo;
          s_len[n_live] = hi - lo;
          s_term[n_live] = g0 + k;
          if (hi - lo <= kCap) {
            s_staged[n_staged++] = n_live;
          } else {
            s_long[n_long++] = n_live;
          }
          ++n_live;
        }
      }
      s_live = n_live;
      s_n_staged = n_staged;
      s_n_long = n_long;
    }
    __syncthreads();
    const int n_live = s_live, n_staged = s_n_staged, n_long = s_n_long;

    // this slot's matches among the group's live terms: bit a of `hits`,
    // and the posting's weight in byte a of `tfs`
    unsigned hits = 0u;
    unsigned tfs[kTermGroup / 4];
#pragma unroll
    for (int r = 0; r < kTermGroup / 4; ++r) tfs[r] = 0u;
    auto note_hit = [&](int a, unsigned weight) {
      hits |= 1u << a;
#pragma unroll
      for (int r = 0; r < kTermGroup / 4; ++r) {
        if (r == (a >> 2)) tfs[r] |= weight << ((a & 3) * 8);
      }
    };

    // the first buffered range's copy flies during the global searches
    if (n_staged > 0) stage(s_staged[0], 0);

    // 3a. the long narrowed ranges, in global memory, kIlp in lock step
    if (valid) {
      for (int j0 = 0; j0 < n_long; j0 += kIlp) {
        const int* base[kIlp];
        int lo[kIlp], hi[kIlp];
#pragma unroll
        for (int j = 0; j < kIlp; ++j) {
          const bool on = j0 + j < n_long;
          const int a = on ? s_long[j0 + j] : 0;
          base[j] = docs + s_at[a];
          lo[j] = 0;
          hi[j] = on ? s_len[a] : 0;
        }
        bool more = true;
        while (more) {
          int v[kIlp];
#pragma unroll
          for (int j = 0; j < kIlp; ++j) {
            v[j] = lo[j] < hi[j] ? __ldg(base[j] + ((lo[j] + hi[j]) >> 1)) : 0;
          }
          more = false;
#pragma unroll
          for (int j = 0; j < kIlp; ++j) {
            if (lo[j] < hi[j]) {
              const int mid = (lo[j] + hi[j]) >> 1;
              if (v[j] < doc) {
                lo[j] = mid + 1;
              } else {
                hi[j] = mid;
              }
              more = more || lo[j] < hi[j];
            }
          }
        }
#pragma unroll
        for (int j = 0; j < kIlp; ++j) {
          if (j0 + j < n_long) {
            const int a = s_long[j0 + j];
            if (lo[j] < s_len[a] && __ldg(base[j] + lo[j]) == doc) {
              note_hit(a, __ldg(weights + s_at[a] + lo[j]));
            }
          }
        }
      }
    }

    // 3b. the ranges that fit a buffer, the next one's copy in flight
    for (int j = 0; j < n_staged; ++j) {
      const int buf = j & 1;
      if (j + 1 < n_staged) {
        stage(s_staged[j + 1], buf ^ 1);
      } else {
        __pipeline_commit();  // an empty group keeps the count even
      }
      __pipeline_wait_prior(1);  // this thread's copies of the term landed
      __syncthreads();           // and every other thread's
      if (valid) {
        const int a = s_staged[j];
        const int len = s_len[a];
        const int pos = lower_bound(s_docs[buf], len, doc);
        if (pos < len && s_docs[buf][pos] == doc) {
          note_hit(a, wts_bytes[buf][static_cast<int>(s_at[a] & 3LL) + pos]);
        }
      }
      __syncthreads();  // the buffer is free for the term after next
    }

    // 4. the contributions, in term order
    for (int a = 0; a < n_live; ++a) {
      if ((hits >> a) & 1u) {
        unsigned word = 0u;
#pragma unroll
        for (int r = 0; r < kTermGroup / 4; ++r) {
          if (r == (a >> 2)) word = tfs[r];
        }
        const float tf = static_cast<float>((word >> ((a & 3) * 8)) & 255u);
        const float c = __fmul_rn(
            job_idf[s_term[a]],
            __fadd_rn(__fdiv_rn(__fmul_rn(tf, k1p1), __fadd_rn(tf, norm)),
                      kDelta));
        score = __fadd_rn(score, c);
      }
    }
  }
  if (inside) out[i] = valid ? score : 0.0f;
}

}  // namespace

extern "C" {

// Score n_jobs pools of p_pad slots over t_pad terms on `stream`; writes
// out[n_jobs * p_pad]. `weights` must be 4-byte aligned. Returns
// cudaGetLastError() of the launch (0 on success).
int pool_score(const int* pool, const bool* pool_valid, const int* term_starts,
               const int* term_lens, const float* term_idf, int n_jobs,
               int p_pad, int t_pad, const int* docs, long long n_postings,
               const uint8_t* weights, const float* doc_lengths,
               const float* avgdl, float* out, void* stream) {
  if (n_jobs <= 0 || p_pad <= 0) return 0;
  const int tiles = (p_pad + kThreads - 1) / kThreads;
  const long long blocks = static_cast<long long>(n_jobs) * tiles;
  if (blocks > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  pool_score_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      pool, pool_valid, term_starts, term_lens, term_idf, tiles, p_pad, t_pad,
      docs, n_postings, weights, doc_lengths, avgdl, out);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
