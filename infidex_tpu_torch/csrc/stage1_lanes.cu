// Stage-1 lane expansion fused with the BM25+ scatter-add, for Hopper (sm_90a).
//
// Replaces the TPU kernel infidex_tpu/ops/stage1_lanes.py:_expand_call
// (the Pallas chunk-DMA lane expansion, reached through expand_lanes) and
// the scatter-adds that consume its output in
// infidex_tpu/index/device.py:_stage1_kernel_batch_chunked.
//
// What it computes. The chunk table is query-major: rows
// [qstart[q], qstart[q+1]) are query q's chunks, its terms in rank order
// (rank[c] is the row's term rank). Chunk c covers postings
// [off[c] + vstart[c], off[c] + vend[c]) of one query term; for every
// posting p in it whose doc lies in the doc window [doc_lo, doc_hi):
//     key        = base[c] + (docs[p] - doc_lo)   (query * width + local doc)
//     contrib    = idf[c] * cfac[p]
//     scores[key] += contrib
//     cnt[key]    += 1          when contrib > 0
// Postings outside the window are skipped. An unsharded index passes the
// whole doc axis (0, n_pad), base = query * n_pad; a document shard of a
// sharded index (parallel/sharding.py) passes its own range, base =
// query * shard_size, and every shard walks the same chunk table, as the
// reference's shard_map program expands the same lanes on every device
// and scatters only its own docs (infidex_tpu/parallel/sharding.py:178).
//
// Determinism. A query's keys lie in its own range [q*n_pad, (q+1)*n_pad),
// and within one term no two lanes share a key (a term's postings are
// distinct documents). Block q owns query q's range: it walks the query's
// chunks in order, all threads on one chunk at a time, and puts a
// __syncthreads() between two rows of different rank. So each update is a
// plain read-add-write with no atomics, and every score cell receives its
// terms' contributions in rank order, exactly the serial lane order of the
// reference's scatter-add on the CPU. The products and sums use __fmul_rn
// / __fadd_rn so the compiler cannot contract them into an FMA: results
// are bit-equal to the plain PyTorch version.
//
// What bounds it. Memory: each lane reads 8 contiguous bytes (docs int32,
// cfac f32), and each touched cell of scores and cnt is read and written
// once: 38.5 MB for a 128-query group of 1.95M lanes and 1.43M cells,
// ~11.5 us at 3.35 TB/s. Nothing is computed beyond one multiply and two
// adds. In practice each random 4-byte read-modify-write moves a 32-byte
// sector each way in a 1 GiB matrix that L2 cannot hold, and a rank's
// reads must return before its writes and the barrier, so the random
// access rate, not the byte count, sets the time. The first design launched once per term rank (16 launches a
// group), each a grid of one 256-thread block per 2048-lane chunk: ~60
// blocks a launch, ~6% of the card's warp slots, so every dependent random
// read-modify-write waited on memory latency with little else in flight.
// This design makes ONE launch per group, one 1024-thread block per query
// (a query has at most 16 terms of at most 2048 champion-clipped lanes), so
// a 128-query group fills one wave of the 132 SMs at ~50% of the warp
// slots; each thread takes two lanes of a chunk at a time and issues both
// lanes' loads before either store, so two random reads are in flight per
// thread. The keys and contributions never reach device memory (the
// reference materialised both). The Pallas mechanics (1024-aligned DMA
// windows, double-buffered VMEM copies) have no counterpart here; the
// valid window only bounds the loop.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 1024;

__global__ void __launch_bounds__(kThreads)
stage1_scatter_lanes_kernel(const int* __restrict__ qstart,
                            const int* __restrict__ off,
                            const int* __restrict__ vstart,
                            const int* __restrict__ vend,
                            const float* __restrict__ idf,
                            const int* __restrict__ base,
                            const int* __restrict__ rank,
                            const int* __restrict__ docs,
                            const float* __restrict__ cfac,
                            int doc_lo, int doc_hi,
                            float* __restrict__ scores,
                            float* __restrict__ cnt) {
  const int c0 = qstart[blockIdx.x];
  const int c1 = qstart[blockIdx.x + 1];
  for (int c = c0; c < c1; ++c) {
    // the previous term's updates are visible before this term reads
    // (uniform condition: every thread walks the same rows)
    if (c > c0 && rank[c] != rank[c - 1]) __syncthreads();
    const long long o = off[c];
    const int ve = vend[c];
    const int b = base[c] - doc_lo;
    const float w = idf[c];
    for (int lane = vstart[c] + threadIdx.x; lane < ve;
         lane += 2 * kThreads) {
      // two lanes of one term: distinct keys, so both loads go first
      const int lane2 = lane + kThreads;
      const int doc = __ldg(docs + o + lane);
      const bool one = doc >= doc_lo && doc < doc_hi;
      const int key = b + doc;
      const float add = __fmul_rn(w, __ldg(cfac + o + lane));
      int key2 = key;
      float add2 = 0.0f;
      bool two = false;
      if (lane2 < ve) {
        const int doc2 = __ldg(docs + o + lane2);
        two = doc2 >= doc_lo && doc2 < doc_hi;
        key2 = b + doc2;
        add2 = __fmul_rn(w, __ldg(cfac + o + lane2));
      }
      float s = 0.0f, n = 0.0f, s2 = 0.0f, n2 = 0.0f;
      if (one) {
        s = scores[key];
        n = cnt[key];
      }
      if (two) {
        s2 = scores[key2];
        n2 = cnt[key2];
      }
      if (one) {
        scores[key] = __fadd_rn(s, add);
        if (add > 0.0f) cnt[key] = __fadd_rn(n, 1.0f);
      }
      if (two) {
        scores[key2] = __fadd_rn(s2, add2);
        if (add2 > 0.0f) cnt[key2] = __fadd_rn(n2, 1.0f);
      }
    }
  }
}

}  // namespace

extern "C" {

// Launch the scatter of a query-major chunk table of n_q queries over the
// doc window [doc_lo, doc_hi) on `stream`: one block per query. Returns
// cudaGetLastError() of the launch (0 on success).
int stage1_scatter_lanes(const int* qstart, const int* off, const int* vstart,
                         const int* vend, const float* idf, const int* base,
                         const int* rank, int n_q, const int* docs,
                         const float* cfac, int doc_lo, int doc_hi,
                         float* scores, float* cnt, void* stream) {
  if (n_q <= 0) return 0;
  stage1_scatter_lanes_kernel<<<n_q, kThreads, 0,
                                static_cast<cudaStream_t>(stream)>>>(
      qstart, off, vstart, vend, idf, base, rank, docs, cfac, doc_lo, doc_hi,
      scores, cnt);
  return static_cast<int>(cudaGetLastError());
}

const char* stage1_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
