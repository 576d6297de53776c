// Stage-1 lane expansion fused with the BM25+ scatter-add, for Hopper (sm_90a).
//
// Replaces the TPU kernel infidex_tpu/ops/stage1_lanes.py:_expand_call
// (the Pallas chunk-DMA lane expansion, reached through expand_lanes) and
// the scatter-adds that consume its output in
// infidex_tpu/index/device.py:_stage1_kernel_batch_chunked.
//
// What it computes. One launch handles the chunks of ONE term rank (the
// rank of a term is its position among its query's terms). Chunk c covers
// postings [off[c] + vstart[c], off[c] + vend[c]) of one query term; for
// every posting p in it:
//     key        = base[c] + docs[p]           (query * n_pad + doc)
//     contrib    = idf[c] * cfac[p]
//     scores[key] += contrib
//     cnt[key]    += 1          when contrib > 0
//
// Determinism. Within one rank no two lanes share a key: a term's postings
// are distinct documents and different queries own disjoint key ranges. So
// the update is a plain read-add-write with no atomics and no races, and
// since ranks run as successive launches on one stream, every score cell
// receives its terms' contributions in term order — exactly the serial
// lane order of the reference's scatter-add on the CPU. The products and
// sums use __fmul_rn / __fadd_rn so the compiler cannot contract them into
// an FMA: results are bit-equal to the plain PyTorch version.
//
// What bounds it. Memory bandwidth: 8 bytes of contiguous input per lane
// (docs int32 + cfac f32) plus a random read-modify-write of 8 bytes in
// each of scores and cnt. Nothing is computed beyond one multiply and two
// adds per lane. The design keeps the per-lane keys and contributions out
// of device memory entirely (the reference materialised both, 8 bytes a
// lane written and read again), and reads each chunk's slice with
// coalesced loads: neighbouring threads take neighbouring postings. The
// Pallas mechanics (1024-aligned DMA windows, double-buffered VMEM copies)
// have no counterpart here; the valid window only bounds the loop.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
stage1_scatter_lanes_kernel(const int* __restrict__ off,
                            const int* __restrict__ vstart,
                            const int* __restrict__ vend,
                            const float* __restrict__ idf,
                            const int* __restrict__ base,
                            const int* __restrict__ docs,
                            const float* __restrict__ cfac,
                            float* __restrict__ scores,
                            float* __restrict__ cnt) {
  const int c = blockIdx.x;
  const long long o = off[c];
  const int ve = vend[c];
  const int b = base[c];
  const float w = idf[c];
  for (int lane = vstart[c] + threadIdx.x; lane < ve; lane += kThreads) {
    const long long p = o + lane;
    const int key = b + __ldg(docs + p);
    const float contrib = __fmul_rn(w, __ldg(cfac + p));
    scores[key] = __fadd_rn(scores[key], contrib);
    if (contrib > 0.0f) cnt[key] = __fadd_rn(cnt[key], 1.0f);
  }
}

}  // namespace

extern "C" {

// Launch one rank pass over n_chunks chunk-table rows on `stream`.
// Returns cudaGetLastError() of the launch (0 on success).
int stage1_scatter_lanes(const int* off, const int* vstart, const int* vend,
                         const float* idf, const int* base, int n_chunks,
                         const int* docs, const float* cfac, float* scores,
                         float* cnt, void* stream) {
  if (n_chunks <= 0) return 0;
  stage1_scatter_lanes_kernel<<<n_chunks, kThreads, 0,
                                static_cast<cudaStream_t>(stream)>>>(
      off, vstart, vend, idf, base, docs, cfac, scores, cnt);
  return static_cast<int>(cudaGetLastError());
}

const char* stage1_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
