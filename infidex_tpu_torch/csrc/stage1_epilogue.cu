// The Stage-1 epilogue's one pass over [n_q, width], for Hopper (sm_90a).
//
// Replaces the rest of the fuzzy virtual-term block and the live mask of
// infidex_tpu/index/device.py:466 _stage1_kernel_batch_chunked
// (_fuzzy_block :415, its [n_q, n_grp] x [n_grp, n_pad] products
// :454-459; `scores * live_mask` :520; the row max of _coverage_class
// :194-199), which the port's plain version (index/device.py
// stage1_epilogue_plain) runs as some ten dense passes: a zeroed f32
// score and count matrix each, one index_add_ pass a group rank, the adds,
// the live multiplies and the max.
//
// What it computes (stage1_epilogue_cell.cuh): scores = (scores + fz) *
// live and cnt = cnt + fzcnt in place, fz the query's fuzzy groups'
// idf * doc_fac summed in group-rank order over the groups whose presence
// bit is set, and the row max of cnt * live. Bit for bit the plain
// version (__fadd_rn, __fmul_rn; the max an integer atomicMax of f32 bits
// that are not negative).
//
// Design. Blocks of 256 threads over (1024 docs, one query): each lane
// takes four docs, 256 apart, so that every load and store of a warp is
// one 128-byte line; a query's few groups and their presence words stay
// in L1. The row max is a warp max, a block max, and one atomicMax a
// block.
//
// What bounds it. Bytes: scores and cnt read and written once (16 B a
// cell with fuzzy groups, 12 without), the live mask and doc factors read
// once a row (L2).

#include <cuda_runtime.h>

#include "stage1_epilogue_cell.cuh"

namespace {

__global__ void __launch_bounds__(epi::kThreads)
stage1_epilogue_kernel(const epi::Args a) {
  __shared__ epi::Shared sh;
  epi::block(a, blockIdx.y, blockIdx.x, &sh);
}

}  // namespace

extern "C" {

// The pass over n_q rows of `width` cells on `stream` (epi::Args names
// the arrays; rowmax zero on entry). With has_fz, q_off has n_q + 1
// entries, q_grp the groups they point to (each below the bitset's rows
// and fidf's length), bits rows of `words` >= ceil(width / 32) words.
// Returns cudaGetLastError() of the launch (0 on success), or
// cudaErrorInvalidValue for more than 65535 rows.
int stage1_epilogue(float* scores, float* cnt, long long width, int n_q,
                    const float* live, const unsigned* bits, long long words,
                    const float* fidf, const float* doc_fac, const int* q_off,
                    const int* q_grp, int has_fz, int* rowmax, void* stream) {
  if (n_q <= 0 || width <= 0) return 0;
  if (n_q > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const epi::Args a{scores, cnt, width, n_q, live, bits, words, fidf,
                    doc_fac, q_off, q_grp, has_fz, rowmax};
  const dim3 grid(static_cast<unsigned>((width + epi::kDocs - 1) / epi::kDocs),
                  static_cast<unsigned>(n_q));
  stage1_epilogue_kernel<<<grid, epi::kThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
