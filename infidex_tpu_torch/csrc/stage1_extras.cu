// A single query's fuzzy extra postings added to its score row, for Hopper
// (sm_90a).
//
// Replaces the fuzzy virtual-term block of the single-query Stage 1,
// infidex_tpu/index/device.py:250 _stage1_kernel (:302-308: each explicit
// extra posting's BM25+ contribution at tf = 1, extra_idf * ((K1 + 1) /
// (1 + norm) + DELTA), scatter-added into the dense score row after the
// term lanes), which the port's plain version (index/device.py
// stage1_extras_plain) runs as one index_add_ an occurrence rank (a doc's
// first extras, then its second ones, ...).
//
// What it computes (stage1_extras_cell.cuh): for each extra posting, in
// array order within each doc, scores[doc] += idf * doc_fac[doc], doc_fac
// the index's per-doc factor at tf = 1 (index/device.py
// fuzzy_doc_factor). The same doc may come several times (a caller's
// groups overlap), so the adds of one doc are a sequence, not a sum in
// any order: __fmul_rn and __fadd_rn in the plain version's order, bit for
// bit.
//
// Design. The host lists the extras doc-major with a stable sort (numpy,
// index/device.py extras_table): the distinct docs ascending, the first
// extra of each, the idfs in that order. One thread a distinct doc reads
// its cell once, adds its extras and writes it once; no cell has two
// writers, so there are no float atomics. Consecutive threads take
// consecutive docs and consecutive idfs: the table's reads are coalesced,
// and the cells and factors of close docs share sectors.
//
// What bounds it. Bytes: per extra its idf (4 B; the doc-major table in
// place of the extras' docs, which the host reads), per distinct doc its
// id and offset (8 B), its factor (4 B) and its cell read and written
// (8 B). A query's extras are the docs of its typo tokens' matched terms:
// a few MB at the most, under a microsecond at 3.35 TB/s, so one launch's
// latency sets the time.

#include <cuda_runtime.h>

#include "stage1_extras_cell.cuh"

namespace {

__global__ void __launch_bounds__(extras::kThreads)
stage1_extras_kernel(const extras::Args a) {
  extras::block(a, blockIdx.x);
}

}  // namespace

extern "C" {

// The extras of n_docs distinct docs added to `scores` on `stream`
// (extras::Args names the arrays: docs distinct and each inside scores,
// off[0] = 0, off rising). Returns cudaGetLastError() of the launch (0 on
// success; no launch without docs).
int stage1_extras(float* scores, const int* docs, const int* off,
                  const float* idf, const float* doc_fac, int n_docs,
                  void* stream) {
  if (n_docs <= 0) return 0;
  const extras::Args a{scores, docs, off, idf, doc_fac, n_docs};
  const unsigned blocks = static_cast<unsigned>(
      (n_docs + extras::kThreads - 1) / extras::kThreads);
  stage1_extras_kernel<<<blocks, extras::kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
