// One (slot, candidate) of the coverage block's gather: the arithmetic of
// csrc/coverage_gather.cu, in a header of its own so that a host compiler
// can build the same code (the CPU tests compile it with g++, run it over
// every slot and candidate through the kernel's C interface, and hold the
// result to the plain PyTorch version, ops/coverage_kernel.py
// gather_block_plain; the CUDA kernel includes it unchanged).
//
// Slots: query token s < Q, fusion token s - Q < FQ, doc token s - Q - FQ
// < D, and last the candidate's scalars. A slot writes its column of each
// output it owns; a doc token's L chars (plain and reversed) are the first
// L of its word's row, 0 where the token is invalid (code -1, or at or
// past tok_count), and its length 0 there too.

#pragma once

#if defined(__CUDACC__)
#define GATH_HD __host__ __device__ __forceinline__
#else
#define GATH_HD inline
#endif

namespace gather {

struct Args {
  const int *word_chars, *word_chars_rev, *word_lens;   // [W, Lt], [W]
  int n_w, w_cols;
  const int *doc_tokens, *doc_tok_offsets;              // [N, Dt]
  const int* doc_tok_count;                             // [N]
  const unsigned char* doc_adj_ws;                      // [N, Dt]
  const int* doc_text_len;                              // [N]
  int n_docs, d_cols;
  const int *q_chars, *q_chars_rev;                     // [B, Q, L]
  const int *q_lens, *q_count, *q_sorted;               // [B, Q], [B], [B, Q]
  int n_b, n_q;
  const int *fq_chars, *fq_chars_rev, *fq_lens;         // [B, FQ, L], [B, FQ]
  int n_fq;
  const long long *text_ids, *qsel;                     // [C]
  int n_d, n_c;
  int *qc3, *qr3, *qlens2, *qcount, *qsorted2, *fqc3, *fqr3, *fqlens2;
  int *codes, *tok_count, *offsets;
  unsigned char* adj_ws;
  int* text_len;
  int *chars_t, *chars_rev_t, *lens;
  unsigned char* all_valid;
};

// The slots of a block: every query and fusion token, every doc token and
// the scalars.
GATH_HD int n_slots(const Args& a) { return a.n_q + a.n_fq + a.n_d + 1; }

// a query table's row of L chars (plain and reversed) down the rows of a
// [S, L, C] pair, at slot s
template <int L>
GATH_HD void chars_down(const int* src, const int* src_rev, int* dst,
                        int* dst_rev, int s, long long n_c, int c) {
  int v[L], r[L];
#pragma unroll
  for (int l = 0; l < L; ++l) {
    v[l] = src[l];
    r[l] = src_rev[l];
  }
#pragma unroll
  for (int l = 0; l < L; ++l) {
    const long long at = (static_cast<long long>(s) * L + l) * n_c + c;
    dst[at] = v[l];
    dst_rev[at] = r[l];
  }
}

// Slot `slot` of candidate c.
template <int L>
GATH_HD void slot_of(const Args& a, int slot, int c) {
  const long long n_c = a.n_c;
  if (slot < a.n_q) {                       // query token `slot`
    const long long row = a.qsel[c] * a.n_q + slot;
    chars_down<L>(a.q_chars + row * L, a.q_chars_rev + row * L, a.qc3, a.qr3,
                  slot, n_c, c);
    a.qlens2[slot * n_c + c] = a.q_lens[row];
    a.qsorted2[slot * n_c + c] = a.q_sorted[row];
    return;
  }
  slot -= a.n_q;
  if (slot < a.n_fq) {                      // fusion token `slot`
    const long long row = a.qsel[c] * a.n_fq + slot;
    chars_down<L>(a.fq_chars + row * L, a.fq_chars_rev + row * L, a.fqc3,
                  a.fqr3, slot, n_c, c);
    a.fqlens2[slot * n_c + c] = a.fq_lens[row];
    return;
  }
  slot -= a.n_fq;
  const long long n = a.text_ids[c];
  if (slot < a.n_d) {                       // doc token d
    const int d = slot;
    const long long at = d * n_c + c;
    const long long src = n * a.d_cols + d;
    const int code = a.doc_tokens[src];
    const bool valid = code >= 0 && d < a.doc_tok_count[n];
    a.codes[at] = code;
    a.offsets[at] = a.doc_tok_offsets[src];
    a.adj_ws[at] = a.doc_adj_ws[src];
    a.all_valid[at] = valid;
    a.lens[at] = valid ? a.word_lens[code] : 0;
    int v[L], r[L];
    const long long w = static_cast<long long>(valid ? code : 0) * a.w_cols;
#pragma unroll
    for (int l = 0; l < L; ++l) {
      v[l] = valid ? a.word_chars[w + l] : 0;
      r[l] = valid ? a.word_chars_rev[w + l] : 0;
    }
#pragma unroll
    for (int l = 0; l < L; ++l) {
      const long long to = (static_cast<long long>(l) * a.n_d + d) * n_c + c;
      a.chars_t[to] = v[l];
      a.chars_rev_t[to] = r[l];
    }
    return;
  }
  // the candidate's scalars
  a.qcount[c] = a.q_count[a.qsel[c]];
  a.tok_count[c] = a.doc_tok_count[n];
  a.text_len[c] = a.doc_text_len[n];
}

// The widths the kernel takes: n_l 12 or 24 and at most w_cols, n_d at
// most d_cols, and few enough slots for the grid's second axis.
GATH_HD bool widths_ok(const Args& a, int n_l) {
  return (n_l == 12 || n_l == 24) && n_l <= a.w_cols && a.n_d >= 1 &&
         a.n_d <= a.d_cols && a.n_q >= 0 && a.n_fq >= 0 &&
         n_slots(a) <= 65535;
}

}  // namespace gather

// The arguments of the C entry point coverage_gather, in its order (the
// kernel's and the host tests' alike).
#define GATHER_C_PARAMS                                                       \
  const int *word_chars, const int *word_chars_rev, const int *word_lens,     \
      int n_w, int w_cols, const int *doc_tokens, const int *doc_tok_offsets, \
      const int *doc_tok_count, const unsigned char *doc_adj_ws,              \
      const int *doc_text_len, int n_docs, int d_cols, const int *q_chars,    \
      const int *q_chars_rev, const int *q_lens, const int *q_count,          \
      const int *q_sorted, int n_b, int n_q, const int *fq_chars,             \
      const int *fq_chars_rev, const int *fq_lens, int n_fq,                  \
      const long long *text_ids, const long long *qsel, int n_l, int n_d,     \
      int n_c, int *qc3, int *qr3, int *qlens2, int *qcount, int *qsorted2,   \
      int *fqc3, int *fqr3, int *fqlens2, int *codes, int *tok_count,         \
      int *offsets, unsigned char *adj_ws, int *text_len, int *chars_t,       \
      int *chars_rev_t, int *lens, unsigned char *all_valid
#define GATHER_ARGS                                                           \
  gather::Args {                                                              \
    word_chars, word_chars_rev, word_lens, n_w, w_cols, doc_tokens,           \
        doc_tok_offsets, doc_tok_count, doc_adj_ws, doc_text_len, n_docs,     \
        d_cols, q_chars, q_chars_rev, q_lens, q_count, q_sorted, n_b, n_q,    \
        fq_chars, fq_chars_rev, fq_lens, n_fq, text_ids, qsel, n_d, n_c, qc3, \
        qr3, qlens2, qcount, qsorted2, fqc3, fqr3, fqlens2, codes, tok_count, \
        offsets, adj_ws, text_len, chars_t, chars_rev_t, lens, all_valid      \
  }
