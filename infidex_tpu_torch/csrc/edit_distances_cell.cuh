// One (query token, doc token, candidate) cell of the Stage-2 pair words:
// the arithmetic of csrc/coverage_pairs.cu (the five edit distances, then
// further down the word relations packed beside them), in a header of its
// own so that a host compiler can build the same code (the CPU tests
// compile it with g++ and hold it against the plain PyTorch version; the
// CUDA kernel includes it unchanged).
//
// distances<L, LIVE> computes, for one query word q (ql chars, reversed copy qr)
// and one doc word d (dl chars, reversed copy dr), both zero-padded to L
// chars, what ops/editdistance_multi.py coverage_distances_plain computes
// for that cell, bit for bit:
//
//   out[0] dam1  = rescue(min(lev3, 3), dl, max_distance 1)
//   out[1] dam2  = rescue(lev3, dl, max_distance 2, reversed suffix run)
//   out[2..4] pdam1..3 = rescue(levp[w], dlw, max_distance 1) for the
//       three prefix windows dlw = min(dl, ql), min(dl, ql + 1),
//       min(dl, max(ql - 1, 0))
//
// lev3 = min(lev(q, d), 4) from a banded sweep of half-width 3; levp[w] =
// min(lev(q, d[:dlw]), 3) from a sweep of half-width 2. The plain version
// freezes a sweep's row once j >= d_len, so the three windows are three
// snapshots of ONE sweep over d, each read at its own band offset: two
// sweeps a cell, not four. A sweep stops at the longest d_len it serves.
//
// The transposition rescue is the reference's approximate one, reproduced
// as it is (first mismatch p inside the scan range, a swap at p, then the
// rest compared by aligned prefix and reversed suffix run). The plain
// version builds [Q, L, D, C] equality tensors and reduces them; here the
// L <= 24 positions of a cell are four bit masks in registers (mismatch,
// the two one-shifted equalities, reversed mismatch) and every "first
// true" is a find-first-set over a masked range.

#pragma once

#if defined(__CUDACC__)
#define EDIT_HD __host__ __device__ __forceinline__
#else
#define EDIT_HD inline
#endif

namespace edit {

EDIT_HD int imin(int a, int b) { return a < b ? a : b; }
EDIT_HD int imax(int a, int b) { return a > b ? a : b; }
EDIT_HD int iabs(int a) { return a < 0 ? -a : a; }

// index of the lowest set bit of a non-zero mask
EDIT_HD int first_bit(unsigned m) {
#if defined(__CUDA_ARCH__)
  return __ffs(static_cast<int>(m)) - 1;
#else
  return __builtin_ctz(m);
#endif
}

// bits [0, n) set, n clipped to [0, len] (len <= 31)
EDIT_HD unsigned low_bits(int n, int len) {
  n = imax(0, imin(n, len));
  return (1u << n) - 1u;
}

// row[of], or big where of lies outside the band (the plain version's
// one-hot select over the band followed by a min with big)
template <int W>
EDIT_HD int band_pick(const int (&row)[W], int of, int big) {
  int r = big;
#pragma unroll
  for (int o = 0; o < W; ++o) {
    if (o == of) r = row[o];
  }
  return r;
}

// Banded Levenshtein sweep of half-width B over d, read out for NW
// values of d_len (each a prefix window of d): dist[w] =
// min(lev(q, d[:dlen[w]]), B + 1), with the plain version's init, its
// i == 0 clamp, its validity mask 0 <= i <= ql and its overrides for
// empty words.
template <int L, int B, int NW, bool LIVE = true>
EDIT_HD void band_sweep(const int (&q)[L], const int (&d)[L], int ql,
                        const int (&dlen)[NW], int (&dist)[NW]) {
  constexpr int W = 2 * B + 1;
  constexpr int BIG = B + 1;
  int row[W];
#pragma unroll
  for (int o = 0; o < W; ++o) row[o] = o >= B ? o - B : B + 2;
  int of[NW];
  int dmax = 0;
#pragma unroll
  for (int w = 0; w < NW; ++w) {
    of[w] = ql - dlen[w] + B;
    dmax = imax(dmax, dlen[w]);
    dist[w] = band_pick<W>(row, of[w], BIG);  // stands where dlen[w] == 0
  }
  // an empty word's distance is overridden below: skip its sweep
  if (LIVE && ql > 0 && dmax > 0) {
#pragma unroll
    for (int j = 0; j < L; ++j) {
      if (j < dmax) {
        int nr[W];
#pragma unroll
        for (int o = 0; o < W; ++o) {
          const int off = o - B;
          const int qi = j + off < 0 ? 0 : (j + off > L - 1 ? L - 1 : j + off);
          const int diag = row[o] + (q[qi] != d[j] ? 1 : 0);
          const int up = (o + 1 < W ? row[o + 1] : BIG + 1) + 1;
          int base = imin(diag, up);
          if (j + 1 + off == 0) base = imin(base, j + 1);
          nr[o] = base;
        }
#pragma unroll
        for (int o = 1; o < W; ++o) nr[o] = imin(nr[o], nr[o - 1] + 1);
#pragma unroll
        for (int o = 0; o < W; ++o) {
          const int i_here = j + 1 + (o - B);
          const bool iv = i_here >= 0 && i_here <= ql;
          row[o] = imin(iv ? nr[o] : BIG + 1, BIG + 1);
        }
#pragma unroll
        for (int w = 0; w < NW; ++w) {
          // the row a window froze at: after dlen[w] chars, or after all
          // L where the word is longer than the table
          if (j + 1 == dlen[w] || (j + 1 == L && dlen[w] > L)) {
            dist[w] = band_pick<W>(row, of[w], BIG);
          }
        }
      }
    }
  }
#pragma unroll
  for (int w = 0; w < NW; ++w) {
    int v = dist[w];
    if (ql == 0) v = dlen[w];
    if (dlen[w] == 0) v = ql;
    dist[w] = imin(v, BIG);
  }
}

// The four position masks of a cell: bit l of
//   neq  : q[l] != d[l]
//   qd1  : q[l] == d[l + 1]   (d[L] = 0)
//   q1d  : q[l + 1] == d[l]   (q[L] = 0)
//   rneq : qr[l] != dr[l]
struct Masks {
  unsigned neq, qd1, q1d, rneq;
};

// damerau_rescue of the plain version for one cell. MD is max_distance
// (1, or 2 with the reversed suffix run).
template <int L, int MD>
EDIT_HD int rescue(int dist, int ql, int dlen, const Masks& m) {
  const int no = MD + 1;
  const bool len_ok = iabs(dlen - ql) <= MD;
  const unsigned mism = m.neq & low_bits(imin(ql - 1, dlen), L);
  const bool has_mism = mism != 0u;
  const int p = has_mism ? first_bit(mism) : 0;
  const bool swap_fixes =
      (p + 1 < dlen) && (((m.qd1 >> p) & (m.q1d >> p) & 1u) != 0u);
  const int rest_q = imax(ql - (p + 2), 0);
  const int rest_d = imax(dlen - (p + 2), 0);
  const int rest_short = imin(rest_q, rest_d);
  const int rest_diff = iabs(rest_q - rest_d);
  const unsigned wm =
      m.neq & ~low_bits(p + 2, L) & low_bits(p + 2 + rest_short, L);
  const int aligned = wm != 0u ? first_bit(wm) - (p + 2) : rest_short;
  const bool rest_equal = rest_diff == 0 && aligned >= rest_short;
  int rest_dist;
  bool rescue_ok;
  if (MD == 1) {
    rest_dist = rest_equal ? 0 : 1;
    rescue_ok = swap_fixes && rest_equal;
  } else {
    const int shorter = imin(ql, dlen);
    const unsigned rm = m.rneq & low_bits(shorter, L);
    int suffix = rm != 0u ? first_bit(rm) : shorter;
    suffix = imin(suffix, rest_short);
    const bool lev1 = rest_diff == 0
                          ? aligned + suffix >= rest_short - 1
                          : (rest_diff == 1 && aligned + suffix >= rest_short);
    rest_dist = rest_equal ? 0 : (lev1 ? 1 : MD);
    rescue_ok = swap_fixes && rest_dist <= MD - 1;
  }
  const bool use = dist > MD && dist <= MD + 1 && has_mism && rescue_ok;
  const int result = use ? 1 + rest_dist : dist;
  return len_ok ? result : no;
}

// Reads one cell's words: q[l] = qc[l * q_stride], qr likewise; d[l] =
// dc[l * d_stride], dr likewise (the tensors keep the candidate axis minor,
// so a cell's chars are strided), and builds the four position masks. A
// cell with an empty word (LIVE false) reads no chars: its sweeps are
// skipped, and every reader of a mask looks at no bit of it or is gated by
// a comparison of the two lengths that fails. LIVE is a template argument
// so that the compiler folds such a cell's zero words and masks away.
template <int L, bool LIVE>
EDIT_HD void load_words(const int* qc, const int* qr, long long q_stride,
                        const int* dc, const int* dr, long long d_stride,
                        int (&q)[L], int (&d)[L], Masks& m) {
  static_assert(L >= 1 && L <= 31, "a cell's positions must fit a 32-bit mask");
  m = {0u, 0u, 0u, 0u};
#pragma unroll
  for (int l = 0; l < L; ++l) {
    q[l] = LIVE ? qc[l * q_stride] : 0;
    d[l] = LIVE ? dc[l * d_stride] : 0;
  }
  if (LIVE) {
#pragma unroll
    for (int l = 0; l < L; ++l) {
      const int d_next = l + 1 < L ? d[l + 1] : 0;
      const int q_next = l + 1 < L ? q[l + 1] : 0;
      m.neq |= (q[l] != d[l] ? 1u : 0u) << l;
      m.qd1 |= (q[l] == d_next ? 1u : 0u) << l;
      m.q1d |= (q_next == d[l] ? 1u : 0u) << l;
      m.rneq |= (qr[l * q_stride] != dr[l * d_stride] ? 1u : 0u) << l;
    }
  }
}

// The five distances of a cell whose words and masks are loaded.
template <int L, bool LIVE>
EDIT_HD void distances(const int (&q)[L], const int (&d)[L], int ql, int dl,
                       const Masks& m, int (&out)[5]) {
  const int dl_a[1] = {dl};
  int lev3[1];
  band_sweep<L, 3, 1, LIVE>(q, d, ql, dl_a, lev3);
  const int dl_w[3] = {imin(dl, ql), imin(dl, ql + 1),
                       imin(dl, imax(ql - 1, 0))};
  int levp[3];
  band_sweep<L, 2, 3, LIVE>(q, d, ql, dl_w, levp);
  out[0] = rescue<L, 1>(imin(lev3[0], 3), ql, dl, m);
  out[1] = rescue<L, 2>(lev3[0], ql, dl, m);
#pragma unroll
  for (int w = 0; w < 3; ++w) out[2 + w] = rescue<L, 1>(levp[w], ql, dl_w[w], m);
}

// ---------------------------------------------------------------------------
// The pair word: everything the coverage program needs about one (query
// word, doc word) pair, in one int32 (ops/_kernels.py names the same bits).
//
//   bit 0  EQ        the words are equal
//   bit 1  D_SW_Q    the doc word starts with the query word
//   bit 2  D_EW_Q    the doc word ends with the query word
//   bit 3  Q_EW_D    the query word ends with the doc word
//   bit 4  D_CONT_Q  the doc word contains the query word
//   bit 5  Q_SW_D    the query word starts with the doc word
//   bits 8-12        length of the common prefix
//   bits 16-30       dam1, dam2, pdam1, pdam2, pdam3, three bits each (each
//                    is at most 4); zero in a word built without distances
//
// The six relations are those of ops/coverage_kernel.py
// _pairwise_primitives and _q_startswith_d_t, each masked by the doc
// token's validity; lengths are at most L, as the coverage tables write
// them. They are reads of the masks the distances already need: "starts
// with" and the prefix length look at the aligned mismatch mask below one
// word's length, "ends with" at the reversed one; "contains" runs the
// doc word through a Shift-And automaton over the query word's positions
// (bit l of the state: q[0..l] ends here), which only a doc word at least
// as long as the query word needs.
constexpr int kPairPrefixShift = 8;
constexpr int kPairDistShift = 16;

template <int L>
EDIT_HD bool contains(const int (&q)[L], const int (&d)[L], int ql, int dl) {
  if (ql == 0) return true;       // the empty word, at shift 0
  if (ql > dl) return false;
  unsigned state = 0u, hit = 0u;
  const unsigned last = 1u << (ql - 1);
#pragma unroll
  for (int k = 0; k < L; ++k) {
    if (k < dl) {
      unsigned eq = 0u;           // bit l: q[l] == d[k]
#pragma unroll
      for (int l = 0; l < L; ++l) eq |= (q[l] == d[k] ? 1u : 0u) << l;
      state = ((state << 1) | 1u) & eq;
      hit |= state & last;
    }
  }
  return hit != 0u;
}

// The pair word of one cell; LIVE says that both words are non-empty (the
// kernel settles the other cells on a path of their own, see load_words).
template <int L, bool DIST, bool LIVE>
EDIT_HD int pair_word(const int* qc, const int* qr, long long q_stride,
                      const int* dc, const int* dr, long long d_stride,
                      int ql, int dl, bool valid) {
  int q[L], d[L];
  Masks m;
  load_words<L, LIVE>(qc, qr, q_stride, dc, dr, d_stride, q, d, m);
  const bool pre_q = (m.neq & low_bits(ql, L)) == 0u;
  const bool pre_d = (m.neq & low_bits(dl, L)) == 0u;
  const bool rpre_q = (m.rneq & low_bits(ql, L)) == 0u;
  const bool rpre_d = (m.rneq & low_bits(dl, L)) == 0u;
  const int both = imin(ql, dl);
  const unsigned pm = m.neq & low_bits(both, L);
  const int prefix = imin(pm != 0u ? first_bit(pm) : both, 31);
  int word = prefix << kPairPrefixShift;
  if (valid) {
    // an empty query word is contained at shift 0; an empty doc word
    // contains no other
    const bool cont = LIVE ? contains<L>(q, d, ql, dl) : ql == 0;
    word |= (dl == ql && pre_q ? 1 : 0) | (dl >= ql && pre_q ? 2 : 0) |
            (dl >= ql && rpre_q ? 4 : 0) | (ql >= dl && rpre_d ? 8 : 0) |
            (cont ? 16 : 0) | (ql >= dl && pre_d ? 32 : 0);
  }
  if (DIST) {
    int dist[5];
    distances<L, LIVE>(q, d, ql, dl, m, dist);
#pragma unroll
    for (int k = 0; k < 5; ++k) word |= dist[k] << (kPairDistShift + 3 * k);
  }
  return word;
}

template <int L, bool DIST>
EDIT_HD int pair_cell(const int* qc, const int* qr, long long q_stride,
                      const int* dc, const int* dr, long long d_stride,
                      int ql, int dl, bool valid) {
  return ql > 0 && dl > 0
             ? pair_word<L, DIST, true>(qc, qr, q_stride, dc, dr, d_stride,
                                        ql, dl, valid)
             : pair_word<L, DIST, false>(qc, qr, q_stride, dc, dr, d_stride,
                                         ql, dl, valid);
}

}  // namespace edit
