// The Stage-2 pair words: the arithmetic of csrc/coverage_pairs.cu (the
// five edit distances and the word relations of every (query token, doc
// token, candidate) cell, packed in one int32), and the kernel's block
// code, in a header of its own so that a host compiler can build the same
// code (the CPU tests compile it with g++ and hold it against the plain
// PyTorch version; the CUDA kernel includes it unchanged).
//
// What a cell computes, for one query word q (ql chars, reversed copy qr)
// and one doc word d (dl chars, reversed copy dr), both zero-padded to L
// chars, is what ops/coverage_kernel.py coverage_pairs_plain computes for
// it, bit for bit:
//
//   out[0] dam1  = rescue(min(lev3, 3), dl, max_distance 1)
//   out[1] dam2  = rescue(lev3, dl, max_distance 2, reversed suffix run)
//   out[2..4] pdam1..3 = rescue(levp[w], dlw, max_distance 1) for the
//       three prefix windows dlw = min(dl, ql), min(dl, ql + 1),
//       min(dl, max(ql - 1, 0))
//
// lev3 = min(lev(q, d), 4) is the plain version's banded sweep of
// half-width 3, levp[w] = min(lev(q, d[:dlw]), 3) its sweep of half-width
// 2; below, band_sweep is that sweep cell by cell. A band of half-width B
// clipped to B + 1 equals the full distance clipped to B + 1 (a path that
// leaves the band costs more than B), so the kernel takes the distances
// from a bit-parallel Levenshtein instead (live_word): Myers' column
// vectors in Hyyro's global-distance form, the query word's positions as
// bits, one step of about fifteen operations a doc char in place of twelve
// band cells. The sweep's edges carry over: a query word longer than L
// repeats its last stored char (the band clamps its char index), a window
// longer than L reads the column after L chars at row L + ql - dlw (where
// the band froze), and empty words take the plain version's overrides.
// The tests hold the two routes to each other on every pair of words up
// to 5 chars over 3 letters and on random and over-long pairs.
//
// The transposition rescue is the reference's approximate one, reproduced
// as it is (first mismatch p inside the scan range, a swap at p, then the
// rest compared by aligned prefix and reversed suffix run). The plain
// version builds [Q, L, D, C] equality tensors and reduces them; here the
// L <= 24 positions of a cell are four bit masks in registers (mismatch,
// the two one-shifted equalities, reversed mismatch) and every "first
// true" is a find-first-set over a masked range. Every reader of a mask
// looks only at positions inside both words.

#pragma once

#include "lane_group.cuh"

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

// bits [0, n) set, 0 <= n <= 32
EDIT_HD unsigned below(int n) { return n >= 32 ? ~0u : (1u << n) - 1u; }

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
// empty words: the band route the tests hold live_word and dead_word to
// (through pair_cell).
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

// The five distances from lev3 = min(lev, 4) and the three windows' levp
// = min(lev(q, d[:dlw]), 3).
template <int L>
EDIT_HD void rescues(int lev3, const int (&levp)[3], int ql, int dl,
                     const int (&dl_w)[3], const Masks& m, int (&out)[5]) {
  out[0] = rescue<L, 1>(imin(lev3, 3), ql, dl, m);
  out[1] = rescue<L, 2>(lev3, ql, dl, m);
#pragma unroll
  for (int w = 0; w < 3; ++w) out[2 + w] = rescue<L, 1>(levp[w], ql, dl_w[w], m);
}

// The three prefix windows of a doc word of dl chars against ql.
EDIT_HD void windows(int ql, int dl, int (&dl_w)[3]) {
  dl_w[0] = imin(dl, ql);
  dl_w[1] = imin(dl, ql + 1);
  dl_w[2] = imin(dl, imax(ql - 1, 0));
}

// Reads one cell's words: q[l] = qc[l * q_stride], qr likewise; d[l] =
// dc[l * d_stride], dr likewise, and builds the four position masks. A
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

// The five distances of a cell whose words and masks are loaded, by the
// band sweeps.
template <int L, bool LIVE>
EDIT_HD void distances(const int (&q)[L], const int (&d)[L], int ql, int dl,
                       const Masks& m, int (&out)[5]) {
  const int dl_a[1] = {dl};
  int lev3[1];
  band_sweep<L, 3, 1, LIVE>(q, d, ql, dl_a, lev3);
  int dl_w[3];
  windows(ql, dl, dl_w);
  int levp[3];
  band_sweep<L, 2, 3, LIVE>(q, d, ql, dl_w, levp);
  rescues<L>(lev3[0], levp, ql, dl, dl_w, m, out);
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
// token's validity; lengths are at most L (the distances hold up to 31).
// They are reads of the masks
// the distances already need: "starts with" and the prefix length look at
// the aligned mismatch mask below one word's length, "ends with" at the
// reversed one; "contains" runs the doc word through a Shift-And automaton
// over the query word's positions (bit l of the state: q[0..l] ends here),
// which only a doc word at least as long as the query word needs.
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

// The relation bits and the prefix length of a cell's word, from its
// masks and its "contains".
template <int L>
EDIT_HD int relation_word(int ql, int dl, bool valid, const Masks& m,
                          bool cont) {
  const bool pre_q = (m.neq & low_bits(ql, L)) == 0u;
  const bool pre_d = (m.neq & low_bits(dl, L)) == 0u;
  const bool rpre_q = (m.rneq & low_bits(ql, L)) == 0u;
  const bool rpre_d = (m.rneq & low_bits(dl, L)) == 0u;
  const int both = imin(ql, dl);
  const unsigned pm = m.neq & low_bits(both, L);
  const int prefix = imin(pm != 0u ? first_bit(pm) : both, 31);
  int word = prefix << kPairPrefixShift;
  if (valid) {
    word |= (dl == ql && pre_q ? 1 : 0) | (dl >= ql && pre_q ? 2 : 0) |
            (dl >= ql && rpre_q ? 4 : 0) | (ql >= dl && rpre_d ? 8 : 0) |
            (cont ? 16 : 0) | (ql >= dl && pre_d ? 32 : 0);
  }
  return word;
}

EDIT_HD int distance_bits(const int (&dist)[5]) {
  int word = 0;
#pragma unroll
  for (int k = 0; k < 5; ++k) word |= dist[k] << (kPairDistShift + 3 * k);
  return word;
}

// The pair word of one cell by the band sweeps, its chars read in place;
// LIVE says that both words are non-empty (see load_words).
template <int L, bool DIST, bool LIVE>
EDIT_HD int pair_word(const int* qc, const int* qr, long long q_stride,
                      const int* dc, const int* dr, long long d_stride,
                      int ql, int dl, bool valid) {
  int q[L], d[L];
  Masks m;
  load_words<L, LIVE>(qc, qr, q_stride, dc, dr, d_stride, q, d, m);
  // an empty query word is contained at shift 0; an empty doc word
  // contains no other
  const bool cont = LIVE ? contains<L>(q, d, ql, dl) : ql == 0;
  int word = relation_word<L>(ql, dl, valid, m, cont);
  if (DIST) {
    int dist[5];
    distances<L, LIVE>(q, d, ql, dl, m, dist);
    word |= distance_bits(dist);
  }
  return word;
}

// The band route's word of any cell (the tests' reference for live_word).
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

// The word of a cell with an empty word (ql == 0 or dl == 0), in closed
// form: no chars; the masks are empty, so "starts with" and "ends with"
// hold wherever the lengths allow, the prefix is 0, only the empty query
// word is contained, no rescue applies, and each distance is the other
// word's length (the band sweep's overrides) clipped at max_distance + 1.
// Equal to pair_cell for such cells (the tests hold them together).
EDIT_HD int dead_word(bool dist, int ql, int dl, bool valid) {
  int word = 0;
  if (valid) {
    word = (dl == ql ? 1 : 0) | (dl >= ql ? 2 | 4 : 0) |
           (ql >= dl ? 8 | 32 : 0) | (ql == 0 ? 16 : 0);
  }
  if (dist) {
    int dl_w[3];
    windows(ql, dl, dl_w);
    const int out[5] = {imin(ql + dl, 2), imin(ql + dl, 3),
                        imin(ql + dl_w[0], 2), imin(ql + dl_w[1], 2),
                        imin(ql + dl_w[2], 2)};
    word |= distance_bits(out);
  }
  return word;
}

// ---------------------------------------------------------------------------
// A cell with two non-empty words, every equality computed once.
//
// One pass over the doc word's stored chars (k < min(dl, L)) builds
// eq[k], bit l set where q[l] == d[k] for l < min(ql, L), and hands it to
// its three readers at once:
//   * the masks: neq, qd1 and q1d are bits of eq on and next to the
//     diagonal (bit k, k - 1 and k + 1 of eq[k]);
//   * the Shift-And automaton of "contains";
//   * with distances, the bit-parallel Levenshtein: pv / mv hold the
//     vertical +1 / -1 steps of the current column of D, the distance of
//     q[:i] (rows i) and d[:j] (columns j), D[0][j] = j; D[ql][j] is
//     followed through the bottom row's horizontal steps, and a row i of
//     the last column is j + popc(pv below i) - popc(mv below i).
// N (the compares per doc char) is L, or L / 2 when the query word fits
// it. Chars are read from d[k * d_step], q[l * q_step] (shared memory on
// the card) for positions inside the word only.

struct Sweep {
  unsigned neq, qd1, q1d;   // bits below min(ql, dl, L) as in Masks
  bool cont;                // the doc word contains the query word
  unsigned pv, mv;          // the column after min(dl, L) doc chars
  int at[4];                // D[ql][n] for the windows' n <= L
};

template <int L, int N>
EDIT_HD void sweep(const int (&q)[L], const int* d, int d_step, int ql,
                   int dl, const int (&n_w)[4], bool dist, Sweep& o) {
  const int dn = imin(dl, L);
  const unsigned qmask = below(imin(ql, L));
  // pattern positions past the table repeat the last stored char, as the
  // band sweep's clamped char index does
  const unsigned past = ql > L ? below(ql) & ~below(L) : 0u;
  const unsigned top = 1u << (ql - 1);
  const unsigned last = ql <= dl && ql <= L ? top : 0u;
  unsigned neq = 0u, qd1 = 0u, q1d = 0u, state = 0u, hit = 0u;
  unsigned pv = ~0u, mv = 0u;
  int score = ql;   // D[ql][0]
  for (int k = 0; k < dn; ++k) {
    const int c = d[k * d_step];
    unsigned e = 0u;
#pragma unroll
    for (int l = 0; l < N; ++l) e |= (q[l] == c ? 1u : 0u) << l;
    e &= qmask;
    const unsigned bit = 1u << k;
    neq |= ~e & bit;
    q1d |= (e >> 1) & bit;
    qd1 |= e & (bit >> 1);
    state = ((state << 1) | 1u) & e;
    hit |= state & last;
    if (dist) {
      const unsigned x = ((e >> (L - 1)) & 1u) != 0u ? e | past : e;
      const unsigned xv = x | mv;
      const unsigned xh = (((x & pv) + pv) ^ pv) | x;
      unsigned ph = mv | ~(xh | pv);
      unsigned mh = pv & xh;
      score += ((ph & top) != 0u ? 1 : 0) - ((mh & top) != 0u ? 1 : 0);
      ph = (ph << 1) | 1u;
      mh <<= 1;
      pv = mh | ~(xv | ph);
      mv = ph & xv;
#pragma unroll
      for (int w = 0; w < 4; ++w) {
        if (k + 1 == n_w[w]) o.at[w] = score;
      }
    }
  }
  // the positions that meet the zero past the table: q[L] and d[L]
  if (dn == L) q1d |= (d[(L - 1) * d_step] == 0 ? 1u : 0u) << (L - 1);
  if (dl > L) qd1 |= (q[L - 1] == 0 ? 1u : 0u) << (L - 1);
  o.neq = neq;
  o.qd1 = qd1;
  o.q1d = q1d;
  o.cont = hit != 0u;
  o.pv = pv;
  o.mv = mv;
}

// The pair word of a cell with ql, dl > 0 (at most L; up to 31 for the
// distances), its query word's
// chars q[l * q_step], qr likewise, its doc word's d[k * d_step], dr
// likewise; with `dist` the five distances too. Equal to pair_cell.
template <int L>
EDIT_HD int live_word(const int* qs, const int* qrs, int q_step,
                      const int* ds, const int* drs, int d_step, int ql,
                      int dl, bool valid, bool dist) {
  static_assert(L >= 2 && L <= 31 && L % 2 == 0, "L even, below 32");
  const int qn = imin(ql, L), dn = imin(dl, L);
  int q[L];
#pragma unroll
  for (int l = 0; l < L; ++l) q[l] = l < qn ? qs[l * q_step] : 0;
  int dl_w[3];
  windows(ql, dl, dl_w);
  const int n_w[4] = {dl, dl_w[0], dl_w[1], dl_w[2]};
  Sweep o;
  o.at[0] = o.at[1] = o.at[2] = o.at[3] = ql;
  if (qn <= L / 2) {
    sweep<L, L / 2>(q, ds, d_step, ql, dl, n_w, dist, o);
  } else {
    sweep<L, L>(q, ds, d_step, ql, dl, n_w, dist, o);
  }
  Masks m{o.neq, o.qd1, o.q1d, 0u};
  const int both = imin(qn, dn);
  for (int l = 0; l < both; ++l) {
    m.rneq |= (qrs[l * q_step] != drs[l * d_step] ? 1u : 0u) << l;
  }
  int word = relation_word<L>(ql, dl, valid, m, o.cont);
  if (dist) {
    int lev[4];
#pragma unroll
    for (int w = 0; w < 4; ++w) {
      const int n = n_w[w];
      int v = o.at[w];
      if (n == 0) {
        v = ql;
      } else if (n > L) {
        // the band froze after L chars, read at row L + ql - n
        const int i = L + ql - n;
        v = i < 0 ? 4
                  : L + grp::popc(o.pv & below(i)) - grp::popc(o.mv & below(i));
      }
      lev[w] = imin(v, w == 0 ? 4 : 3);
    }
    const int levp[3] = {lev[1], lev[2], lev[3]};
    int out[5];
    rescues<L>(lev[0], levp, ql, dl, dl_w, m, out);
    word |= distance_bits(out);
  }
  return word;
}

}  // namespace edit

// ---------------------------------------------------------------------------
// The kernel's block: a tile of candidates, staged in shared memory, its
// live cells dealt to the threads.
//
// Query slots s < n_s take the Q tokens (with distances when `dist`),
// slots n_s .. n_s + n_f the fusion tokens (relations only), so that one
// launch serves a coverage block and the doc rows are staged once. A block
// of kThreads threads takes T candidates (tile_candidates) and runs three
// steps, a barrier after each of the first two:
//   1. copy the tile's lengths and validity into shared memory;
//   2. copy the chars of its non-empty words (a thread a word, plain and
//      reversed, its chars below min(length, L) only), while every cell
//      with an empty word gets dead_word (a coalesced pass: T
//      neighbouring candidates of a row a run) and every other cell goes
//      into a list (a ballot and one shared atomic a warp);
//   3. the threads take the list's cells in turn: whole warps of live
//      cells.
// Copies are cp.async on the card (grp::copy_async). On the host (the
// tests) a block is one thread running the three steps in order.

namespace pairs {

using edit::imax;
using edit::imin;

constexpr int kThreads = 256;
constexpr int kTileMax = 64;
// shared memory a block aims below (the largest shapes take more, up to
// kSmemMax, at one candidate a block)
constexpr int kSmemBudget = 64 * 1024;
constexpr int kSmemMax = 227 * 1024;
// blocks a multiprocessor the tile size aims at
constexpr int kBlocksPerSm = 2;

struct Args {
  const int* qc;            // [n_s, L, C] query tokens' chars
  const int* qr;            // [n_s, L, C] reversed
  const int* ql;            // [n_s, C] lengths
  const int* fqc;           // [n_f, L, C] fusion tokens' chars
  const int* fqr;
  const int* fql;           // [n_f, C]
  const int* dc;            // [L, D, C] doc tokens' chars
  const int* dr;
  const int* dl;            // [D, C]
  const unsigned char* valid;  // [D, C]
  int n_s, n_f, n_d, n_c;
  int dist;                 // the Q slots' words carry distances
  int* out;                 // [n_s, D, C]
  int* fout;                // [n_f, D, C]
};

// A tile's arrays in shared memory, in ints: rows of `pitch` = t + 1
// candidates (t a power of two: an odd pitch spreads a warp's rows over
// the banks); the live list of unsigned shorts last.
struct Layout {
  int pitch, qc, qr, ql, dc, dr, dl, valid, n_live, list, ints;
};

EDIT_HD Layout layout(int n_l, int n_slots, int n_d, int t) {
  Layout y;
  y.pitch = t + 1;
  y.qc = 0;
  y.qr = y.qc + n_slots * n_l * y.pitch;
  y.ql = y.qr + n_slots * n_l * y.pitch;
  y.dc = y.ql + n_slots * y.pitch;
  y.dr = y.dc + n_l * n_d * y.pitch;
  y.dl = y.dr + n_l * n_d * y.pitch;
  y.valid = y.dl + n_d * y.pitch;
  y.n_live = y.valid + n_d * y.pitch;
  y.list = y.n_live + 1;
  y.ints = y.list + (n_slots * n_d * t + 1) / 2;
  return y;
}

EDIT_HD bool tile_fits(int n_l, int n_slots, int n_d, int t, int budget) {
  return 4 * layout(n_l, n_slots, n_d, t).ints <= budget &&
         n_slots * n_d * t <= 65536;
}

// Candidates a block takes, a power of two: about n_c / blocks (blocks:
// kBlocksPerSm a multiprocessor on the card), at most kTileMax, within
// kSmemBudget and the list's 16-bit entries; 0 where one candidate does
// not fit kSmemMax.
EDIT_HD int tile_candidates(int n_l, int n_slots, int n_d, int n_c,
                            int blocks) {
  const int want = imin(kTileMax, imax(1, n_c / imax(blocks, 1)));
  int t = 1;
  while (2 * t <= want) t *= 2;
  while (t > 1 && !tile_fits(n_l, n_slots, n_d, t, kSmemBudget)) t /= 2;
  return tile_fits(n_l, n_slots, n_d, t, kSmemMax) ? t : 0;
}

// This thread's slot in a list that *counter counts, or -1 where `pred` is
// false; every thread of the warp calls it.
EDIT_HD int append_if(bool pred, int* counter) {
#if defined(__CUDA_ARCH__)
  const unsigned m = __ballot_sync(0xffffffffu, pred);
  const int lane = static_cast<int>(threadIdx.x) & 31;
  int base = 0;
  if (lane == 0 && m != 0u) base = atomicAdd(counter, __popc(m));
  base = __shfl_sync(0xffffffffu, base, 0);
  return pred ? base + __popc(m & ((1u << lane) - 1u)) : -1;
#else
  return pred ? (*counter)++ : -1;
#endif
}

// The copies this thread started have landed, and every thread of the
// block is here (nothing on the host).
EDIT_HD void barrier() {
#if defined(__CUDA_ARCH__)
  grp::copy_wait();
  __syncthreads();
#endif
}

// r / d for 0 <= r < 2^16 and 1 <= d < 2^16 (a tile's row indices: below
// its list's 2^16 cells), as a multiply and a shift:
// m = ceil(2^32 / d) errs by e = m d - 2^32 < d, and r e / (d 2^32) stays
// below the 1 / d that separates floor(r / d) from the next integer.
struct Divisor {
  unsigned m;
  int d;
};

EDIT_HD Divisor divisor(int d) {
  return {d > 1 ? static_cast<unsigned>(0xffffffffu / d + 1u) : 0u, d};
}

EDIT_HD int quotient(int r, const Divisor& v) {
  if (v.d == 1) return r;
#if defined(__CUDA_ARCH__)
  return static_cast<int>(__umulhi(static_cast<unsigned>(r), v.m));
#else
  return static_cast<int>((static_cast<unsigned long long>(r) * v.m) >> 32);
#endif
}

EDIT_HD int* target(const Args& a, int s, int d, int c) {
  return s < a.n_s
             ? a.out + (static_cast<long long>(s) * a.n_d + d) * a.n_c + c
             : a.fout +
                   (static_cast<long long>(s - a.n_s) * a.n_d + d) * a.n_c + c;
}

// Block `tid` of `n_threads` threads over candidates c0 .. c0 + 2^lt - 1
// (those below C), `smem` its layout(L, n_s + n_f, D, 2^lt). Index i of
// a loop is (row i >> lt, candidate i & (2^lt - 1)).
template <int L>
EDIT_HD void block(const Args& a, int lt, int c0, int tid, int n_threads,
                   int* smem) {
  const int t = 1 << lt, tm = t - 1;
  const int n_slots = a.n_s + a.n_f, n_d = a.n_d;
  const long long n_c = a.n_c;
  const Layout y = layout(L, n_slots, n_d, t);
  const int p = y.pitch;
  const int width = imin(t, a.n_c - c0);
  const Divisor by_d = divisor(n_d);
  // 1. lengths and validity
  for (int i = tid; i < n_slots << lt; i += n_threads) {
    const int s = i >> lt, k = i & tm;
    int* dst = smem + y.ql + s * p + k;
    if (k < width) {
      const int* src = s < a.n_s ? a.ql + s * n_c : a.fql + (s - a.n_s) * n_c;
      grp::copy_async(dst, src + c0 + k);
    } else {
      *dst = 0;
    }
  }
  for (int i = tid; i < n_d << lt; i += n_threads) {
    const int d = i >> lt, k = i & tm;
    if (k < width) {
      grp::copy_async(smem + y.dl + d * p + k, a.dl + d * n_c + c0 + k);
      smem[y.valid + d * p + k] = a.valid[d * n_c + c0 + k];
    } else {
      smem[y.dl + d * p + k] = 0;
      smem[y.valid + d * p + k] = 0;
    }
  }
  if (tid == 0) smem[y.n_live] = 0;
  barrier();

  // 2. chars of the non-empty words (in flight meanwhile; a thread a
  // word, its chars below min(length, L)), the cells with an empty word,
  // the live list
  for (int i = tid; i < (n_slots + n_d) << lt; i += n_threads) {
    const int w = i >> lt, k = i & tm;
    const int* src;
    const int* src_r;
    long long step;
    int *dst, *dst_r, n, pitch;
    if (w < n_slots) {          // query slot w: rows [w, l] of [S, L, C]
      const int s = w, row = (s < a.n_s ? s : s - a.n_s) * L;
      src = (s < a.n_s ? a.qc : a.fqc) + row * n_c + c0 + k;
      src_r = (s < a.n_s ? a.qr : a.fqr) + row * n_c + c0 + k;
      step = n_c;
      dst = smem + y.qc + s * L * p + k;
      dst_r = smem + y.qr + s * L * p + k;
      pitch = p;
      n = smem[y.ql + s * p + k];
    } else {                    // doc token d: rows [l, d] of [L, D, C]
      const int d = w - n_slots;
      src = a.dc + d * n_c + c0 + k;
      src_r = a.dr + d * n_c + c0 + k;
      step = n_d * n_c;
      dst = smem + y.dc + d * p + k;
      dst_r = smem + y.dr + d * p + k;
      pitch = n_d * p;
      n = smem[y.dl + d * p + k];
    }
    n = imin(n, L);
    for (int l = 0; l < n; ++l) {
      grp::copy_async(dst + l * pitch, src + l * step);
      grp::copy_async(dst_r + l * pitch, src_r + l * step);
    }
  }
  unsigned short* list = reinterpret_cast<unsigned short*>(smem + y.list);
  const int n_cells = (n_slots * n_d) << lt;
  for (int base = 0; base < n_cells; base += n_threads) {
    const int i = base + tid;
    bool live = false;
    if (i < n_cells) {
      const int r = i >> lt, k = i & tm;   // r = s * D + d
      const int s = quotient(r, by_d), d = r - s * n_d;
      if (k < width) {
        const int ql = smem[y.ql + s * p + k], dl = smem[y.dl + d * p + k];
        live = ql > 0 && dl > 0;
        if (!live) {
          *target(a, s, d, c0 + k) = edit::dead_word(
              s < a.n_s && a.dist, ql, dl, smem[y.valid + d * p + k] != 0);
        }
      }
    }
    const int slot = append_if(live, smem + y.n_live);
    if (live) list[slot] = static_cast<unsigned short>(i);
  }
  barrier();

  // 3. the live cells
  const int n_live = smem[y.n_live];
  for (int j = tid; j < n_live; j += n_threads) {
    const int i = list[j];
    const int r = i >> lt, k = i & tm;
    const int s = quotient(r, by_d), d = r - s * n_d;
    const int q_at = s * L * p + k, d_at = d * p + k;
    *target(a, s, d, c0 + k) = edit::live_word<L>(
        smem + y.qc + q_at, smem + y.qr + q_at, p, smem + y.dc + d_at,
        smem + y.dr + d_at, n_d * p, smem[y.ql + s * p + k],
        smem[y.dl + d * p + k], smem[y.valid + d * p + k] != 0,
        s < a.n_s && a.dist != 0);
  }
}

}  // namespace pairs
