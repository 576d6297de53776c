// One candidate of the Stage-2 matcher cascade: the arithmetic of
// csrc/coverage_cascade.cu, in a header of its own so that a host compiler
// can build the same code (the CPU tests compile it with g++ and hold it
// against the plain PyTorch version, ops/coverage_kernel.py
// coverage_cascade_plain; the CUDA kernel includes it unchanged).
//
// candidate<D> runs, for one candidate with up to D doc tokens and n_q
// query tokens, the four matchers in the reference's order, each query
// token and each doc token consumed once:
//
//   1. whole word      the first active doc token equal to the query token
//   2. joined word     two adjacent query tokens that one doc token joins,
//                      then two adjacent ACTIVE doc tokens that one query
//                      token joins
//   3. prefix/suffix   query tokens in length order; the longest (then
//                      first) doc token that the query token starts, ends,
//                      is contained in or is ended by; then the same order
//                      over the prefix-window Damerau distances
//   4. fuzzy word      rounds for distance 1 and 2 over the Damerau
//                      distances inside a length window
//
// It reads the pair words of csrc/edit_distances_cell.cuh (six relation
// bits and five distances per (query token, doc token)). What the plain
// version keeps as [Q, C] and [D, C] boolean tensors is here a 16-bit mask
// of active query tokens and a D-bit mask of active doc tokens; "first
// true" is a find-first-set, and every loop walks the set bits only, so
// the work follows the candidate's real token counts and not the padded
// widths Q and D. The plain version computes every step for every
// candidate and masks it by "matched"; a step that matches nothing changes
// no state, so it is skipped here, and no index of a miss is ever read.
//
// f32: term_matched adds in the loop's order, one rounding per add, and
// the "contains" credit is one multiply, as the plain version rounds them.

#pragma once

#include <cstdint>

#if defined(__CUDACC__)
#define CASC_HD __host__ __device__ __forceinline__
#else
#define CASC_HD inline
#endif

namespace cascade {

// bits of a pair word (csrc/edit_distances_cell.cuh)
constexpr int kEq = 1, kDSwQ = 2, kDEwQ = 4, kQEwD = 8, kDContQ = 16,
              kQSwD = 32;
constexpr int kDam1 = 16, kDam2 = 19, kPdam1 = 22, kPdam2 = 25, kPdam3 = 28;

// The CoverageConfig fields the cascade reads.
struct Config {
  int min_word_size, levenshtein_max_word_size, num_typos;
  int min_length_one_typo, min_length_two_typos;
  int cover_whole_words, cover_joined_words, cover_prefix_suffix;
  int cover_fuzzy_words;
};

// One candidate's inputs: every pointer already points at the candidate's
// column, rows are `stride` apart (the tensors, and the kernel's tiles of
// them, keep the candidate axis minor).
struct In {
  const int* pairs;       // [Q, D, C] pair words (with distances)
  const int* lens;        // [D, C] doc word lengths, 0 where invalid
  const int* offsets;     // [D, C] doc token offsets in the text
  const int* codes;       // [D, C] doc word codes, -1 padded
  const int* first_char;  // [D, C] first char of each doc word
  const int* qlens;       // [Q, C] query word lengths
  const int* qsorted;     // [Q, C] query tokens by length, padded >= count
  const int* qfirst;      // first char of query word i at qfirst[i * qfirst_stride]
  long long qfirst_stride;
  long long stride;
  int tok_count;          // doc tokens of the candidate
  int qcount;             // query tokens of the candidate's query
};

struct Out {
  unsigned has_whole, has_joined, has_prefix;  // one bit per query token
  int word_hits, cov_count;
};

template <int D>
struct MaskOf {
  using type = uint32_t;
};
template <>
struct MaskOf<64> {
  using type = uint64_t;
};

CASC_HD int first_bit(uint32_t m) {
#if defined(__CUDA_ARCH__)
  return __ffs(static_cast<int>(m)) - 1;
#else
  return __builtin_ctz(m);
#endif
}
CASC_HD int first_bit(uint64_t m) {
#if defined(__CUDA_ARCH__)
  return __ffsll(static_cast<long long>(m)) - 1;
#else
  return __builtin_ctzll(m);
#endif
}
CASC_HD int bit_count(uint32_t m) {
#if defined(__CUDA_ARCH__)
  return __popc(m);
#else
  return __builtin_popcount(m);
#endif
}
CASC_HD int bit_count(uint64_t m) {
#if defined(__CUDA_ARCH__)
  return __popcll(m);
#else
  return __builtin_popcountll(m);
#endif
}

// one rounding each, never contracted into a fused multiply-add
CASC_HD float fadd(float a, float b) {
#if defined(__CUDA_ARCH__)
  return __fadd_rn(a, b);
#else
  return a + b;
#endif
}
CASC_HD float fmul(float a, float b) {
#if defined(__CUDA_ARCH__)
  return __fmul_rn(a, b);
#else
  return a * b;
#endif
}
CASC_HD int imin(int a, int b) { return a < b ? a : b; }
CASC_HD int imax(int a, int b) { return a > b ? a : b; }
CASC_HD float fmax_(float a, float b) { return a > b ? a : b; }

// first_pos[i] takes pos where it is unset (-1) or later than pos
CASC_HD void note_pos(int* fp, long long st, int i, int pos) {
  const int cur = fp[i * st];
  if (cur == -1 || pos < cur) fp[i * st] = pos;
}

// The typo budget of a query word of ql chars, and whether the
// two-letter rule gave it.
CASC_HD int typo_budget(int ql, const Config& cfg, bool& special) {
  int budget = ql >= cfg.min_length_two_typos
                   ? 2
                   : (ql >= cfg.min_length_one_typo ? 1 : 0);
  special = ql == 2 && budget == 0 && cfg.num_typos >= 1;
  if (special) budget = 1;
  return imin(budget, cfg.num_typos);
}

// One candidate. tm (term_matched) and fp (term_first_pos) are the
// per-query-token state, element i at [i * st], n_q elements each (the
// caller's: shared memory on the card, so that a token index known only
// at run time costs no local memory). Writes both and `out`.
template <int D>
CASC_HD void candidate(const In& in, int n_q, const Config& cfg, float* tm,
                       int* fp, long long st, Out& out) {
  using M = typename MaskOf<D>::type;
  const M one = 1;
  const long long n_c = in.stride;
#define CASC_PAIR(q, d) (in.pairs[(static_cast<long long>(q) * D + (d)) * n_c])
#define CASC_D(arr, d) (in.arr[(d) * n_c])
#define CASC_Q(arr, q) (in.arr[(q) * n_c])

  // ---- doc tokens: valid, coverable, first of their word ---------------
  const int n_tok = imax(0, imin(in.tok_count, D));
  M cov = 0;
  for (int d = 0; d < n_tok; ++d) {
    if (CASC_D(codes, d) >= 0 && CASC_D(lens, d) >= cfg.min_word_size) {
      cov |= one << d;
    }
  }
  M d_active = 0;  // unique: coverable, and no earlier coverable token has its code
  for (M rest = cov; rest != 0; rest &= rest - 1) {
    const int d = first_bit(rest);
    const int code = CASC_D(codes, d);
    bool dup = false;
    for (M prev = cov & ((one << d) - 1); prev != 0 && !dup; prev &= prev - 1) {
      dup = CASC_D(codes, first_bit(prev)) == code;
    }
    if (!dup) d_active |= one << d;
  }
  out.cov_count = bit_count(cov);

  // ---- matcher state ----------------------------------------------------
  const int nq = imax(0, imin(in.qcount, n_q));  // real query tokens
  unsigned q_active = (1u << nq) - 1u;
  unsigned has_whole = 0u, has_joined = 0u, has_prefix = 0u;
  int word_hits = 0;
  for (int i = 0; i < n_q; ++i) {
    tm[i * st] = 0.0f;
    fp[i * st] = -1;
  }

  // ---- 1. whole word ----------------------------------------------------
  if (cfg.cover_whole_words) {
    for (int i = 0; i < nq; ++i) {
      if (!((q_active >> i) & 1u)) continue;
      for (M rest = d_active; rest != 0; rest &= rest - 1) {
        const int j = first_bit(rest);
        if (!(CASC_PAIR(i, j) & kEq)) continue;
        word_hits += 1;
        tm[i * st] = fadd(tm[i * st], static_cast<float>(CASC_Q(qlens, i)));
        has_whole |= 1u << i;
        has_prefix |= 1u << i;
        note_pos(fp, st, i, CASC_D(offsets, j));
        q_active &= ~(1u << i);
        d_active &= ~(one << j);
        break;
      }
    }
  }

  // ---- 2. joined word ---------------------------------------------------
  if (cfg.cover_joined_words) {
    // two adjacent query tokens, one doc token
    for (int i = 0; i + 1 < nq; ++i) {
      if (((q_active >> i) & 3u) != 3u) continue;
      const int ql0 = CASC_Q(qlens, i), ql1 = CASC_Q(qlens, i + 1);
      for (M rest = d_active; rest != 0; rest &= rest - 1) {
        const int j = first_bit(rest);
        if (CASC_D(lens, j) != ql0 + ql1 || !(CASC_PAIR(i, j) & kDSwQ) ||
            !(CASC_PAIR(i + 1, j) & kDEwQ)) {
          continue;
        }
        const int pos = CASC_D(offsets, j);
        word_hits += 2;
        tm[i * st] = fadd(tm[i * st], static_cast<float>(ql0));
        has_joined |= 3u << i;
        has_prefix |= 1u << i;
        note_pos(fp, st, i, pos);
        tm[(i + 1) * st] = fadd(tm[(i + 1) * st], static_cast<float>(ql1));
        note_pos(fp, st, i + 1, pos);
        q_active &= ~(3u << i);
        d_active &= ~(one << j);
        break;
      }
    }
    // two adjacent ACTIVE doc tokens, one query token
    for (int i = 0; i + 1 < n_tok; ++i) {
      if (!((d_active >> i) & 1)) continue;
      const M later = d_active & ~((one << (i + 1)) - 1);
      if (later == 0) continue;
      const int nxt = first_bit(later);
      const int jl = CASC_D(lens, i) + CASC_D(lens, nxt);
      for (unsigned rest = q_active; rest != 0u; rest &= rest - 1u) {
        const int qi = first_bit(static_cast<uint32_t>(rest));
        if (CASC_Q(qlens, qi) != jl || !(CASC_PAIR(qi, i) & kQSwD) ||
            !(CASC_PAIR(qi, nxt) & kQEwD)) {
          continue;
        }
        word_hits += 1;
        tm[qi * st] = fadd(tm[qi * st], static_cast<float>(jl));
        has_joined |= 1u << qi;
        has_prefix |= 1u << qi;
        note_pos(fp, st, qi, CASC_D(offsets, i));
        q_active &= ~(1u << qi);
        d_active &= ~((one << i) | (one << nxt));
        break;
      }
    }
  }

  // ---- 3. prefix/suffix -------------------------------------------------
  // The pick among matching doc tokens is by (length descending, index
  // ascending): walking the set bits upwards, a token replaces the pick
  // only where it is strictly longer.
  if (cfg.cover_prefix_suffix) {
    for (int si = 0; si < n_q; ++si) {
      const int qi = CASC_Q(qsorted, si);
      if (qi < 0 || qi >= nq || !((q_active >> qi) & 1u)) continue;
      const int ql = CASC_Q(qlens, qi);
      int best = -1, best_len = -1, best_kind = 0;
      for (M rest = d_active; rest != 0; rest &= rest - 1) {
        const int d = first_bit(rest);
        const int dl = CASC_D(lens, d);
        if (dl == ql || dl <= best_len) continue;
        const int w = CASC_PAIR(qi, d);
        int kind = 0;  // 1 prefix, 2 suffix, 3 contained, 4 doc word ends q
        if (ql < dl) {
          kind = (w & kDSwQ) ? 1
                 : (w & kDEwQ) ? 2
                 : (ql >= 4 && (w & kDContQ)) ? 3 : 0;
        } else if (w & kQEwD) {
          kind = 4;
        }
        if (kind != 0) {
          best = d;
          best_len = dl;
          best_kind = kind;
        }
      }
      if (best < 0) continue;
      const float qlf = static_cast<float>(ql);
      const float sc = best_kind == 1   ? qlf
                       : best_kind == 2 ? static_cast<float>(imax(ql / 2, 1))
                       : best_kind == 3 ? fmul(qlf, 0.6f)
                                        : static_cast<float>(best_len);
      word_hits += 1;
      tm[qi * st] = fadd(tm[qi * st], sc);
      if (best_kind == 1) has_prefix |= 1u << qi;
      note_pos(fp, st, qi, CASC_D(offsets, best));
      q_active &= ~(1u << qi);
      d_active &= ~(one << best);
    }
    // the same order over the prefix-window distances
    for (int si = 0; si < n_q; ++si) {
      const int qi = CASC_Q(qsorted, si);
      if (qi < 0 || qi >= nq || !((q_active >> qi) & 1u)) continue;
      const int ql = CASC_Q(qlens, qi);
      if (!(ql >= 4 || (qi == in.qcount - 1 && ql >= 2))) continue;
      int best = -1, best_len = -1;
      float best_sc = 0.0f;
      for (M rest = d_active; rest != 0; rest &= rest - 1) {
        const int d = first_bit(rest);
        const int dl = CASC_D(lens, d);
        if (!(ql < dl) || dl <= best_len) continue;
        const int w = CASC_PAIR(qi, d);
        const int d1 = (w >> kPdam1) & 7, d2 = (w >> kPdam2) & 7,
                  d3 = (w >> kPdam3) & 7;
        int credit;
        if (d1 <= 1) {
          credit = ql - d1;
        } else if (d2 <= 1) {
          credit = ql - d2;
        } else if (ql > 1 && d3 <= 1) {
          credit = ql - 1 - d3;
        } else {
          continue;
        }
        best = d;
        best_len = dl;
        best_sc = fmax_(static_cast<float>(credit), 0.1f);
      }
      if (best < 0) continue;
      word_hits += 1;
      tm[qi * st] = fadd(tm[qi * st], best_sc);
      note_pos(fp, st, qi, CASC_D(offsets, best));
      q_active &= ~(1u << qi);
      d_active &= ~(one << best);
    }
  }

  // ---- 4. fuzzy word ----------------------------------------------------
  if (cfg.cover_fuzzy_words) {
    // taken once, from the state after stage 3
    bool all_full = true;
    int max_q_len = 0;
    for (int i = 0; i < n_q; ++i) {
      const int ql = CASC_Q(qlens, i);
      const bool fully = ql <= 0 || tm[i * st] >= static_cast<float>(ql) ||
                         !(i < in.qcount);
      all_full = all_full && fully;
      if ((q_active >> i) & 1u) max_q_len = imax(max_q_len, ql);
    }
    bool special_global;
    const int max_edit = typo_budget(max_q_len, cfg, special_global);
    for (int edit_dist = 1; edit_dist <= 2; ++edit_dist) {
      if (edit_dist > cfg.num_typos) break;
      if (!(edit_dist <= max_edit) || all_full) continue;
      const int shift = edit_dist == 1 ? kDam1 : kDam2;
      for (int i = 0; i < nq; ++i) {
        if (!((q_active >> i) & 1u)) continue;
        const int ql = CASC_Q(qlens, i);
        if (cfg.min_word_size > 0 && ql < cfg.min_word_size) continue;
        bool special;
        const int token_max = typo_budget(ql, cfg, special);
        if (edit_dist > token_max || (edit_dist != 1 && special)) continue;
        const int min_len = imax(ql - edit_dist, cfg.min_word_size);
        const int max_len =
            imin(imin(ql + edit_dist, cfg.levenshtein_max_word_size), 63);
        const int q_first = in.qfirst[i * in.qfirst_stride];
        for (M rest = d_active; rest != 0; rest &= rest - 1) {
          const int j = first_bit(rest);
          const int dl = CASC_D(lens, j);
          if (dl < min_len || dl > max_len) continue;
          if (special && !(dl > 0 && CASC_D(first_char, j) == q_first)) continue;
          const int dist = (CASC_PAIR(i, j) >> shift) & 7;
          if (dist > edit_dist) continue;
          word_hits += 1;
          tm[i * st] = fadd(tm[i * st], static_cast<float>(ql - dist));
          note_pos(fp, st, i, CASC_D(offsets, j));
          q_active &= ~(1u << i);
          d_active &= ~(one << j);
          break;
        }
      }
    }
  }

  out.has_whole = has_whole;
  out.has_joined = has_joined;
  out.has_prefix = has_prefix;
  out.word_hits = word_hits;
#undef CASC_PAIR
#undef CASC_D
#undef CASC_Q
}

}  // namespace cascade
