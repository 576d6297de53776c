// One candidate of the Stage-2 matcher cascade, worked by a group of lanes
// over its doc tokens: the arithmetic of csrc/coverage_cascade.cu, in a
// header of its own so that a host compiler can build the same code (the
// CPU tests compile it with g++ and hold it against the plain PyTorch
// version, ops/coverage_kernel.py coverage_cascade_plain; the CUDA kernel
// includes it unchanged). The group's collectives are those of
// csrc/lane_group.cuh: warp intrinsics on the card, a loop over the lanes on
// the host.
//
// candidate<D, G> runs, for one candidate with up to D doc tokens and n_q
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
// of active query tokens and a D-bit mask of active doc tokens, which every
// lane of the group holds alike. The G lanes share the doc tokens out (lane
// l takes d = l, l + G: two tokens a lane at D 64), so each step over doc
// tokens is a test per lane and one collective:
//
//   "the first active doc token that ..."   a ballot, then find-first-set
//   "the longest, then the first"           the largest key (length << 6 |
//                                           63 - index) over the lanes
//   duplicate doc words                     a lane per token against the
//                                           earlier ones, one ballot
//   the doc-joined pairs                    a lane per token: the query
//                                           tokens that join it and the
//                                           next active one; then a ballot
//                                           per match
//
// What stays sequential is the order over query tokens (single
// consumption, and the length-sorted order of stage 3): each query token's
// step sees the masks the one before left. A step that matches nothing
// changes no state, so it is skipped, and no index of a miss is ever read.
//
// The per-query-token state (term_matched, term_first_pos) lives in the
// tile beside the inputs: the group's leader alone updates it, so each
// term_matched add is one rounding, in the loop's order; the "contains"
// credit is one multiply, as the plain version rounds them.
//
// The kernel first copies a tile of kTile candidates' rows into shared
// memory (stage, below; coalesced: neighbouring threads read neighbouring
// candidates of a row), as far as the tile's token counts reach; tile_in
// points a candidate's inputs there.

#pragma once

#include <cstdint>

#include "lane_group.cuh"

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

// The kernel's arguments: candidate-minor tensors (see coverage_cascade.cu).
struct Args {
  const int* pairs;       // [Q, D, C] pair words (with distances)
  const int* lens;        // [D, C] doc word lengths, 0 where invalid
  const int* offsets;     // [D, C] doc token offsets in the text
  const int* codes;       // [D, C] doc word codes, -1 padded
  const int* first_char;  // [D, C] first char of each doc word
  const int* tok_count;   // [C]
  const int* qlens;       // [Q, C] query word lengths
  const int* qsorted;     // [Q, C] query tokens by length, padded >= count
  const int* qc;          // [Q, L, C] query chars (row 0 of each is read)
  const int* qcount;      // [C]
  int n_q, n_l, n_c;
  Config cfg;
  float* term_matched;    // [Q, C] ...
  unsigned char* has_whole;
  unsigned char* has_joined;
  unsigned char* has_prefix;
  int* first_pos;         // ... [Q, C]
  int* word_hits;         // [C]
  int* cov_count;         // [C]
};

// One candidate's rows in the tile: element i of every array at
// [i * stride] (pairs (q, d) at [(q * D + d) * stride]).
struct In {
  const int* pairs;
  const int* lens;
  const int* offsets;
  const int* codes;
  const int* first_char;
  const int* qlens;
  const int* qsorted;
  const int* qfirst;      // first char of each query word
  float* tm;              // term_matched, the leader's
  int* fp;                // term_first_pos, the leader's
  int* qmask;             // [D] scratch of the doc-joined pass
  int stride;
  int tok_count;          // doc tokens of the candidate
  int qcount;             // query tokens of the candidate's query
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

// The doc tokens d < n_tok that pass pred, as a D-bit mask: a ballot per
// G tokens (lane l tests d = l, then l + G).
template <int D, int G, class F>
CASC_HD typename MaskOf<D>::type doc_ballot(const grp::Group<G>& g,
                                            int n_tok, const F& pred) {
  using M = typename MaskOf<D>::type;
  M m = 0;
  for (int k = 0; k < D / G && k * G < n_tok; ++k) {
    const unsigned b = grp::ballot(g, [&](int l) {
      const int d = k * G + l;
      return d < n_tok && pred(d);
    });
    m |= static_cast<M>(b) << (k * G);
  }
  return m;
}

// The order of a pick among doc tokens, longest first, then first: the
// largest key wins (-1: no token).
CASC_HD int pick_key(int len, int d) { return (len << 6) | (63 - d); }
CASC_HD int picked(int key) { return 63 - (key & 63); }

// The largest key(d) over the doc tokens d < n_tok (-1 if there are none).
template <int D, int G, class F>
CASC_HD int doc_max(const grp::Group<G>& g, int n_tok, const F& key) {
  return grp::max_int(g, [&](int l) {
    int best = -1;
    for (int d = l; d < n_tok; d += G) best = imax(best, key(d));
    return best;
  });
}

// ---- the tile ----------------------------------------------------------
// kTile candidates' rows in shared memory, each array [rows][kRow] (kRow =
// kTile + 1: lanes over doc tokens and neighbouring candidates fall into
// different banks).

constexpr int kTile = 8;
constexpr int kRow = kTile + 1;

struct Layout {
  // offsets in ints
  int pairs, lens, offsets, codes, first_char, qmask, qlens, qsorted,
      qfirst, tm, fp, ints;
};

template <int D>
CASC_HD Layout layout(int n_q) {
  Layout y;
  y.pairs = 0;
  y.lens = y.pairs + n_q * D * kRow;
  y.offsets = y.lens + D * kRow;
  y.codes = y.offsets + D * kRow;
  y.first_char = y.codes + D * kRow;
  y.qmask = y.first_char + D * kRow;
  y.qlens = y.qmask + D * kRow;
  y.qsorted = y.qlens + n_q * kRow;
  y.qfirst = y.qsorted + n_q * kRow;
  y.tm = y.qfirst + n_q * kRow;
  y.fp = y.tm + n_q * kRow;
  y.ints = y.fp + n_q * kRow;
  return y;
}

// Thread `tid` of `n_threads` copies its share of the rows that candidates
// c0 .. c0 + kTile (those below C) read into the tile `smem`: the pair
// words and doc rows below the tile's largest doc-token and query-token
// counts, and every query slot's length, sorted index and first char.
template <int D>
CASC_HD void stage(const Args& a, int c0, int tid, int n_threads, int* smem) {
  const int width = imin(kTile, a.n_c - c0);
  const int n_q = a.n_q;
  int max_tok = 0, max_q = 0;
  for (int t = 0; t < width; ++t) {
    max_tok = imax(max_tok, imin(a.tok_count[c0 + t], D));
    max_q = imax(max_q, imin(a.qcount[c0 + t], n_q));
  }
  const long long n_c = a.n_c;
  const Layout y = layout<D>(n_q);
  // rows [0, n_rows) of a candidate-minor tensor, rows `row_stride` apart,
  // every copy in flight at once
  const auto rows = [&](int* dst, const int* src, int n_rows,
                        long long row_stride) {
    for (int i = tid; i < n_rows * kTile; i += n_threads) {
      const int r = i / kTile, t = i % kTile;
      if (t < width) {
        grp::copy_async(dst + r * kRow + t, src + r * row_stride + c0 + t);
      }
    }
  };
  // pair words (q, d), q < max_q, d < max_tok
  for (int i = tid; i < max_q * max_tok * kTile; i += n_threads) {
    const int r = i / kTile, t = i % kTile;
    const int row = (r / max_tok) * D + r % max_tok;
    if (t < width) {
      grp::copy_async(smem + y.pairs + row * kRow + t,
                      a.pairs + row * n_c + c0 + t);
    }
  }
  rows(smem + y.lens, a.lens, max_tok, n_c);
  rows(smem + y.offsets, a.offsets, max_tok, n_c);
  rows(smem + y.codes, a.codes, max_tok, n_c);
  rows(smem + y.first_char, a.first_char, max_tok, n_c);
  rows(smem + y.qlens, a.qlens, n_q, n_c);
  rows(smem + y.qsorted, a.qsorted, n_q, n_c);
  rows(smem + y.qfirst, a.qc, n_q, static_cast<long long>(a.n_l) * n_c);
  grp::copy_wait();
}

// Candidate c0 + t's inputs and state: its rows in the tile `smem` (after
// stage), its two counts in place.
template <int D>
CASC_HD In tile_in(const Args& a, int* smem, int c0, int t) {
  const Layout y = layout<D>(a.n_q);
  In in;
  in.pairs = smem + y.pairs + t;
  in.lens = smem + y.lens + t;
  in.offsets = smem + y.offsets + t;
  in.codes = smem + y.codes + t;
  in.first_char = smem + y.first_char + t;
  in.qlens = smem + y.qlens + t;
  in.qsorted = smem + y.qsorted + t;
  in.qfirst = smem + y.qfirst + t;
  in.tm = reinterpret_cast<float*>(smem + y.tm) + t;
  in.fp = smem + y.fp + t;
  in.qmask = smem + y.qmask + t;
  in.stride = kRow;
  in.tok_count = a.tok_count[c0 + t];
  in.qcount = a.qcount[c0 + t];
  return in;
}

// ---- one candidate -------------------------------------------------------

// Candidate c, by the group g of G lanes: its matcher state, written to
// a's outputs at column c. Every lane calls the same collectives in the
// same order (the control flow depends only on state the group holds
// alike).
template <int D, int G>
CASC_HD void candidate(const grp::Group<G>& g, const In& in, const Args& a,
                       int c) {
  using M = typename MaskOf<D>::type;
  static_assert(D % G == 0 && D <= 64, "lanes over doc tokens");
  const M one = 1;
  const int st = in.stride;
  const int n_q = a.n_q;
  const Config& cfg = a.cfg;
  const auto pair = [&](int q, int d) { return in.pairs[(q * D + d) * st]; };
  const auto lens = [&](int d) { return in.lens[d * st]; };
  const auto offsets = [&](int d) { return in.offsets[d * st]; };
  const auto codes = [&](int d) { return in.codes[d * st]; };
  const auto qlens = [&](int q) { return in.qlens[q * st]; };
  float* tm = in.tm;
  int* fp = in.fp;
  const bool lead = grp::leader(g);

  // ---- doc tokens: valid, coverable, first of their word ---------------
  const int n_tok = imax(0, imin(in.tok_count, D));
  const M cov = doc_ballot<D>(g, n_tok, [&](int d) {
    return codes(d) >= 0 && lens(d) >= cfg.min_word_size;
  });
  // a coverable token whose code an earlier coverable token has
  const M dup = doc_ballot<D>(g, n_tok, [&](int d) {
    if (!((cov >> d) & 1)) return false;
    const int code = codes(d);
    for (M prev = cov & ((one << d) - 1); prev != 0; prev &= prev - 1) {
      if (codes(first_bit(prev)) == code) return true;
    }
    return false;
  });
  M d_active = cov & ~dup;

  // ---- matcher state ----------------------------------------------------
  const int nq = imax(0, imin(in.qcount, n_q));  // real query tokens
  unsigned q_active = (1u << nq) - 1u;
  unsigned has_whole = 0u, has_joined = 0u, has_prefix = 0u;
  int word_hits = 0;
  grp::each(g, n_q, [&](int i) {
    tm[i * st] = 0.0f;
    fp[i * st] = -1;
  });
  grp::sync(g);
  // query token i gains x, found at text offset pos (the leader's state)
  const auto credit = [&](int i, float x, int pos) {
    if (!lead) return;
    tm[i * st] = fadd(tm[i * st], x);
    const int cur = fp[i * st];
    if (cur == -1 || pos < cur) fp[i * st] = pos;
  };
  const auto active = [&](int d) { return ((d_active >> d) & 1) != 0; };

  // ---- 1. whole word ----------------------------------------------------
  if (cfg.cover_whole_words) {
    for (int i = 0; i < nq; ++i) {
      if (!((q_active >> i) & 1u)) continue;
      const M hit = doc_ballot<D>(g, n_tok, [&](int d) {
        return active(d) && (pair(i, d) & kEq);
      });
      if (hit == 0) continue;
      const int j = first_bit(hit);
      word_hits += 1;
      credit(i, static_cast<float>(qlens(i)), offsets(j));
      has_whole |= 1u << i;
      has_prefix |= 1u << i;
      q_active &= ~(1u << i);
      d_active &= ~(one << j);
    }
  }

  // ---- 2. joined word ---------------------------------------------------
  if (cfg.cover_joined_words) {
    // two adjacent query tokens, one doc token
    for (int i = 0; i + 1 < nq; ++i) {
      if (((q_active >> i) & 3u) != 3u) continue;
      const int ql0 = qlens(i), ql1 = qlens(i + 1);
      const M hit = doc_ballot<D>(g, n_tok, [&](int d) {
        return active(d) && lens(d) == ql0 + ql1 && (pair(i, d) & kDSwQ) &&
               (pair(i + 1, d) & kDEwQ);
      });
      if (hit == 0) continue;
      const int j = first_bit(hit);
      const int pos = offsets(j);
      word_hits += 2;
      credit(i, static_cast<float>(ql0), pos);
      credit(i + 1, static_cast<float>(ql1), pos);
      has_joined |= 3u << i;
      has_prefix |= 1u << i;
      q_active &= ~(3u << i);
      d_active &= ~(one << j);
    }
    // two adjacent ACTIVE doc tokens, one query token. The plain version
    // walks the doc tokens upwards and pairs each active one with the next
    // active one; a match consumes both, so the pair of every token still
    // active when the walk reaches it is the one in the mask at the start
    // of the walk, and a token the walk passed stays without a match. So:
    // a lane per token d finds the query tokens that join d and its next
    // token (qmask), then each match is the first active token whose mask
    // meets the active query tokens, and its lowest query token.
    const M start = d_active;
    const auto next_of = [&](int d) {
      const M later = d + 1 < n_tok ? start & ~((one << (d + 1)) - 1) : 0;
      return later != 0 ? first_bit(later) : -1;
    };
    if (start != 0 && q_active != 0u) {
      const unsigned q_start = q_active;
      grp::each(g, n_tok, [&](int d) {
        unsigned m = 0u;
        const int nxt = (start >> d) & 1 ? next_of(d) : -1;
        if (nxt >= 0) {
          const int jl = lens(d) + lens(nxt);
          for (unsigned rest = q_start; rest != 0u; rest &= rest - 1u) {
            const int qi = first_bit(static_cast<uint32_t>(rest));
            if (qlens(qi) == jl && (pair(qi, d) & kQSwD) &&
                (pair(qi, nxt) & kQEwD)) {
              m |= 1u << qi;
            }
          }
        }
        in.qmask[d * st] = static_cast<int>(m);
      });
      grp::sync(g);
      for (;;) {
        const M hit = doc_ballot<D>(g, n_tok, [&](int d) {
          return active(d) &&
                 (static_cast<unsigned>(in.qmask[d * st]) & q_active) != 0u;
        });
        if (hit == 0) break;
        const int d = first_bit(hit);
        const int nxt = next_of(d);
        const int qi = first_bit(static_cast<uint32_t>(
            static_cast<unsigned>(in.qmask[d * st]) & q_active));
        word_hits += 1;
        credit(qi, static_cast<float>(lens(d) + lens(nxt)), offsets(d));
        has_joined |= 1u << qi;
        has_prefix |= 1u << qi;
        q_active &= ~(1u << qi);
        d_active &= ~((one << d) | (one << nxt));
      }
    }
  }

  // ---- 3. prefix/suffix -------------------------------------------------
  // The pick among matching doc tokens is by (length descending, index
  // ascending): the largest pick_key.
  if (cfg.cover_prefix_suffix) {
    for (int si = 0; si < n_q; ++si) {
      const int qi = in.qsorted[si * st];
      if (qi < 0 || qi >= nq || !((q_active >> qi) & 1u)) continue;
      const int ql = qlens(qi);
      // 1 prefix, 2 suffix, 3 contained, 4 doc word ends q, 0 none
      const auto kind = [&](int d) {
        const int dl = lens(d);
        if (dl == ql) return 0;
        const int w = pair(qi, d);
        if (ql < dl) {
          return (w & kDSwQ) ? 1
                 : (w & kDEwQ) ? 2
                 : (ql >= 4 && (w & kDContQ)) ? 3 : 0;
        }
        return (w & kQEwD) ? 4 : 0;
      };
      const int key = doc_max<D>(g, n_tok, [&](int d) {
        return active(d) && kind(d) != 0 ? pick_key(lens(d), d) : -1;
      });
      if (key < 0) continue;
      const int best = picked(key);
      const int best_kind = kind(best);
      const float qlf = static_cast<float>(ql);
      const float sc = best_kind == 1   ? qlf
                       : best_kind == 2 ? static_cast<float>(imax(ql / 2, 1))
                       : best_kind == 3 ? fmul(qlf, 0.6f)
                                        : static_cast<float>(lens(best));
      word_hits += 1;
      credit(qi, sc, offsets(best));
      if (best_kind == 1) has_prefix |= 1u << qi;
      q_active &= ~(1u << qi);
      d_active &= ~(one << best);
    }
    // the same order over the prefix-window distances
    for (int si = 0; si < n_q; ++si) {
      const int qi = in.qsorted[si * st];
      if (qi < 0 || qi >= nq || !((q_active >> qi) & 1u)) continue;
      const int ql = qlens(qi);
      if (!(ql >= 4 || (qi == in.qcount - 1 && ql >= 2))) continue;
      // the credit of doc token d (longer than the query word), -1: none
      const auto credit_of = [&](int d) {
        const int w = pair(qi, d);
        const int d1 = (w >> kPdam1) & 7, d2 = (w >> kPdam2) & 7,
                  d3 = (w >> kPdam3) & 7;
        return d1 <= 1                ? ql - d1
               : d2 <= 1              ? ql - d2
               : ql > 1 && d3 <= 1    ? ql - 1 - d3
                                      : -1;
      };
      const int key = doc_max<D>(g, n_tok, [&](int d) {
        return active(d) && ql < lens(d) && credit_of(d) >= 0
                   ? pick_key(lens(d), d)
                   : -1;
      });
      if (key < 0) continue;
      const int best = picked(key);
      word_hits += 1;
      credit(qi, fmax_(static_cast<float>(credit_of(best)), 0.1f),
             offsets(best));
      q_active &= ~(1u << qi);
      d_active &= ~(one << best);
    }
  }

  // ---- 4. fuzzy word ----------------------------------------------------
  if (cfg.cover_fuzzy_words) {
    grp::sync(g);   // the leader's term_matched, for every lane
    // taken once, from the state after stage 3
    const bool all_full = grp::all(g, n_q, [&](int i) {
      const int ql = qlens(i);
      return ql <= 0 || tm[i * st] >= static_cast<float>(ql) ||
             !(i < in.qcount);
    });
    const int max_q_len = grp::max_int(g, [&](int l) {
      int m = 0;
      for (int i = l; i < n_q; i += G) {
        if ((q_active >> i) & 1u) m = imax(m, qlens(i));
      }
      return m;
    });
    bool special_global;
    const int max_edit = typo_budget(max_q_len, cfg, special_global);
    for (int edit_dist = 1; edit_dist <= 2; ++edit_dist) {
      if (edit_dist > cfg.num_typos) break;
      if (!(edit_dist <= max_edit) || all_full) continue;
      const int shift = edit_dist == 1 ? kDam1 : kDam2;
      for (int i = 0; i < nq; ++i) {
        if (!((q_active >> i) & 1u)) continue;
        const int ql = qlens(i);
        if (cfg.min_word_size > 0 && ql < cfg.min_word_size) continue;
        bool special;
        const int token_max = typo_budget(ql, cfg, special);
        if (edit_dist > token_max || (edit_dist != 1 && special)) continue;
        const int min_len = imax(ql - edit_dist, cfg.min_word_size);
        const int max_len =
            imin(imin(ql + edit_dist, cfg.levenshtein_max_word_size), 63);
        const int q_first = in.qfirst[i * st];
        const M hit = doc_ballot<D>(g, n_tok, [&](int d) {
          if (!active(d)) return false;
          const int dl = lens(d);
          if (dl < min_len || dl > max_len) return false;
          if (special && !(dl > 0 && in.first_char[d * st] == q_first)) {
            return false;
          }
          return ((pair(i, d) >> shift) & 7) <= edit_dist;
        });
        if (hit == 0) continue;
        const int j = first_bit(hit);
        const int dist = (pair(i, j) >> shift) & 7;
        word_hits += 1;
        credit(i, static_cast<float>(ql - dist), offsets(j));
        q_active &= ~(1u << i);
        d_active &= ~(one << j);
      }
    }
  }

  // ---- the outputs: lanes over query tokens -------------------------------
  grp::sync(g);
  const long long n_c = a.n_c;
  grp::each(g, n_q, [&](int i) {
    const long long at = i * n_c + c;
    a.term_matched[at] = tm[i * st];
    a.first_pos[at] = fp[i * st];
    a.has_whole[at] = (has_whole >> i) & 1u;
    a.has_joined[at] = (has_joined >> i) & 1u;
    a.has_prefix[at] = (has_prefix >> i) & 1u;
  });
  if (lead) {
    a.word_hits[c] = word_hits;
    a.cov_count[c] = bit_count(cov);
  }
}

}  // namespace cascade
