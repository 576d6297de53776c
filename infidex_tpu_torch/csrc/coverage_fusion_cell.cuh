// One candidate of the scorer + fusion program of the coverage program,
// worked by a group of lanes over its doc tokens: the arithmetic of
// csrc/coverage_fusion.cu, in a header of its own so that a host compiler
// can build the same code (the CPU tests compile it with g++
// -ffp-contract=off and hold it against the plain PyTorch version,
// ops/coverage_kernel.py coverage_fusion_plain; the CUDA kernel includes it
// unchanged). The group's collectives are those of csrc/lane_group.cuh:
// warp intrinsics on the card, a loop over the lanes on the host.
//
// candidate<L, D, G> computes, for one candidate with up to D doc tokens
// of up to L chars, from the matcher cascade's state and the pair words:
//
//   1. CoverageScorer   per query token its coverage ci, the idf sums, the
//                       counts of matched, strict and prefix terms, the
//                       first match position, the prefix runs
//   2. FusionSignals    prefix-last, perfect doc, stem evidence, anchor
//                       stem, trailing density, single-term lexical
//                       similarity, single-char last-token boost
//   3. FusionScorer     the precedence bits and the semantic score
//   4. the pack         [2, C] (score, tie<<16 | hits<<8 | lcs) or [3, C]
//
// The G lanes share the doc tokens out (lane l takes d = l, l + G, ...):
// each signal is a test per doc token, combined by a ballot into "any",
// "all", "the first d" or a count, and the single-term similarity is the
// largest of the tokens' values; none of these can depend on the order of
// the lanes. The scorer's and the fusion score's arithmetic runs on every
// lane alike, in the plain order, and its five sums over the query tokens
// add in token order from 0, as one thread did.
//
// What the plain version keeps as [Q, C], [FQ, C] and [D, C] tensors is
// here a bit mask or a scalar per candidate, recomputed from the inputs
// where a second pass needs it. The relation bits of the pair words
// (csrc/edit_distances_cell.cuh) are read directly. A signal the plain
// version computes for every candidate and masks is computed here only
// where the mask holds: the single-term similarity where there is one
// fusion token, stem evidence and the single-char boost where there are
// two or more; and doc tokens at or past tok_count, whose relation bits are
// 0 and which are not valid, are not visited.
//
// The kernel first copies a tile of kTile candidates' rows into shared
// memory (stage, below; coalesced: neighbouring threads read neighbouring
// candidates of a row), as far as the tile's token counts reach; tile_in
// points a candidate's inputs there.
//
// f32: every operation is rounded on its own, in the plain version's
// order (fadd/fsub/fmul/fdiv: __fadd_rn etc. on the card; the host build
// needs -ffp-contract=off); divisions are true divisions; f32 -> int casts
// truncate, as PyTorch's do.

#pragma once

#include "lane_group.cuh"

#if defined(__CUDACC__)
#define FUS_HD __host__ __device__ __forceinline__
#else
#define FUS_HD inline
#endif

namespace fusion {

// bits of a pair word (csrc/edit_distances_cell.cuh)
constexpr int kEq = 1, kDSwQ = 2, kQSwD = 32, kDContQ = 16;
constexpr int kPrefixShift = 8, kDam2Shift = 19;
constexpr int kAnchorStem = 3, kMaxTrailing = 2, kMinSeg = 3;

// The CoverageConfig fields the scorer reads.
struct Config {
  int min_word_size, cover_whole_query;
};

// One candidate's inputs. Candidate-minor rows: the pointer is at the
// candidate's column, rows `stride` apart (the chars `char_stride` apart).
// Per-query tables: the pointer is at the candidate's query's row.
struct In {
  const float* term_matched;     // [Q] the cascade's state ...
  const unsigned char* has_whole;
  const unsigned char* has_joined;
  const unsigned char* has_prefix;
  const int* first_pos;          // ... [Q]
  const int* pairs;              // [D] query token 0's pair words
  const int* fq_pairs;           // [FQ, D] fusion tokens' relations
  const int* lens;               // [D] 0 where invalid
  const unsigned char* adj_ws;   // [D]
  const unsigned char* valid;    // [D]
  long long stride;
  const int* chars;              // [L, D] doc token chars
  const int* chars_rev;          // [L, D] reversed
  long long char_stride;
  int word_hits, cov_count, tok_count, text_len;
  float lcs, base;
  const int* q_lens;             // [Q] of the candidate's query
  const float* q_idf;            // [Q]
  const float* q_widf;           // [Q]
  const int* fq_chars;           // [FQ, L]
  const int* fq_rev;             // [FQ, L]
  const int* fq_lens;            // [FQ]
  int n_q, n_fq;                 // Q and FQ, the tables' widths
  int qcount, fq_count, last_alpha, query_len;
};

// one rounding each, never contracted into a fused multiply-add
FUS_HD float fadd(float a, float b) {
#if defined(__CUDA_ARCH__)
  return __fadd_rn(a, b);
#else
  return a + b;
#endif
}
FUS_HD float fsub(float a, float b) {
#if defined(__CUDA_ARCH__)
  return __fsub_rn(a, b);
#else
  return a - b;
#endif
}
FUS_HD float fmul(float a, float b) {
#if defined(__CUDA_ARCH__)
  return __fmul_rn(a, b);
#else
  return a * b;
#endif
}
FUS_HD float fdiv(float a, float b) {
#if defined(__CUDA_ARCH__)
  return __fdiv_rn(a, b);
#else
  return a / b;
#endif
}
FUS_HD int imin(int a, int b) { return a < b ? a : b; }
FUS_HD int imax(int a, int b) { return a > b ? a : b; }
FUS_HD float fmin_(float a, float b) { return a < b ? a : b; }
FUS_HD float fmax_(float a, float b) { return a > b ? a : b; }
// torch.clamp(x * 255, 0, 255).to(int32)
FUS_HD int byte_of(float x) {
  return static_cast<int>(fmin_(fmax_(fmul(x, 255.0f), 0.0f), 255.0f));
}

// The fusion signals of one candidate.
struct Signals {
  bool lexical_prefix_last = false, perfect_doc = false;
  bool stem_evidence = false, anchor_stem = false;
  int trailing_density = 0, single_sim = 0, single_char_boost = 0;
};

// ComputeSingleTermLexicalSimilarity of the one fusion token q (q_len >= 3)
// against the doc tokens d < n_tok. Each value is finite and at least +0,
// so the largest does not depend on the order the lanes combine them in.
template <int L, int D, int G>
FUS_HD float single_term_sim(const grp::Group<G>& g, const In& in,
                             int n_tok) {
  const long long n_c = in.stride, n_ch = in.char_stride;
  const int* q = in.fq_chars;      // row 0
  const int* q_rev = in.fq_rev;
  const int q_len = in.fq_lens[0];
  const float qlen_f = static_cast<float>(imax(q_len, 1));
  // doc token d's similarity, 0 where it has none
  const auto sim = [&](int d) -> float {
    const int dl = in.lens[d * n_c];
    if (!in.valid[d * n_c] || dl < 2) return 0.0f;
    // one slide over the query's window shifts: the first shift where the
    // doc word lies inside the query, and the longest query suffix that is
    // a prefix of the doc word (the first shift that has one: k falls).
    // The slide stops once neither can change.
    int found = -1, best_k = 0;
    for (int sw = 0; sw < L; ++sw) {
      const int k = q_len - sw;
      if ((found >= 0 || sw + dl > q_len) && (best_k > 0 || k < 2)) break;
      int m = L;   // first mismatch of the shifted query against the word
      for (int l = 0; l < L; ++l) {
        const int qc = sw + l < L ? q[sw + l] : 0;
        if (qc != in.chars[(l * D + d) * n_ch]) {
          m = l;
          break;
        }
      }
      if (found < 0 && m >= imin(dl, L) && sw + dl <= q_len) found = sw;
      if (best_k == 0 && k >= 2 && k <= imin(q_len, dl) && m >= k) best_k = k;
    }
    if (found >= 0) {
      return fmul(fdiv(static_cast<float>(dl), qlen_f),
                  fsub(1.0f, fdiv(static_cast<float>(found), qlen_f)));
    }
    const float ps = fdiv(static_cast<float>(best_k), qlen_f);
    const int dist = (in.pairs[d * n_c] >> kDam2Shift) & 7;
    const float fz =
        dist <= 2 ? fdiv(static_cast<float>(q_len - dist), qlen_f) : 0.0f;
    return fmax_(ps, fz);
  };
  float best = grp::max_of(g, [&](int lane) {
    float b = 0.0f;
    for (int d = lane; d < n_tok; d += G) b = fmax_(b, sim(d));
    return b;
  });
  // two-segment heuristic: the first doc token the query's first seg_len
  // chars start, and the first its last seg_len chars end
  if (q_len >= 2 * kMinSeg) {
    const int seg_len = imin(q_len / 2, 2 * kMinSeg);
    const auto starts = [&](int d, const int* qq, const int* cc) {
      const int dl = in.lens[d * n_c];
      if (!in.valid[d * n_c] || dl < 3) return false;
      const int m3 = imin(imin(seg_len, dl), L);
      for (int l = 0; l < m3; ++l) {
        if (qq[l] != cc[(l * D + d) * n_ch]) return false;
      }
      return true;
    };
    const int pre_i = grp::first(
        g, 0, n_tok, [&](int d) { return starts(d, q, in.chars); });
    const int suf_i = grp::first(
        g, 0, n_tok, [&](int d) { return starts(d, q_rev, in.chars_rev); });
    const float two =
        fmin_(fdiv(static_cast<float>(2 * seg_len), qlen_f), 1.0f);
    if (pre_i < n_tok && suf_i < n_tok && pre_i != suf_i && two > best) {
      best = two;
    }
  }
  return best;
}

template <int L, int D, int G>
FUS_HD Signals fusion_signals(const grp::Group<G>& g, const In& in,
                              const Config& cfg) {
  const long long n_c = in.stride, n_ch = in.char_stride;
#define FUS_FP(f, d) (in.fq_pairs[(static_cast<long long>(f) * D + (d)) * n_c])
  Signals s;
  const int fqn = in.fq_count, tok = in.tok_count;
  if (!(fqn > 0 && tok > 0)) return s;           // `have`
  const int n_tok = imin(tok, D);
  const int n_rows = imin(fqn, in.n_fq);         // fusion tokens with a row
  const int last = fqn - 1;
  const bool last_row = last < in.n_fq;
  const int last_len = last_row ? in.fq_lens[last] : 0;

  // 1. CheckPrefixLastMatch
  if (fqn == 1) {
    s.lexical_prefix_last = grp::any(
        g, n_tok, [&](int d) { return (FUS_FP(0, d) & kDSwQ) != 0; });
  } else {
    bool all_prec = true;
    for (int f = 0; f < imin(fqn - 1, in.n_fq) && all_prec; ++f) {
      all_prec = grp::any(
          g, n_tok, [&](int d) { return (FUS_FP(f, d) & kEq) != 0; });
    }
    s.lexical_prefix_last =
        all_prec && last_row && grp::any(g, n_tok, [&](int d) {
          return (FUS_FP(last, d) & kDSwQ) != 0;
        });
  }

  // 2. PerfectDoc: every valid doc token starts or is started by a token
  s.perfect_doc = grp::all(g, n_tok, [&](int d) {
    if (!in.valid[d * n_c]) return true;
    for (int f = 0; f < n_rows; ++f) {
      if (FUS_FP(f, d) & (kDSwQ | kQSwD)) return true;
    }
    return false;
  });

  // 3. StemEvidence: every unmatched token has a doc token it starts or
  // shares a stem with
  const int min_stem = cfg.min_word_size;
  if (fqn >= 2) {
    int unmatched = 0, evidenced = 0;
    for (int f = 0; f < n_rows; ++f) {
      if (in.fq_lens[f] < min_stem) continue;
      if (grp::any(g, n_tok, [&](int d) {
            return (FUS_FP(f, d) & (kEq | kDSwQ)) != 0;
          })) {
        continue;
      }
      ++unmatched;
      evidenced += grp::any(g, n_tok, [&](int d) {
        const int w = FUS_FP(f, d);
        return in.valid[d * n_c] && in.lens[d * n_c] >= min_stem &&
               ((w & kQSwD) || ((w >> kPrefixShift) & 31) >= min_stem);
      });
    }
    s.stem_evidence = unmatched > 0 && evidenced == unmatched;
  }

  // 4. AnchorStem: the first token's first three chars start a doc token
  if (in.fq_lens[0] >= kAnchorStem && in.lens[0] >= kAnchorStem) {
    s.anchor_stem = grp::any(g, n_tok, [&](int d) {
      if (!in.valid[d * n_c] || in.lens[d * n_c] < kAnchorStem) return false;
      for (int l = 0; l < kAnchorStem; ++l) {
        if (in.chars[(l * D + d) * n_ch] != in.fq_chars[l]) return false;
      }
      return true;
    });
  }

  // 5. TrailingMatchDensity
  if (fqn >= 2 && last_len >= 1 && last_len <= kMaxTrailing) {
    const int m_count = grp::count(g, n_tok, [&](int d) {
      const int w = FUS_FP(last, d);
      return in.valid[d * n_c] &&
             ((w & kDSwQ) || (in.lens[d * n_c] > last_len && (w & kDContQ)));
    });
    if (m_count > 0) {
      const float density = fdiv(static_cast<float>(m_count),
                                 static_cast<float>(imax(tok, 1)));
      s.trailing_density = byte_of(density);
    }
  }

  // 6. SingleTermLexicalSim (one fusion token: coverage token 0, whose
  // Damerau distances the pair words hold)
  if (fqn == 1 && in.fq_lens[0] >= 3) {
    s.single_sim = byte_of(single_term_sim<L, D, G>(g, in, n_tok));
  }

  // 7. SingleCharLastTokenBoost: the preceding tokens contained in doc
  // tokens in order, then the last (one letter) starting the next token
  if (fqn >= 2 && last_len == 1 && in.last_alpha) {
    int d_index = 0, first_match = -1;
    bool alive = true;
    for (int i = 0; i < imin(in.n_fq - 1, fqn - 1) && alive; ++i) {
      const int j = grp::first(g, d_index, n_tok, [&](int d) {
        return (FUS_FP(i, d) & kDContQ) != 0;
      });
      alive = j < n_tok;
      if (alive) {
        if (first_match == -1) first_match = j;
        d_index = j;
      }
    }
    const int nxt = d_index + 1;
    if (alive && nxt < D && in.valid[nxt * n_c] &&
        in.chars[nxt * n_ch] ==
            in.fq_chars[static_cast<long long>(last) * L] &&
        in.adj_ws[d_index * n_c]) {
      s.single_char_boost = 8 + imax(16 - first_match, 0) +
                            (in.lens[nxt * n_c] == 1 ? 4 : 0);
    }
  }
#undef FUS_FP
  return s;
}

// One candidate: the group's leader writes its packed result, row r at
// out[r * out_stride]: [score, tie<<16 | hits<<8 | lcs] with packed_lcs,
// else [score, tie, hits].
template <int L, int D, int G>
FUS_HD void candidate(const grp::Group<G>& g, const In& in,
                      const Config& cfg, bool packed_lcs, float* out,
                      long long out_stride) {
  const long long n_c = in.stride;
  const int Q = in.n_q, qcount = in.qcount;

  // ---- CoverageScorer ---------------------------------------------------
  const float lcs_eff = cfg.cover_whole_query ? in.lcs : 0.0f;
  const float qlen_f = static_cast<float>(imax(in.query_len, 1));
  float sum_ci = 0.0f, total_idf = 0.0f, idf_weighted = 0.0f,
        missing_idf = 0.0f;
  int terms_with_any = 0, terms_strict = 0, terms_prefix = 0;
  unsigned has_term = 0u, strict = 0u, prefix_hit = 0u;
  int min_pos = 1 << 30;
  bool any_pos = false;
  for (int i = 0; i < Q; ++i) {
    // slots past the query's tokens add 0 and are not read
    const int ql = i < qcount ? in.q_lens[i] : 0;
    const bool ht = i < qcount && ql > 0;
    const float tm = ht ? in.term_matched[i * n_c] : 0.0f;
    const float tmc = static_cast<float>(ql);
    const float ci = ht ? fmin_(fdiv(tm, fmax_(tmc, 1.0f)), 1.0f) : 0.0f;
    const float idf_h = ht ? in.q_idf[i] : 0.0f;
    sum_ci = fadd(sum_ci, ci);
    total_idf = fadd(total_idf, idf_h);
    idf_weighted = fadd(idf_weighted, fmul(ci, idf_h));
    missing_idf = fadd(missing_idf, ht && ci < 1.0f
                                        ? fmul(fsub(1.0f, ci), in.q_idf[i])
                                        : 0.0f);
    if (!ht) continue;
    has_term |= 1u << i;
    terms_with_any += ci > 0.0f;
    const bool fully = tm >= fsub(tmc, 0.01f);
    if ((in.has_whole[i * n_c] || in.has_joined[i * n_c]) && fully) {
      strict |= 1u << i;
      ++terms_strict;
    }
    if (in.has_prefix[i * n_c]) {
      ++terms_prefix;
      if (tm > 0.0f) prefix_hit |= 1u << i;
    }
    const int fp = in.first_pos[i * n_c];
    if (fp >= 0) {
      any_pos = true;
      min_pos = imin(min_pos, fp);
    }
  }
  const int first_match_index = any_pos ? min_pos : -1;
  const int last_q = imin(imax(qcount - 1, 0), Q - 1);
  const float last_idf = in.q_idf[last_q];
  const float idf_coverage =
      total_idf > 0.0f ? fdiv(idf_weighted, total_idf) : 0.0f;
  const bool type_ahead =
      qcount > 0 && total_idf > 0.0f &&
      fdiv(last_idf, fmax_(total_idf, 1e-30f)) <=
          fdiv(1.0f, static_cast<float>(qcount + 1));
  const float single_lcs_ci = fmin_(fdiv(lcs_eff, qlen_f), 1.0f);
  if (qcount == 1 && in.query_len > 0 && lcs_eff > 0.0f &&
      single_lcs_ci > sum_ci) {
    sum_ci = single_lcs_ci;
  }
  int run = 0, longest_run = 0;
  for (int i = 0; i < Q; ++i) {
    run = (prefix_hit >> i) & 1u ? run + 1 : 0;
    longest_run = imax(longest_run, run);
  }
  int suffix_run = 0;
  bool still = true;
  for (int k = 0; k < Q && k < qcount && still; ++k) {
    const int i = imin(imax(qcount - 1 - k, 0), Q - 1);
    still = (prefix_hit >> i) & 1u;
    suffix_run += still;
  }
  const bool last_token_has_prefix =
      ((prefix_hit >> last_q) & 1u) && qcount >= 1;
  int preceding_strict = 0;
  if (qcount >= 2) {
    for (int i = 0; i < Q; ++i) {
      preceding_strict += ((strict >> i) & 1u) && i < qcount - 1;
    }
  }

  // ---- FusionSignalComputer ---------------------------------------------
  const Signals sig = fusion_signals<L, D, G>(g, in, cfg);

  // ---- FusionScorer -----------------------------------------------------
  const int fqn = in.fq_count;
  const int n = fqn > 0 ? fqn : qcount;
  const bool is_single = n <= 1;
  const int tc = qcount;
  const float tc_f = static_cast<float>(imax(tc, 1));
  const bool is_complete = tc > 0 && terms_with_any == tc;
  const bool is_clean = tc > 0 && terms_prefix == tc;
  const bool is_exact = tc > 0 && terms_strict == tc;
  const bool starts_at_beginning = first_match_index == 0;
  const bool lpl = sig.lexical_prefix_last;
  const bool coverage_prefix_last = tc >= 1 &&
                                    preceding_strict == imax(tc - 1, 0) &&
                                    last_token_has_prefix;
  const bool prefix_last_strong = lpl && coverage_prefix_last;

  int precedence = 0;
  if (!is_single && tc > 0) {
    const int matched = terms_with_any;
    const int tier = matched >= tc       ? 3
                     : matched == tc - 1 ? 2
                     : matched * 2 >= tc ? 1
                                         : 0;
    precedence |= (tier & 3) << 16;
  }
  if (!is_single && is_clean && starts_at_beginning && lpl && is_complete) {
    precedence |= 1 << 15;
  }
  if (!is_single && in.cov_count > 0 && in.word_hits == in.cov_count) {
    precedence |= 1 << 14;
  }

  const float avg_idf =
      total_idf > 0.0f && tc > 0 ? fdiv(total_idf, tc_f) : 0.0f;
  const bool dominance_on = !is_single && tc >= 2;
  bool dominant = false;
  if (dominance_on) {
    float total_power = 0.0f;
    for (int i = 0; i < Q; ++i) {
      const bool ht = (has_term >> i) & 1u;
      const float ci =
          ht ? fmin_(fdiv(in.term_matched[i * n_c],
                          fmax_(static_cast<float>(in.q_lens[i]), 1.0f)),
                     1.0f)
             : 0.0f;
      total_power = fadd(total_power, ht ? fmul(in.q_widf[i], ci) : 0.0f);
    }
    for (int i = 0; i < Q && !dominant; ++i) {
      if (!((has_term >> i) & 1u)) continue;
      const float widf = in.q_widf[i];
      const float ci =
          fmin_(fdiv(in.term_matched[i * n_c],
                     fmax_(static_cast<float>(in.q_lens[i]), 1.0f)),
                1.0f);
      const float power = fmul(widf, ci);
      dominant = ci > 0.1f && widf > 0.0f && widf >= avg_idf &&
                 power >= fsub(total_power, power);
    }
  }
  const bool strong_anchor =
      sig.anchor_stem && in.q_widf[0] >= avg_idf && dominance_on;
  if (dominant || strong_anchor) precedence |= 1 << 13;
  const int unmatched_terms = tc - terms_with_any;
  if (dominant && unmatched_terms == 1) precedence |= 8;

  if (is_single) {
    const int st_tier =
        !is_complete ? 0
        : starts_at_beginning ? (is_exact ? 4 : is_clean ? 3 : 0)
                              : (is_exact ? 2 : is_clean ? 1 : 0);
    precedence |= (is_complete ? 1 << 17 : 0) |
                  (is_clean && tc > 0 ? 1 << 16 : 0) | (st_tier << 3);
  } else {
    const bool anchor_run = sig.anchor_stem && longest_run >= 2;
    const int mt_tier = prefix_last_strong ? 3
                        : lpl              ? 2
                        : (sig.perfect_doc || anchor_run) ? 1
                                                          : 0;
    precedence |= mt_tier + (fqn > tc ? sig.single_char_boost : 0);
  }

  const float coverage_ratio =
      tc > 0 ? fdiv(static_cast<float>(terms_with_any), tc_f) : 0.0f;
  const bool has_partial = coverage_ratio > 0.0f && coverage_ratio < 1.0f;
  const bool last_matched =
      last_token_has_prefix || (tc > 0 && terms_with_any == tc);
  const bool can_boost = (last_matched || !type_ahead) && total_idf > 0.0f;
  const float missing_ratio = fdiv(missing_idf, fmax_(total_idf, 1e-30f));
  const float term_gap = fsub(1.0f, coverage_ratio);
  const bool info_boost =
      unmatched_terms == 1 && can_boost && missing_ratio < term_gap;
  if (has_partial && n >= 2 && (sig.stem_evidence || info_boost)) {
    precedence |= 8;
  }

  const float avg_ci = tc > 0 ? fdiv(sum_ci, tc_f) : 0.0f;
  float semantic;
  if (is_single) {
    const float lexical_sim =
        fdiv(static_cast<float>(sig.single_sim), 255.0f);
    semantic = fdiv(fadd(avg_ci, lexical_sim), 2.0f);
  } else if (in.cov_count == 0) {
    semantic = avg_ci;
  } else {
    const bool use_idf_cov = has_partial && unmatched_terms == 1 &&
                             can_boost && idf_coverage > coverage_ratio;
    const float base_cov = use_idf_cov ? idf_coverage : avg_ci;
    const float density = fdiv(static_cast<float>(in.word_hits),
                               static_cast<float>(imax(in.cov_count, 1)));
    float sem_multi = fmul(base_cov, density);
    const int signals = static_cast<int>(sig.anchor_stem) + (suffix_run >= 2);
    if (tc >= 3 && signals > 0) {
      sem_multi = fmin_(
          fadd(sem_multi, fmul(0.15f, static_cast<float>(signals))), 1.0f);
    }
    const float t_density =
        fdiv(static_cast<float>(sig.trailing_density), 255.0f);
    if (tc >= 2 && t_density > 0.0f) {
      sem_multi =
          fadd(sem_multi, fmul(fsub(1.0f, sem_multi), t_density));
    }
    semantic = sem_multi;
  }
  const float coverage_gap = fsub(1.0f, coverage_ratio);
  if (has_partial && in.base >= coverage_gap) {
    semantic = fadd(fmul(coverage_ratio, semantic),
                    fmul(coverage_gap, in.base));
  }
  semantic = fmin_(fmax_(semantic, 0.0f), 0.999f);

  const float focus =
      fmin_(fdiv(static_cast<float>(in.query_len),
                 static_cast<float>(imax(in.text_len, 1))),
            1.0f);
  const int tiebreaker =
      n >= 2 && in.text_len > 0 ? static_cast<int>(fmul(focus, 255.0f)) : 0;
  const float score = fadd(static_cast<float>(precedence), semantic);

  // ---- the pack ---------------------------------------------------------
  if (!grp::leader(g)) return;
  out[0] = score;
  if (packed_lcs) {
    const int hits = imin(imax(in.word_hits, 0), 255);
    const int lcs = static_cast<int>(fmin_(fmax_(in.lcs, 0.0f), 255.0f));
    out[out_stride] = static_cast<float>(tiebreaker * 65536 + hits * 256 + lcs);
  } else {
    out[out_stride] = static_cast<float>(tiebreaker);
    out[2 * out_stride] = static_cast<float>(in.word_hits);
  }
}

// The flat arguments of a block: candidate-minor tensors of C columns
// and per-query tables of B rows (see csrc/coverage_fusion.cu).
struct Args {
  const float* term_matched;
  const unsigned char *has_whole, *has_joined, *has_prefix;
  const int* first_pos;
  const int* word_hits;
  const int* cov_count;
  const int* pairs;
  const int* fq_pairs;
  const int *chars, *chars_rev, *lens;
  const unsigned char *adj_ws, *valid;
  const int *tok_count, *text_len;
  const int* q_lens;
  const float *q_idf, *q_widf;
  const int* q_count;
  const int *fq_chars, *fq_rev, *fq_lens, *fq_count;
  const unsigned char* last_alpha;
  const int* query_len;
  const long long* qsel;
  const float *lcs, *base;
  int n_q, n_fq, n_c, packed_lcs;
  Config cfg;
  float* out;   // [2 or 3, C]
};

// ---- the tile --------------------------------------------------------------
// kTile candidates' rows in shared memory. Candidate-minor rows are
// [rows][kRow] (kRow = kTile + 1: lanes over doc tokens and neighbouring
// candidates fall into different banks); the per-query rows of a candidate
// are contiguous, [kTile][width + 1]. Ints first, then bytes. Eight, not
// four: on an H100 a tile of four, with twice the blocks, was slower on
// five of seven blocks measured, 3 % faster on one of 907 candidates
// (114 blocks of eight) and no faster on one of 118 (PERF.md).

constexpr int kTile = 8;
constexpr int kRow = kTile + 1;

struct Layout {
  // offsets in ints
  int term_matched, first_pos, pairs, fq_pairs, lens, q_lens, q_idf, q_widf,
      fq_lens, ints;
  // offsets in bytes past the ints
  int has_whole, has_joined, has_prefix, adj_ws, valid, bytes;
};

template <int D>
FUS_HD Layout layout(int n_q, int n_fq) {
  Layout y;
  y.term_matched = 0;
  y.first_pos = y.term_matched + n_q * kRow;
  y.pairs = y.first_pos + n_q * kRow;
  y.fq_pairs = y.pairs + D * kRow;
  y.lens = y.fq_pairs + n_fq * D * kRow;
  y.q_lens = y.lens + D * kRow;
  y.q_idf = y.q_lens + kTile * (n_q + 1);
  y.q_widf = y.q_idf + kTile * (n_q + 1);
  y.fq_lens = y.q_widf + kTile * (n_q + 1);
  y.ints = y.fq_lens + kTile * (n_fq + 1);
  y.has_whole = 0;
  y.has_joined = y.has_whole + n_q * kRow;
  y.has_prefix = y.has_joined + n_q * kRow;
  y.adj_ws = y.has_prefix + n_q * kRow;
  y.valid = y.adj_ws + D * kRow;
  y.bytes = 4 * y.ints + y.valid + D * kRow;
  return y;
}

// Thread `tid` of `n_threads` copies its share of the rows that candidates
// c0 .. c0 + kTile (those below C) read into the tile `smem`: the query
// slots below the tile's largest query-token count (at least one), the
// fusion-token rows below its largest fusion-token count, and the doc
// tokens below its largest token count and the one after it (the
// single-char boost tests the token after a match).
template <int D>
FUS_HD void stage(const Args& a, int c0, int tid, int n_threads, int* smem) {
  const int width = imin(kTile, a.n_c - c0);
  int max_tok = 0, max_q = 0, max_fq = 0;
  for (int t = 0; t < width; ++t) {
    const long long b = a.qsel[c0 + t];
    max_tok = imax(max_tok, a.tok_count[c0 + t]);
    max_q = imax(max_q, a.q_count[b]);
    max_fq = imax(max_fq, a.fq_count[b]);
  }
  const int n_q = a.n_q, n_fq = a.n_fq;
  const int rows_q = imin(imax(max_q, 1), n_q);
  const int rows_fq = imin(max_fq, n_fq);
  const int rows_tok = imin(max_tok, D);
  const int rows_d = imin(rows_tok + 1, D);
  const long long n_c = a.n_c;
  const Layout y = layout<D>(n_q, n_fq);
  // the words: rows [0, n_rows) of a candidate-minor tensor, rows
  // `row_stride` apart, every copy in flight at once
  const auto rows = [&](auto* dst, const auto* src, int n_rows,
                        long long row_stride) {
    for (int i = tid; i < n_rows * kTile; i += n_threads) {
      const int r = i / kTile, t = i % kTile;
      if (t < width) {
        grp::copy_async(dst + r * kRow + t, src + r * row_stride + c0 + t);
      }
    }
  };
  rows(reinterpret_cast<float*>(smem + y.term_matched), a.term_matched,
       rows_q, n_c);
  rows(smem + y.first_pos, a.first_pos, rows_q, n_c);
  rows(smem + y.pairs, a.pairs, rows_tok, n_c);        // query token 0's
  rows(smem + y.lens, a.lens, rows_d, n_c);
  // fusion-token relations (f, d), f < rows_fq, d < rows_tok
  for (int i = tid; i < rows_fq * rows_tok * kTile; i += n_threads) {
    const int r = i / kTile, t = i % kTile;
    const int row = (r / rows_tok) * D + r % rows_tok;
    if (t < width) {
      grp::copy_async(smem + y.fq_pairs + row * kRow + t,
                      a.fq_pairs + row * n_c + c0 + t);
    }
  }
  // the candidates' query rows
  for (int i = tid; i < width * rows_q; i += n_threads) {
    const int t = i / rows_q, k = i % rows_q;
    const long long at = a.qsel[c0 + t] * n_q + k;
    const int to = t * (n_q + 1) + k;
    grp::copy_async(smem + y.q_lens + to, a.q_lens + at);
    grp::copy_async(reinterpret_cast<float*>(smem + y.q_idf) + to,
                    a.q_idf + at);
    grp::copy_async(reinterpret_cast<float*>(smem + y.q_widf) + to,
                    a.q_widf + at);
  }
  for (int i = tid; i < width * rows_fq; i += n_threads) {
    const int t = i / rows_fq, k = i % rows_fq;
    grp::copy_async(smem + y.fq_lens + t * (n_fq + 1) + k,
                    a.fq_lens + a.qsel[c0 + t] * n_fq + k);
  }
  // the byte rows (three flags of each query slot, adjacency and validity
  // of each doc token): kBatch loads of a thread, then their stores
  unsigned char* bytes = reinterpret_cast<unsigned char*>(smem + y.ints);
  const auto src_row = [&](int which) {
    return which == 0   ? a.has_whole
           : which == 1 ? a.has_joined
           : which == 2 ? a.has_prefix
           : which == 3 ? a.adj_ws
                        : a.valid;
  };
  const auto dst_row = [&](int which) {
    return which == 0   ? y.has_whole
           : which == 1 ? y.has_joined
           : which == 2 ? y.has_prefix
           : which == 3 ? y.adj_ws
                        : y.valid;
  };
  const int n_bytes = (3 * rows_q + 2 * rows_d) * kTile;
  constexpr int kBatch = 4;
  for (int i0 = tid; i0 < n_bytes; i0 += kBatch * n_threads) {
    unsigned char v[kBatch];
    int to[kBatch];
#pragma unroll
    for (int k = 0; k < kBatch; ++k) {
      const int i = i0 + k * n_threads;
      const int g = i / kTile, t = i % kTile;
      // row g of the five: rows_q of each flag, then rows_d of the two
      const int which = g < 3 * rows_q ? g / rows_q
                                       : 3 + (g - 3 * rows_q) / rows_d;
      const int r = g < 3 * rows_q ? g % rows_q : (g - 3 * rows_q) % rows_d;
      to[k] = i < n_bytes && t < width ? dst_row(which) + r * kRow + t : -1;
      v[k] = to[k] >= 0 ? src_row(which)[r * n_c + c0 + t] : 0;
    }
#pragma unroll
    for (int k = 0; k < kBatch; ++k) {
      if (to[k] >= 0) bytes[to[k]] = v[k];
    }
  }
  grp::copy_wait();
}

// Candidate c0 + t's inputs: its rows in the tile `smem` (after stage),
// its chars and scalars in place.
template <int L, int D>
FUS_HD In tile_in(const Args& a, const int* smem, int c0, int t) {
  const Layout y = layout<D>(a.n_q, a.n_fq);
  const unsigned char* bytes =
      reinterpret_cast<const unsigned char*>(smem + y.ints);
  const int c = c0 + t;
  const long long b = a.qsel[c];
  In in;
  in.term_matched = reinterpret_cast<const float*>(smem + y.term_matched) + t;
  in.has_whole = bytes + y.has_whole + t;
  in.has_joined = bytes + y.has_joined + t;
  in.has_prefix = bytes + y.has_prefix + t;
  in.first_pos = smem + y.first_pos + t;
  in.pairs = smem + y.pairs + t;
  in.fq_pairs = smem + y.fq_pairs + t;
  in.lens = smem + y.lens + t;
  in.adj_ws = bytes + y.adj_ws + t;
  in.valid = bytes + y.valid + t;
  in.stride = kRow;
  in.chars = a.chars + c;
  in.chars_rev = a.chars_rev + c;
  in.char_stride = a.n_c;
  in.word_hits = a.word_hits[c];
  in.cov_count = a.cov_count[c];
  in.tok_count = a.tok_count[c];
  in.text_len = a.text_len[c];
  in.lcs = a.lcs[c];
  in.base = a.base[c];
  in.q_lens = smem + y.q_lens + t * (a.n_q + 1);
  in.q_idf = reinterpret_cast<const float*>(smem + y.q_idf) + t * (a.n_q + 1);
  in.q_widf =
      reinterpret_cast<const float*>(smem + y.q_widf) + t * (a.n_q + 1);
  in.fq_chars = a.fq_chars + b * a.n_fq * L;
  in.fq_rev = a.fq_rev + b * a.n_fq * L;
  in.fq_lens = smem + y.fq_lens + t * (a.n_fq + 1);
  in.n_q = a.n_q;
  in.n_fq = a.n_fq;
  in.qcount = a.q_count[b];
  in.fq_count = a.fq_count[b];
  in.last_alpha = a.last_alpha[b];
  in.query_len = a.query_len[b];
  return in;
}

}  // namespace fusion
