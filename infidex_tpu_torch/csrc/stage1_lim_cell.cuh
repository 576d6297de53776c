// The LIM rows of one query: the arithmetic of csrc/stage1_lim.cu, in a
// header of its own so that g++ builds the same code for the CPU tests
// (tests/test_torch_stage1_epilogue.py holds it to the plain version,
// index/device.py lim_rows_plain).
//
// Row q's top quality class: the ids d < window whose count reaches the
// row threshold, cnt[q, d] * live[d] >= thresh[q] with thresh[q] > 0, or
// that one of q's scoring groups (fidf > 0) covers with its presence bit
// while live[d] > 0 (with fuzzy groups). The row is its k2 lowest such ids
// ascending, each plus id_offset, then `pad` up to k_out. Ids are read in
// order a chunk of kChunk at a time (counts a warp, a prefix over the
// warps, a ballot a warp and 32 ids for the places), and the scan stops
// after the chunk of the k2-th member.

#pragma once

#include "block_steps.cuh"

namespace lim {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr int kPer = 8;                   // ids a lane takes a segment
constexpr int kSeg = 32 * kPer;           // a warp's segment of ids
constexpr int kSegs = 2;                  // a warp's segments a chunk
constexpr int kGroups = 64;               // scoring groups staged a row
constexpr int kChunk = kWarps * kSegs * kSeg;   // a block's ids a round

struct Args {
  const float* cnt;             // [n_q, width]
  long long width;
  int n_q;
  const float* live;            // [width]
  const float* thresh;          // [n_q]
  const unsigned* bits;         // [n_grp, words] presence (has_fz)
  long long words;
  const float* fidf;            // [n_grp]
  const int* q_off;             // [n_q + 1]
  const int* q_grp;
  int has_fz;
  long long window;             // ids below it, at most width
  int k2, k_out, id_offset, pad;
  int* out;                     // [n_q, k_out]
};

struct Shared {
  int found;
  int n_grp;                    // the row's scoring groups, or -1: more
  int grp[kGroups];             // than kGroups, read from q_grp
  int wcnt[kWarps];
};

// Whether id d is in the class, given its count c and live value lv: the
// count reaches the threshold, or a scoring group of the row covers it.
GRP_HD bool member(const Args& a, const Shared* sh, float c, float lv,
                   float thr, int g0, int g1, long long d) {
  if (blk::fmul(c, lv) >= thr && thr > 0.0f) return true;
  if (!(lv > 0.0f)) return false;
  if (sh->n_grp >= 0) {
    for (int i = 0; i < sh->n_grp; ++i) {
      if (blk::bit_of(a.bits + sh->grp[i] * a.words, d)) return true;
    }
    return false;
  }
  for (int i = g0; i < g1; ++i) {
    const int g = a.q_grp[i];
    if (a.fidf[g] > 0.0f && blk::bit_of(a.bits + g * a.words, d)) {
      return true;
    }
  }
  return false;
}

// Row q (a block of kThreads), a chunk of kChunk ids a round: warp w
// counts the members of its kSegs segments (lane counters), then, after a
// prefix over the warps, a warp that holds members below the k2-th places
// them with a ballot a segment row.
GRP_HD void row(const Args& a, int q, Shared* sh) {
  const float* crow = a.cnt + q * a.width;
  const float thr = a.thresh[q];
  const int g0 = a.has_fz ? a.q_off[q] : 0;
  const int g1 = a.has_fz ? a.q_off[q + 1] : 0;
  int* out = a.out + static_cast<long long>(q) * a.k_out;
  const long long n = a.window;
  // the row's scoring groups (fidf > 0), in shared memory when few
  blk::step(kWarps, [&](const blk::Warp& g, int w) {
    if (w != 0 || !grp::leader(g)) return;
    sh->found = 0;
    int k = 0;
    for (int i = g0; i < g1 && k <= kGroups; ++i) {
      const int gi = a.q_grp[i];
      if (!(a.fidf[gi] > 0.0f)) continue;
      if (k < kGroups) sh->grp[k] = gi;
      ++k;
    }
    sh->n_grp = k <= kGroups ? k : -1;
  });
  for (long long c0 = 0; c0 < n; c0 += kChunk) {
    if (sh->found >= a.k2) break;
    blk::step(kWarps, [&](const blk::Warp& g, int w) {
      const long long r0 = c0 + static_cast<long long>(w) * kSegs * kSeg;
      blk::Lanes<int> c;
      blk::lanes(g, [&](int l) {
        c[l] = 0;
        for (int sg = 0; sg < kSegs; ++sg) {
          float cv[kPer], lv[kPer];
#pragma unroll
          for (int j = 0; j < kPer; ++j) {
            const long long d = r0 + sg * kSeg + j * 32 + l;
            cv[j] = d < n ? crow[d] : 0.0f;
            lv[j] = d < n ? a.live[d] : 0.0f;
          }
#pragma unroll
          for (int j = 0; j < kPer; ++j) {
            const long long d = r0 + sg * kSeg + j * 32 + l;
            c[l] += d < n && member(a, sh, cv[j], lv[j], thr, g0, g1, d);
          }
        }
      });
      const int t = blk::sum_int(g, [&](int l) { return c[l]; });
      if (grp::leader(g)) sh->wcnt[w] = t;
    });
    blk::step(kWarps, [&](const blk::Warp& g, int w) {
      int o = sh->found;
      for (int v = 0; v < w; ++v) o += sh->wcnt[v];
      if (sh->wcnt[w] == 0 || o >= a.k2) return;
      const long long r0 = c0 + static_cast<long long>(w) * kSegs * kSeg;
      for (int sg = 0; sg < kSegs && o < a.k2; ++sg) {
#pragma unroll
        for (int j = 0; j < kPer; ++j) {
          const long long s0 = r0 + sg * kSeg + j * 32;
          const unsigned m = grp::ballot(g, [&](int l) {
            const long long d = s0 + l;
            return d < n && member(a, sh, crow[d], a.live[d], thr, g0, g1,
                                   d);
          });
          blk::lanes(g, [&](int l) {
            const int p = o + blk::popc(m & blk::below(l));
            if (((m >> l) & 1u) && p < a.k2) {
              out[p] = static_cast<int>(s0 + l) + a.id_offset;
            }
          });
          o += blk::popc(m);
        }
      }
    });
    blk::step(kWarps, [&](const blk::Warp& g, int w) {
      if (w != 0 || !grp::leader(g)) return;
      for (int v = 0; v < kWarps; ++v) sh->found += sh->wcnt[v];
    });
  }
  const int filled = sh->found < a.k2 ? sh->found : a.k2;
  blk::step(kWarps, [&](const blk::Warp& g, int w) {
    blk::lanes(g, [&](int l) {
      for (int i = filled + w * 32 + l; i < a.k_out; i += kThreads) {
        out[i] = a.pad;
      }
    });
  });
}

}  // namespace lim
