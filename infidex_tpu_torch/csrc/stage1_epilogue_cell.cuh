// One pass over a Stage-1 group's [n_q, width] score and count matrices:
// the arithmetic of csrc/stage1_epilogue.cu, in a header of its own so
// that g++ builds the same code for the CPU tests
// (tests/test_torch_stage1_epilogue.py holds it to the plain version,
// index/device.py stage1_epilogue_plain).
//
// For each (q, d), with live = live[d]:
//   with fuzzy groups (has_fz):
//     fz = +0 + fidf[g] * doc_fac[d] + ... over q's groups g, in group-rank
//          order (q_grp[q_off[q]:q_off[q + 1]]), for each g whose
//          presence bit d is set;
//     fc = +0 + 1 + ... over the same groups that also have fidf[g] > 0;
//     scores = scores + fz, cnt = cnt + fc (written back);
//   scores = scores * live (written back), and the row max of cnt * live
//   (an integer max of the f32 bits: cnt and live are not negative, so
//   the bits order as the floats do; rowmax starts at +0).
// Every f32 operation is rounded on its own, in the plain version's order:
// a group whose bit is clear adds +0 there, which changes no sum that
// starts at +0 and only grows, so skipping it is exact.

#pragma once

#include "block_steps.cuh"

namespace epi {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kPer = 4;                     // docs a lane takes
constexpr int kDocs = kThreads * kPer;      // docs a block takes (1024)

struct Args {
  float* scores;                // [n_q, width], in place
  float* cnt;                   // [n_q, width], in place
  long long width;
  int n_q;
  const float* live;            // [width]
  const unsigned* bits;         // [n_grp, words] presence (has_fz)
  long long words;
  const float* fidf;            // [n_grp]
  const float* doc_fac;         // [width]
  const int* q_off;             // [n_q + 1]
  const int* q_grp;             // groups of each query, in rank order
  int has_fz;
  int* rowmax;                  // [n_q] f32 bits of max(cnt * live)
};

struct Shared {
  int part[kWarps];
};

// The docs [b * kDocs, (b + 1) * kDocs) of row q.
GRP_HD void block(const Args& a, int q, long long b, Shared* sh) {
  float* srow = a.scores + q * a.width;
  float* crow = a.cnt + q * a.width;
  const int g0 = a.has_fz ? a.q_off[q] : 0;
  const int g1 = a.has_fz ? a.q_off[q + 1] : 0;
  blk::step(kWarps, [&](const blk::Warp& g, int w) {
    blk::Lanes<int> best;
    blk::lanes(g, [&](int l) {
      int m = 0;   // the bits of +0.0f
#pragma unroll
      for (int j = 0; j < kPer; ++j) {
        const long long d = b * kDocs + j * kThreads + w * 32 + l;
        if (d >= a.width) continue;
        float s = srow[d], c = crow[d];
        const float live = a.live[d];
        if (a.has_fz) {
          float fz = 0.0f, fc = 0.0f;
          for (int i = g0; i < g1; ++i) {
            const int grp_id = a.q_grp[i];
            if (!blk::bit_of(a.bits + grp_id * a.words, d)) continue;
            const float f = a.fidf[grp_id];
            fz = blk::fadd(fz, blk::fmul(f, a.doc_fac[d]));
            if (f > 0.0f) fc = blk::fadd(fc, 1.0f);
          }
          s = blk::fadd(s, fz);
          c = blk::fadd(c, fc);
          crow[d] = c;
        }
        srow[d] = blk::fmul(s, live);
        const int cl = static_cast<int>(blk::float_bits(blk::fmul(c, live)));
        m = cl > m ? cl : m;
      }
      best[l] = m;
    });
    const int m = grp::max_int(g, [&](int l) { return best[l]; });
    if (grp::leader(g)) sh->part[w] = m;
  });
  blk::step(kWarps, [&](const blk::Warp& g, int w) {
    if (w != 0 || !grp::leader(g)) return;
    int m = sh->part[0];
    for (int v = 1; v < kWarps; ++v) m = sh->part[v] > m ? sh->part[v] : m;
    blk::atomic_max(a.rowmax + q, m);
  });
}

}  // namespace epi
