// The LIM rows of one query, served by a cluster of blocks: the arithmetic
// of csrc/stage1_lim.cu, in a header of its own so that g++ builds the same
// code for the CPU tests (tests/test_torch_stage1_epilogue.py holds it to
// the plain version, index/device.py lim_rows_plain).
//
// Row q's top quality class: the ids d < window whose count reaches the
// row threshold, cnt[q, d] * live[d] >= thresh[q] with thresh[q] > 0, or
// that one of q's scoring groups (fidf > 0) covers with its presence bit
// while live[d] > 0 (with fuzzy groups). The row is its k2 lowest such ids
// ascending, each plus id_offset, then `pad` up to k_out.
//
// The window is cut into `slices` id-ordered slices, one block each, the
// blocks of one cluster (cluster_steps.cuh). Three steps:
//
// 1. Each block stages the row's scoring groups and clears its counts.
// 2. Each block reads its slice in order, a chunk of kChunk ids at a time
//    (counts a warp with lane counters, a prefix over the warps, a ballot a
//    warp and 32 ids for the places, a segment's loads issued before its
//    ballots), keeps its first k2 members in id order in a list, and
//    pushes its count of members so far to every block. It stops after
//    the chunk of its own k2-th member, or as soon as the slices before it
//    hold k2 members between them (by the counts they pushed: a dense
//    class reads little more than its first chunks, a small one reads its
//    window once, its slices at once).
// 3. Each block writes its list at the members of the slices before it
//    (their final counts), as far as k2; the blocks write the pads.

#pragma once

#include "cluster_steps.cuh"

namespace lim {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kPer = 8;                   // ids a lane takes a segment
constexpr int kSeg = 32 * kPer;           // a warp's segment of ids
constexpr int kSegs = 2;                  // a warp's segments a chunk
constexpr int kGroups = 64;               // scoring groups staged a row
constexpr int kChunk = kWarps * kSegs * kSeg;   // a block's ids a round
constexpr int kListKeys = 1024;           // a list in shared memory, at most
constexpr int kMaxSlices = 16;

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
  int slices;                   // blocks a row: 1, 2, 4, 8 or 16
  int list_keys;                // lists in shared memory up to this many
                                // (<= kListKeys); a larger k2: scratch
  int* scratch;                 // [n_q, slices, k2] when k2 > list_keys
};

struct Shared {
  int found;                    // this block's members so far
  int stop;
  int n_grp;                    // the row's scoring groups, or -1: more
  int grp[kGroups];             // than kGroups, read from q_grp
  int wcnt[kWarps];
  int found_of[kMaxSlices];     // pushed by each block
  int list[kListKeys];          // this block's first members
};

// What the kernel takes beyond the wrapper's checks: a cluster size, and a
// scratch where the lists do not fit shared memory.
GRP_HD bool args_ok(int slices, int list_keys, int k2, const int* scratch) {
  return clu::slices_ok(slices) && list_keys >= 0
         && list_keys <= kListKeys && (k2 <= list_keys || scratch != nullptr);
}

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

// The leader of warp 0 runs f (block-uniform state), then a barrier.
template <class F>
GRP_HD void lead(const F& f) {
  blk::step(kWarps, [&](const blk::Warp& g, int w) {
    if (w == 0 && grp::leader(g)) f();
  });
}

using Cl = clu::Cluster<Shared>;

// Row q (a cluster of a.slices blocks of kThreads).
GRP_HD void row(const Args& a, int q, const Cl& cl) {
  const float* crow = a.cnt + q * a.width;
  const float thr = a.thresh[q];
  const int g0 = a.has_fz ? a.q_off[q] : 0;
  const int g1 = a.has_fz ? a.q_off[q + 1] : 0;
  int* out = a.out + static_cast<long long>(q) * a.k_out;
  const int nc = cl.size;
  // 1. the row's scoring groups (fidf > 0), in shared memory when few
  clu::step(cl, [&](int, Shared* sh) {
    lead([&] {
      sh->found = 0;
      sh->stop = 0;
      for (int p = 0; p < nc; ++p) sh->found_of[p] = 0;
      int k = 0;
      for (int i = g0; i < g1 && k <= kGroups; ++i) {
        const int gi = a.q_grp[i];
        if (!(a.fidf[gi] > 0.0f)) continue;
        if (k < kGroups) sh->grp[k] = gi;
        ++k;
      }
      sh->n_grp = k <= kGroups ? k : -1;
    });
  });
  // 2. each block's slice, in order, to its k2-th member
  clu::step(cl, [&](int b, Shared* sh) {
    long long lo, hi;
    clu::slice_of(a.window, nc, b, kSegs * kSeg, &lo, &hi);
    int* list = a.k2 <= a.list_keys
                    ? sh->list
                    : a.scratch + (static_cast<long long>(q) * nc + b) * a.k2;
    // whether this block may stop: its own k2 members, or k2 in the
    // slices before it
    const auto may_stop = [&] {
      int before = 0;
      for (int p = 0; p < b; ++p) before += clu::read_live(sh->found_of + p);
      sh->stop = sh->found >= a.k2 || before >= a.k2;
    };
    lead(may_stop);
    for (long long c0 = lo; c0 < hi && !sh->stop; c0 += kChunk) {
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
              cv[j] = d < hi ? crow[d] : 0.0f;
              lv[j] = d < hi ? a.live[d] : 0.0f;
            }
#pragma unroll
            for (int j = 0; j < kPer; ++j) {
              const long long d = r0 + sg * kSeg + j * 32 + l;
              c[l] += d < hi && member(a, sh, cv[j], lv[j], thr, g0, g1, d);
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
          // the segment's loads issued together, ahead of the places
          blk::Lanes<float> cv[kPer], lv[kPer];
          blk::lanes(g, [&](int l) {
#pragma unroll
            for (int j = 0; j < kPer; ++j) {
              const long long d = r0 + sg * kSeg + j * 32 + l;
              cv[j][l] = d < hi ? crow[d] : 0.0f;
              lv[j][l] = d < hi ? a.live[d] : 0.0f;
            }
          });
#pragma unroll
          for (int j = 0; j < kPer; ++j) {
            const long long s0 = r0 + sg * kSeg + j * 32;
            const unsigned m = grp::ballot(g, [&](int l) {
              const long long d = s0 + l;
              return d < hi && member(a, sh, cv[j][l], lv[j][l], thr, g0, g1,
                                      d);
            });
            blk::lanes(g, [&](int l) {
              const int p = o + blk::popc(m & blk::below(l));
              if (((m >> l) & 1u) && p < a.k2) {
                list[p] = static_cast<int>(s0 + l);
              }
            });
            o += blk::popc(m);
          }
        }
      });
      lead([&] {
        for (int v = 0; v < kWarps; ++v) sh->found += sh->wcnt[v];
        for (int p = 0; p < nc; ++p) cl.peer(p)->found_of[b] = sh->found;
        may_stop();
      });
    }
  });
  // 3. the lists at their places, then the pads
  clu::step(cl, [&](int b, Shared* sh) {
    int off = 0, total = 0;
    for (int p = 0; p < nc; ++p) {
      if (p < b) off += sh->found_of[p];
      total += sh->found_of[p];
    }
    if (total > a.k2) total = a.k2;
    const int mine = sh->found < a.k2 - off ? sh->found : a.k2 - off;
    const int* list = a.k2 <= a.list_keys
                          ? sh->list
                          : a.scratch
                                + (static_cast<long long>(q) * nc + b) * a.k2;
    blk::step(kWarps, [&](const blk::Warp& g, int w) {
      blk::lanes(g, [&](int l) {
        for (int i = w * 32 + l; i < mine; i += kThreads) {
          out[off + i] = list[i] + a.id_offset;
        }
        for (long long i = total + static_cast<long long>(b) * kThreads
                           + w * 32 + l;
             i < a.k_out; i += static_cast<long long>(nc) * kThreads) {
          out[i] = a.pad;
        }
      });
    });
  });
}

}  // namespace lim
