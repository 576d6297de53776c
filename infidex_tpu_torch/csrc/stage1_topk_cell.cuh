// The exact stable top-k of one row, served by a cluster of blocks: the
// arithmetic of csrc/stage1_topk.cu, in a header of its own so that g++
// builds the same code for the CPU tests (tests/test_torch_stage1_epilogue.py
// holds it to the plain version, index/device.py stable_top_k_plain).
//
// The k largest of a row of f32 scores by (score desc, id asc), in that
// order, with index/device.py order_keys' total order: the order image
// of a score is an unsigned int that orders as the floats do, -0.0 folded
// into +0.0 first. The row is cut into `slices` id-ordered slices, one
// block each, the blocks of one cluster (cluster_steps.cuh). Four steps:
//
// 1. Select (a radix select on the order image, at most three rounds of
//    12, 12 and 8 bits): each block counts its slice's images that match
//    the prefix found so far into a histogram of the next digit; block b
//    sums bins [b P, (b + 1) P) over the cluster and writes each total into
//    every block's copy, so that every block takes the digit of the k-th
//    largest alike. The first round, the one read of the whole row, also
//    keeps each segment's largest image (a "mark"): later rounds and the
//    compaction read only the segments whose mark can hold what they
//    look for. A round ends the select early ("ge") where every image
//    at or above the digit's bin numbers at most shared_keys, or where the
//    bin holds exactly the ones still to take; the first round also ends
//    it where the bin is +0.0's and holds nothing else (a row with fewer
//    than k positive scores). After it: the set S (images whose chosen top
//    bits lie above the prefix, or at it with ge) of n_sort ids, of which
//    the first k - need are in, and, without ge, the boundary class B
//    (images equal to the 32-bit prefix, the k-th score's), of which the
//    `need` lowest ids are in. Each block knows its own share of S and B
//    from its own histogram, and pushes both to every block.
// 2. Compact: the S ids' keys of each slice go to its block's run (shared
//    memory, or a region of the row's global scratch when larger than
//    run_keys), the marked segments of the whole row shared out over the
//    cluster's blocks, a warp a segment, one count a segment added to the
//    owner's through distributed shared memory; each block's B ids go
//    straight to the output's tail in id order, after the B ids of the
//    slices before it, a chunk of kCompact ids at a time (counts a warp, a
//    prefix over the warps, a ballot a warp and 32 ids for the places)
//    until it has its share.
// 3. Sort each block's run by its 64-bit keys (order image << 32 |
//    2^32 - 1 - id: unique, so no tie is left to order) with a bitonic
//    network over a power of two (pads of 0 sort last); a run in the
//    scratch takes its short strides a shared-memory tile at a time.
// 4. Merge: a key's place in S is its place in its run plus, for every
//    other run, how many of that run's keys are larger (a binary search);
//    the keys placed below k write their ids and scores (the row's own
//    floats, -0.0 kept) to the output's head.
//
// Every combination is by integer counts and prefixes: no order depends
// on timing, so runs repeat bit for bit and any slice count gives the
// same output.

#pragma once

#include <cstddef>

#include "cluster_steps.cuh"

namespace topk {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kPer = 16;                  // ids a lane takes in a segment
constexpr int kSeg = 32 * kPer;           // a warp's segment of ids
constexpr int kChunk = kWarps * kSeg;     // a block's ids a count round
constexpr int kSegs = 4;                  // a warp's segments a B round
constexpr int kCompact = kChunk * kSegs;  // a block's ids a B round
constexpr int kBins = 4096;               // 12-bit digits
constexpr int kGroups = 16;               // bin groups of a warp's bins
constexpr int kMarks = 4096;              // marks of a slice
constexpr int kSharedKeys = 16384;        // S's size at which the select
                                          // may stop, at most
constexpr int kRunKeys = 16384;           // a run in shared memory, at most
constexpr int kMaxSlices = 16;

struct Args {
  const float* scores;            // [n_rows, width]
  long long width;
  int n_rows;
  int k;                          // 1 <= k <= width
  int shared_keys;                // the select stops once S holds at most
                                  // this many (a power of two <=
                                  // kSharedKeys)
  int run_keys;                   // a block sorts up to this many keys in
                                  // shared memory (a power of two <=
                                  // kRunKeys); larger runs: scratch
  int slices;                     // blocks a row: 1, 2, 4, 8 or 16
  unsigned long long* scratch;    // [n_rows, scratch_cols] when needed
  long long scratch_cols;
  float* out_scores;              // [n_rows, k]
  int* out_ids;                   // [n_rows, k]
};

struct State {
  unsigned prefix, pmask;
  int remaining, ge, done, n_sort, need;
  int digit;                      // the k-th's bin this round
  int zeros;                      // this block's +0.0 images this round
  int s_cnt, b_cnt;               // this block's ids of S and of B
  int b_off;                      // B ids of the slices before this one
  int base_s, base_b;             // compaction: S keys appended, B placed
  int mark_shift;                 // a mark covers 2^mark_shift segments
  int step_max;                   // merge: the largest power of two <= the
                                  // longest run's keys that count
  int wtot[kWarps];               // the totals' sum over a warp's bins,
  int gtot[kWarps][kGroups];      // and over each group of them
  int wcnt[kWarps];
  int zeros_of[kMaxSlices];       // pushed by each block
  int s_of[kMaxSlices];
  int b_of[kMaxSlices];
  int len_at[kMaxSlices];         // merge: each run's keys that count
  unsigned long long* run_at[kMaxSlices];   // and where it lies
};

struct Shared {
  State st;
  unsigned marks[kMarks];         // the largest order image of each mark's
                                  // segments of this block's slice
  union {
    struct {
      int hist[kBins];            // this block's counts
      int tot[kBins];             // the cluster's (every block a copy)
    } h;
    unsigned long long keys[kRunKeys];    // this block's run
  } u;
};

// Shared memory a block uses: the state, the marks and the larger of the
// histograms and a run of run_keys keys (the kernel's dynamic size).
GRP_HD int shared_bytes(int run_keys) {
  const int hist = static_cast<int>(sizeof(Shared{}.u.h));
  const int run = 8 * run_keys;
  return static_cast<int>(offsetof(Shared, u)) + (hist > run ? hist : run);
}

// The order image: larger for larger floats, -0.0 as +0.0.
GRP_HD unsigned order_of(float x) {
  unsigned b = blk::float_bits(x);
  if (b == 0x80000000u) b = 0u;
  return (b & 0x80000000u) ? ~b : (b | 0x80000000u);
}

// The order image of +0.0.
constexpr unsigned kZero = 0x80000000u;

GRP_HD unsigned long long key_of(unsigned u, long long id) {
  return (static_cast<unsigned long long>(u) << 32)
         | (0xFFFFFFFFull - static_cast<unsigned long long>(id));
}

GRP_HD long long pow2_at_least(long long n) {
  long long p = 1;
  while (p < n) p <<= 1;
  return p;
}

GRP_HD bool is_pow2(int n) { return n >= 1 && (n & (n - 1)) == 0; }

// The scratch columns a row needs: none where every run fits run_keys (S
// holds at most max(k, shared_keys) ids), else room for every block's run
// at twice its place in S (a run of n keys sorts over pow2(n) <= 2n).
GRP_HD long long scratch_cols_for(int k, int shared_keys, int run_keys) {
  const long long most = k > shared_keys ? k : shared_keys;
  return pow2_at_least(most) <= run_keys ? 0 : 2 * most;
}

// What the kernel takes: 1 <= k <= width; shared_keys and run_keys powers
// of two up to kSharedKeys and kRunKeys; a cluster size; scratch rows of
// at least scratch_cols_for(...) columns where that is not 0.
GRP_HD bool args_ok(long long width, int k, int shared_keys, int run_keys,
                    int slices, const unsigned long long* scratch,
                    long long scratch_cols) {
  const long long need = scratch_cols_for(k, shared_keys, run_keys);
  return k >= 1 && k <= width && is_pow2(shared_keys)
         && shared_keys <= kSharedKeys && is_pow2(run_keys)
         && run_keys <= kRunKeys && clu::slices_ok(slices)
         && (need == 0 || (scratch != nullptr && scratch_cols >= need));
}

// The leader of warp 0 runs f (block-uniform state), then a barrier.
template <class F>
GRP_HD void lead(const F& f) {
  blk::step(kWarps, [&](const blk::Warp& g, int w) {
    if (w == 0 && grp::leader(g)) f();
  });
}

// Membership of an order image: the sorted set S, the boundary class B.
// Both grow with the image, so a segment whose mark (its largest image)
// is out holds none.
GRP_HD bool in_sorted(unsigned u, unsigned prefix, unsigned pmask, int ge) {
  const unsigned t = u & pmask;
  return t > prefix || (ge && t == prefix);
}

GRP_HD bool in_boundary(unsigned u, unsigned prefix, int ge) {
  return !ge && u == prefix;
}

// Whether a segment whose mark is `mark` may hold an image that matches
// the prefix (or, with pmask all ones, B).
GRP_HD bool may_match(unsigned mark, unsigned prefix, unsigned pmask) {
  return (mark & pmask) >= prefix;
}

using Cl = clu::Cluster<Shared>;

// Where a block's run of s_cnt keys lies: in its Shared `sh`, or in its
// region of row r's scratch (at twice its place s_off in S).
GRP_HD unsigned long long* run_of(const Args& a, Shared* sh, int r,
                                  int s_cnt, int s_off) {
  if (pow2_at_least(s_cnt) <= a.run_keys) return sh->u.keys;
  return a.scratch + r * a.scratch_cols + 2LL * s_off;
}

// The mark of the segment at s0 of a slice that starts at lo.
GRP_HD unsigned* mark_of(Shared* sh, long long s0, long long lo) {
  return sh->marks + (static_cast<int>((s0 - lo) / kSeg) >> sh->st.mark_shift);
}

// 1, round `round` (cluster steps): the histograms of the slices, their
// sum over the cluster, the k-th's digit, each block's share of S and B.
GRP_HD void select_round(const Args& a, const float* x, const Cl& cl,
                         int r, int round) {
  const int nc = cl.size;
  const int shift = round == 0 ? 20 : (round == 1 ? 8 : 0);
  const int nbins = round < 2 ? kBins : 256;
  // +0.0's bin holds most of a Stage-1 row: each lane counts it in a
  // register and adds the rest to the shared histogram one by one
  const int hot = static_cast<int>((kZero >> shift) & (nbins - 1));
  clu::step(cl, [&](int b, Shared* sh) {
    State& st = sh->st;
    long long lo, hi;
    clu::slice_of(a.width, nc, b, kSeg, &lo, &hi);
    if (round == 0) {
      lead([&] {
        st.prefix = 0u;
        st.pmask = 0u;
        st.remaining = a.k;
        st.ge = 0;
        st.done = 0;
        st.n_sort = 0;
        st.s_cnt = 0;
        st.b_cnt = 0;
        // the same for every block: a slice's segments over the marks
        const long long n_seg = clu::slice_len(a.width, nc, kSeg) / kSeg;
        int m = 0;
        while (((n_seg - 1) >> m) >= kMarks) ++m;
        st.mark_shift = m;
      });
    }
    const unsigned prefix = st.prefix, pmask = st.pmask;
    blk::step(kWarps, [&](const blk::Warp& g, int w) {
      blk::lanes(g, [&](int l) {
        for (int i = w * 32 + l; i < nbins; i += kThreads) sh->u.h.hist[i] = 0;
        for (int i = w * 32 + l; round == 0 && i < kMarks; i += kThreads) {
          sh->marks[i] = 0u;
        }
      });
      if (w == 0 && grp::leader(g)) st.zeros = 0;
    });
    blk::step(kWarps, [&](const blk::Warp& g, int w) {
      blk::Lanes<int> zeros, in_hot;
      blk::Lanes<unsigned> top;
      blk::lanes(g, [&](int l) { zeros[l] = in_hot[l] = 0; });
      for (long long s0 = lo + static_cast<long long>(w) * kSeg; s0 < hi;
           s0 += kChunk) {
        unsigned* mark = mark_of(sh, s0, lo);
        if (round > 0 && !may_match(*mark, prefix, pmask)) continue;
        blk::lanes(g, [&](int l) {
          float v[kPer];
#pragma unroll
          for (int j = 0; j < kPer; ++j) {
            const long long i = s0 + j * 32 + l;
            v[j] = i < hi ? x[i] : 0.0f;
          }
          unsigned m = 0u;
#pragma unroll
          for (int j = 0; j < kPer; ++j) {
            if (s0 + j * 32 + l >= hi) continue;
            const unsigned u = order_of(v[j]);
            m = u > m ? u : m;
            if ((u & pmask) != prefix) continue;
            zeros[l] += u == kZero;
            const int d = static_cast<int>((u >> shift) & (nbins - 1));
            if (d == hot) {
              ++in_hot[l];
            } else {
              blk::atomic_add(sh->u.h.hist + d, 1);
            }
          }
          top[l] = m;
        });
        if (round == 0) {
          const unsigned m = blk::max_uint(g, [&](int l) { return top[l]; });
          if (grp::leader(g)) blk::atomic_max(mark, m);
        }
      }
      const int z = blk::sum_int(g, [&](int l) { return zeros[l]; });
      const int h = blk::sum_int(g, [&](int l) { return in_hot[l]; });
      if (grp::leader(g)) {
        blk::atomic_add(&st.zeros, z);
        blk::atomic_add(sh->u.h.hist + hot, h);
      }
    });
    lead([&] {
      for (int p = 0; p < nc; ++p) cl.peer(p)->st.zeros_of[b] = st.zeros;
    });
  });
  // block b's share of the bins, summed over the cluster, into every
  // block's totals
  clu::step(cl, [&](int b, Shared*) {
    const int per = nbins / nc;
    blk::step(kWarps, [&](const blk::Warp& g, int w) {
      blk::lanes(g, [&](int l) {
        for (int i = b * per + w * 32 + l; i < (b + 1) * per;
             i += kThreads) {
          int t = 0;
          for (int p = 0; p < nc; ++p) t += cl.peer(p)->u.h.hist[i];
          for (int p = 0; p < nc; ++p) cl.peer(p)->u.h.tot[i] = t;
        }
      });
    });
  });
  // every block: the k-th's bin from its totals (a warp's bins, a group's,
  // a bin's, from the top); its own ids above it
  clu::step(cl, [&](int b, Shared* sh) {
    State& st = sh->st;
    const int per = nbins / kWarps;
    const int gs = per / kGroups;
    blk::step(kWarps, [&](const blk::Warp& g, int w) {
      blk::Lanes<int> part;
      blk::lanes(g, [&](int l) {
        part[l] = 0;
        if (l >= kGroups) return;
        for (int i = 0; i < gs; ++i) {
          part[l] += sh->u.h.tot[w * per + l * gs + i];
        }
        st.gtot[w][l] = part[l];
      });
      const int t = blk::sum_int(g, [&](int l) { return part[l]; });
      if (grp::leader(g)) st.wtot[w] = t;
    });
    lead([&] {
      int rem = st.remaining, above = 0, ww = kWarps - 1, gg = kGroups - 1;
      for (; ww > 0; --ww) {
        if (above + st.wtot[ww] >= rem) break;
        above += st.wtot[ww];
      }
      for (; gg > 0; --gg) {
        if (above + st.gtot[ww][gg] >= rem) break;
        above += st.gtot[ww][gg];
      }
      int d = ww * per + (gg + 1) * gs - 1;
      for (; d > ww * per + gg * gs; --d) {
        if (above + sh->u.h.tot[d] >= rem) break;
        above += sh->u.h.tot[d];
      }
      rem -= above;
      const int c = sh->u.h.tot[d];
      int zeros = 0;
      for (int p = 0; p < nc; ++p) zeros += st.zeros_of[p];
      st.digit = d;
      st.prefix |= static_cast<unsigned>(d) << shift;
      st.pmask |= static_cast<unsigned>(nbins - 1) << shift;
      st.remaining = rem;
      // every image at or above the bin is few enough (or the bin holds
      // just the ones still to take): S is all of them
      st.ge = c == rem || a.k - rem + c <= a.shared_keys;
      st.n_sort = a.k - rem + c;
      // the bin is +0.0's and holds nothing else: the k-th score is +0.0
      const bool zero = round == 0 && d == hot && zeros == c;
      if (zero && !st.ge) st.prefix = kZero, st.pmask = 0xFFFFFFFFu;
      st.done = st.ge || zero || shift == 0;
    });
    // this block's images above the bin (in S), by warp
    const int d = st.digit;
    blk::step(kWarps, [&](const blk::Warp& g, int w) {
      const int t = blk::sum_int(g, [&](int l) {
        int s = 0;
        for (int i = w * per + l; i < (w + 1) * per; i += 32) {
          s += i > d ? sh->u.h.hist[i] : 0;
        }
        return s;
      });
      if (grp::leader(g)) st.wcnt[w] = t;
    });
    lead([&] {
      for (int w = 0; w < kWarps; ++w) st.s_cnt += st.wcnt[w];
      if (!st.done) return;
      // the bin's own ids: all in S with ge, else B (the 32-bit class, or
      // +0.0's alone)
      const int c_own = sh->u.h.hist[d];
      st.base_s = 0;              // the compaction appends to these
      st.base_b = 0;              // from every block of the cluster
      if (st.ge) {
        st.s_cnt += c_own;
        st.need = 0;
      } else {
        st.b_cnt = c_own;
        st.need = st.remaining;
        st.n_sort = a.k - st.need;
      }
      for (int p = 0; p < nc; ++p) {
        cl.peer(p)->st.s_of[b] = st.s_cnt;
        cl.peer(p)->st.b_of[b] = st.b_cnt;
      }
    });
    STAGE1_STAMP(r, b, round);
  });
}

// Where the run of slice o's block lies (run_of from the counts every
// block pushed).
GRP_HD unsigned long long* run_at(const Args& a, const Cl& cl, Shared* sh,
                                  int r, int b, int o) {
  int s_off = 0;
  for (int p = 0; p < o; ++p) s_off += sh->st.s_of[p];
  return run_of(a, o == b ? sh : cl.peer(o), r, sh->st.s_of[o], s_off);
}

// 2a. The S keys of every slice into the run of its block (appended in any
// order: they are unique and sorted next), shared out over the cluster:
// block b reads every C-th segment of the row from segment b, so that the
// slices where S crowds (a Stage-1 row's best scores often lie in a few id
// ranges) are read by every block. A warp takes the marks of 32 of its
// segments at once (the owners', through distributed shared memory), then
// each marked segment: one add to the owner's count a segment, its keys
// at the places that returns.
GRP_HD void compact_sorted(const Args& a, const float* x, const Cl& cl,
                           int r, int b, Shared* sh) {
  const State& st = sh->st;
  const unsigned prefix = st.prefix, pmask = st.pmask;
  const int ge = st.ge, nc = cl.size;
  if (st.n_sort == 0) return;
  const long long n = a.width;
  const long long n_seg = (n + kSeg - 1) / kSeg;
  const long long per = clu::slice_len(n, nc, kSeg) / kSeg;
  const long long stride = static_cast<long long>(nc) * kWarps;
  blk::step(kWarps, [&](const blk::Warp& g, int w) {
    for (long long g0 = b + static_cast<long long>(nc) * w; g0 < n_seg;
         g0 += 32 * stride) {
      const unsigned marked = grp::ballot(g, [&](int l) {
        const long long gs = g0 + l * stride;
        if (gs >= n_seg) return false;
        const int o = static_cast<int>(gs / per);
        const Shared* osh = o == b ? sh : cl.peer(o);
        const int mk = static_cast<int>(gs - o * per) >> st.mark_shift;
        return in_sorted(osh->marks[mk], prefix, pmask, ge);
      });
      for (unsigned m = marked; m != 0u; m &= m - 1u) {
        const long long s0 = (g0 + grp::ctz(m) * stride) * kSeg;
        const int o = static_cast<int>(s0 / kSeg / per);
        blk::Lanes<unsigned> u[kPer];
        blk::lanes(g, [&](int l) {
#pragma unroll
          for (int j = 0; j < kPer; ++j) {
            const long long i = s0 + j * 32 + l;
            u[j][l] = i < n ? order_of(x[i]) : 0u;
          }
        });
        const auto in = [&](int j, int l) {
          return s0 + j * 32 + l < n && in_sorted(u[j][l], prefix, pmask, ge);
        };
        int total = 0;
#pragma unroll
        for (int j = 0; j < kPer; ++j) {
          total += blk::popc(grp::ballot(g, [&](int l) { return in(j, l); }));
        }
        if (total == 0) continue;
        Shared* osh = o == b ? sh : cl.peer(o);
        unsigned long long* keys = run_at(a, cl, sh, r, b, o);
        int base = blk::append(g, &osh->st.base_s, total);
#pragma unroll
        for (int j = 0; j < kPer; ++j) {
          const unsigned ms =
              grp::ballot(g, [&](int l) { return in(j, l); });
          blk::lanes(g, [&](int l) {
            if ((ms >> l) & 1u) {
              keys[base + blk::popc(ms & blk::below(l))] =
                  key_of(u[j][l], s0 + j * 32 + l);
            }
          });
          base += blk::popc(ms);
        }
      }
    }
  });
}

// 2b. Slice [lo, hi)'s first `take` B ids (and scores), in id order, to
// the output's tail after the slices before it. A chunk of kCompact ids a
// round: warp w counts B in its kSegs segments (those marked), then a
// prefix over the warps places them in a second read of the segments
// that hold any.
GRP_HD void compact_boundary(const float* x, Shared* sh, long long lo,
                             long long hi, float* out_s, int* out_i) {
  State& st = sh->st;
  const unsigned prefix = st.prefix, pmask = st.pmask;
  const int ge = st.ge;
  const int left = st.need - st.b_off;
  const int take = left <= 0 ? 0 : (st.b_cnt < left ? st.b_cnt : left);
  float* tail_s = out_s + st.n_sort + st.b_off;
  int* tail_i = out_i + st.n_sort + st.b_off;
  for (long long c0 = lo; c0 < hi; c0 += kCompact) {
    if (st.base_b >= take) break;
    blk::step(kWarps, [&](const blk::Warp& g, int w) {
      const long long r0 = c0 + static_cast<long long>(w) * kSegs * kSeg;
      int cb = 0;
      for (int sg = 0; sg < kSegs; ++sg) {
        const long long s0 = r0 + sg * kSeg;
        if (s0 >= hi || !may_match(*mark_of(sh, s0, lo), prefix, pmask)) {
          continue;
        }
        blk::Lanes<unsigned> u[kPer];
        blk::lanes(g, [&](int l) {
#pragma unroll
          for (int j = 0; j < kPer; ++j) {
            const long long i = s0 + j * 32 + l;
            u[j][l] = i < hi ? order_of(x[i]) : 0u;
          }
        });
#pragma unroll
        for (int j = 0; j < kPer; ++j) {
          cb += blk::popc(grp::ballot(g, [&](int l) {
            return s0 + j * 32 + l < hi && in_boundary(u[j][l], prefix, ge);
          }));
        }
      }
      if (grp::leader(g)) st.wcnt[w] = cb;
    });
    blk::step(kWarps, [&](const blk::Warp& g, int w) {
      int ob = st.base_b;
      for (int v = 0; v < w; ++v) ob += st.wcnt[v];
      if (st.wcnt[w] == 0 || ob >= take) return;
      const long long r0 = c0 + static_cast<long long>(w) * kSegs * kSeg;
      for (int sg = 0; sg < kSegs && ob < take; ++sg) {
        const long long s0 = r0 + sg * kSeg;
        if (s0 >= hi || !may_match(*mark_of(sh, s0, lo), prefix, pmask)) {
          continue;
        }
        blk::Lanes<unsigned> u[kPer];
        blk::lanes(g, [&](int l) {
#pragma unroll
          for (int j = 0; j < kPer; ++j) {
            const long long i = s0 + j * 32 + l;
            u[j][l] = i < hi ? order_of(x[i]) : 0u;
          }
        });
#pragma unroll
        for (int j = 0; j < kPer; ++j) {
          const unsigned mb = grp::ballot(g, [&](int l) {
            return s0 + j * 32 + l < hi && in_boundary(u[j][l], prefix, ge);
          });
          blk::lanes(g, [&](int l) {
            const int p = ob + blk::popc(mb & blk::below(l));
            if (((mb >> l) & 1u) && p < take) {
              const long long i = s0 + j * 32 + l;
              tail_i[p] = static_cast<int>(i);
              tail_s[p] = x[i];
            }
          });
          ob += blk::popc(mb);
        }
      }
    });
    lead([&] {
      for (int v = 0; v < kWarps; ++v) st.base_b += st.wcnt[v];
    });
  }
}

// One bitonic stage (size, stride) over keys[0, n_pow), whose first key is
// key `base` of the network (its direction bits).
GRP_HD void bitonic_stage(unsigned long long* keys, int n_pow, int size,
                          int stride, int base) {
  blk::step(kWarps, [&](const blk::Warp& g, int w) {
    blk::lanes(g, [&](int l) {
      for (int t = w * 32 + l; t < n_pow / 2; t += kThreads) {
        // pair t: lo = 2 t - (t mod stride), hi = lo + stride
        const int lo = 2 * t - (t & (stride - 1));
        const int hi = lo + stride;
        const bool desc = ((base + lo) & size) == 0;
        const unsigned long long p = keys[lo], q = keys[hi];
        if (desc ? p < q : p > q) {
          keys[lo] = q;
          keys[hi] = p;
        }
      }
    });
  });
}

// keys[0, n) into tile, or back (n keys, a block step).
GRP_HD void copy_keys(unsigned long long* to, const unsigned long long* from,
                      int n) {
  blk::step(kWarps, [&](const blk::Warp& g, int w) {
    blk::lanes(g, [&](int l) {
      for (int i = w * 32 + l; i < n; i += kThreads) to[i] = from[i];
    });
  });
}

// 3. A run of n keys sorted descending (bitonic over a power of two, pads
// of 0). A run in global memory (larger than tile_keys) takes its stages
// of strides below tile_keys a tile at a time in `tile` (shared memory).
GRP_HD void sort_run(unsigned long long* keys, int n, unsigned long long* tile,
                     int tile_keys) {
  if (n <= 1) return;
  const int n_pow = static_cast<int>(pow2_at_least(n));
  blk::step(kWarps, [&](const blk::Warp& g, int w) {
    blk::lanes(g, [&](int l) {
      for (int i = n + w * 32 + l; i < n_pow; i += kThreads) keys[i] = 0ull;
    });
  });
  if (keys == tile || n_pow <= tile_keys) {
    for (int size = 2; size <= n_pow; size <<= 1) {
      for (int stride = size >> 1; stride > 0; stride >>= 1) {
        bitonic_stage(keys, n_pow, size, stride, 0);
      }
    }
    return;
  }
  const int nt = tile_keys;
  for (int t0 = 0; t0 < n_pow; t0 += nt) {
    copy_keys(tile, keys + t0, nt);
    for (int size = 2; size <= nt; size <<= 1) {
      for (int stride = size >> 1; stride > 0; stride >>= 1) {
        bitonic_stage(tile, nt, size, stride, t0);
      }
    }
    copy_keys(keys + t0, tile, nt);
  }
  for (int size = 2 * nt; size <= n_pow; size <<= 1) {
    for (int stride = size >> 1; stride >= nt; stride >>= 1) {
      bitonic_stage(keys, n_pow, size, stride, 0);
    }
    for (int t0 = 0; t0 < n_pow; t0 += nt) {
      copy_keys(tile, keys + t0, nt);
      for (int stride = nt >> 1; stride > 0; stride >>= 1) {
        bitonic_stage(tile, nt, size, stride, t0);
      }
      copy_keys(keys + t0, tile, nt);
    }
  }
}

// Key `key` of run b goes to `place` in S, if that is below k.
GRP_HD void place_key(const Args& a, const float* x, unsigned long long key,
                      int place, float* out_s, int* out_i) {
  if (place >= a.k) return;
  const long long id =
      0xFFFFFFFFll - static_cast<long long>(key & 0xFFFFFFFFull);
  out_i[place] = static_cast<int>(id);
  out_s[place] = x[id];
}

constexpr int kBatch = 8;                 // keys a thread searches at once

// 4. The merge of block b's run: each of its first k keys goes to its place
// in S (its place in the run plus the larger keys of every other run, by a
// binary search in each), if that is below k. With four runs or more a
// key searches all the others in step; with two, kBatch keys search the
// other in step.
GRP_HD void merge(const Args& a, const float* x, const Cl& cl, int r, int b,
                  Shared* sh, float* out_s, int* out_i) {
  State& st = sh->st;
  const int nc = cl.size;
  lead([&] {
    int most = 0;
    for (int p = 0; p < nc; ++p) {
      const int n = st.s_of[p];
      st.len_at[p] = n < a.k ? n : a.k;
      st.run_at[p] = run_at(a, cl, sh, r, b, p);
      if (st.len_at[p] > most) most = st.len_at[p];
    }
    int s = 1;
    while (2 * s <= most) s <<= 1;
    st.step_max = s;
  });
  const unsigned long long* own = st.run_at[b];
  const int mine = st.len_at[b];
  blk::step(kWarps, [&](const blk::Warp& g, int w) {
    blk::lanes(g, [&](int l) {
      if (nc >= 4) {
        for (int i = w * 32 + l; i < mine; i += kThreads) {
          const unsigned long long key = own[i];
          int pos[kMaxSlices];
#pragma unroll
          for (int p = 0; p < kMaxSlices; ++p) pos[p] = 0;
          for (int s = st.step_max; s > 0; s >>= 1) {
#pragma unroll
            for (int p = 0; p < kMaxSlices; ++p) {
              if (p < nc && p != b && pos[p] + s <= st.len_at[p]
                  && st.run_at[p][pos[p] + s - 1] > key) {
                pos[p] += s;
              }
            }
          }
          int place = i;
#pragma unroll
          for (int p = 0; p < kMaxSlices; ++p) place += pos[p];
          place_key(a, x, key, place, out_s, out_i);
        }
        return;
      }
      for (int i0 = w * 32 + l; i0 < mine; i0 += kThreads * kBatch) {
        unsigned long long key[kBatch];
        int place[kBatch];
#pragma unroll
        for (int q = 0; q < kBatch; ++q) {
          place[q] = i0 + q * kThreads;
          key[q] = place[q] < mine ? own[place[q]] : ~0ull;
        }
        for (int p = 0; p < nc; ++p) {
          if (p == b) continue;
          const unsigned long long* run = st.run_at[p];
          const int len = st.len_at[p];
          int pos[kBatch];
#pragma unroll
          for (int q = 0; q < kBatch; ++q) pos[q] = 0;
          for (int s = st.step_max; s > 0; s >>= 1) {
#pragma unroll
            for (int q = 0; q < kBatch; ++q) {
              if (pos[q] + s <= len && run[pos[q] + s - 1] > key[q]) {
                pos[q] += s;
              }
            }
          }
#pragma unroll
          for (int q = 0; q < kBatch; ++q) place[q] += pos[q];
        }
#pragma unroll
        for (int q = 0; q < kBatch; ++q) {
          if (i0 + q * kThreads < mine) {
            place_key(a, x, key[q], place[q], out_s, out_i);
          }
        }
      }
    });
  });
}

// Row r's top k (a cluster of a.slices blocks of kThreads).
GRP_HD void row(const Args& a, int r, const Cl& cl) {
  const float* x = a.scores + r * a.width;
  float* out_s = a.out_scores + static_cast<long long>(r) * a.k;
  int* out_i = a.out_ids + static_cast<long long>(r) * a.k;
  for (int round = 0; round < 3; ++round) {
    if (round > 0 && cl.uniform()->st.done) break;
    select_round(a, x, cl, r, round);
  }
  clu::step(cl, [&](int b, Shared* sh) {
    State& st = sh->st;
    lead([&] {
      int b_off = 0;
      for (int p = 0; p < b; ++p) b_off += st.b_of[p];
      st.b_off = b_off;
    });
    compact_sorted(a, x, cl, r, b, sh);
    STAGE1_STAMP(r, b, 3);
    long long lo, hi;
    clu::slice_of(a.width, cl.size, b, kSeg, &lo, &hi);
    compact_boundary(x, sh, lo, hi, out_s, out_i);
    STAGE1_STAMP(r, b, 4);
  });
  clu::step(cl, [&](int b, Shared* sh) {
    sort_run(run_at(a, cl, sh, r, b, b), sh->st.s_cnt, sh->u.keys,
             a.run_keys);
    STAGE1_STAMP(r, b, 5);
  });
  clu::step(cl, [&](int b, Shared* sh) {
    merge(a, x, cl, r, b, sh, out_s, out_i);
    STAGE1_STAMP(r, b, 6);
  });
}

}  // namespace topk
