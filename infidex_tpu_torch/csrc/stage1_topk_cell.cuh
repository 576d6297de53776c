// The exact stable top-k of one row: the arithmetic of
// csrc/stage1_topk.cu, in a header of its own so that g++ builds the same
// code for the CPU tests (tests/test_torch_stage1_epilogue.py holds it to
// the plain version, index/device.py stable_top_k_plain).
//
// The k largest of a row of f32 scores by (score desc, id asc), in that
// order, with index/device.py order_keys' total order: the order image
// of a score is an unsigned int that orders as the floats do, -0.0 folded
// into +0.0 first. Three steps, each a sequence of block steps
// (block_steps.cuh):
//
// 1. Select (a radix select on the order image, at most three rounds of
//    12, 12 and 8 bits): each round counts the row's images that match
//    the prefix found so far into a histogram of the next digit, and
//    takes the digit of the k-th largest. A round ends the select early
//    ("ge") where every image at or above the digit's bin can be sorted
//    in shared memory, or where the bin holds exactly the ones still to
//    take; the first round also ends it where the bin is +0.0's and holds
//    nothing else (a row with fewer than k positive scores). After it: the
//    sorted set S (images whose chosen top bits lie above the prefix, or
//    at it with ge) of n_sort ids, of which the first k - need are in,
//    and, without ge, the boundary class B (images equal to the 32-bit
//    prefix, the k-th score's), of which the `need` lowest ids are in.
//    Most rows so take two reads: the first round and the compaction.
// 2. Compact, a chunk of kCompact ids at a time: S's ids are appended to
//    a key buffer (shared memory, or the row's global scratch when S is
//    larger) a ballot at a time, and B's first `need` ids go straight to
//    the tail of the output in id order (counts a warp, a prefix over the
//    warps, a ballot a warp and 32 ids for the places). It stops once
//    both are complete.
// 3. Sort S by its 64-bit keys (order image << 32 | 2^32 - 1 - id: unique,
//    so no tie is left to order) with a bitonic network over a power of
//    two (pads of 0 sort last), and write ids and their scores (the
//    row's own floats, -0.0 kept) to the head of the output.

#pragma once

#include "block_steps.cuh"

namespace topk {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr int kPer = 16;                  // ids a lane takes in a segment
constexpr int kSeg = 32 * kPer;           // a warp's segment of ids
constexpr int kChunk = kWarps * kSeg;     // a block's ids a round
constexpr int kSegs = 8;                  // a warp's segments a compaction
constexpr int kCompact = kChunk * kSegs;  // a block's ids a compaction
constexpr int kBins = 4096;               // 12-bit digits
constexpr int kSharedKeys = 16384;        // S sorted in shared memory

struct Args {
  const float* scores;            // [n_rows, width]
  long long width;
  int n_rows;
  int k;                          // 1 <= k <= width
  int shared_keys;                // S sorted in shared memory up to this
                                  // many (a power of two <= kSharedKeys)
  unsigned long long* scratch;    // [n_rows, scratch_cols] when needed
  long long scratch_cols;         // a power of two >= k, or 0
  float* out_scores;              // [n_rows, k]
  int* out_ids;                   // [n_rows, k]
};

struct State {
  unsigned prefix, pmask;
  int remaining, ge, done, zeros;
  int n_sort, need, base_s, base_b;
  int wtot[kWarps];
  int wcnt_b[kWarps];
};

struct Shared {
  State st;
  union {
    int hist[kBins];
    unsigned long long keys[kSharedKeys];
  } u;
};

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

// What the kernel takes: 1 <= k <= width; shared_keys a power of two up
// to kSharedKeys; scratch rows of scratch_cols >= the power of two at or
// above k where that exceeds shared_keys (else scratch may be null).
GRP_HD bool args_ok(long long width, int k, int shared_keys,
                    const unsigned long long* scratch,
                    long long scratch_cols) {
  return k >= 1 && k <= width && shared_keys >= 1
         && shared_keys <= kSharedKeys
         && (shared_keys & (shared_keys - 1)) == 0
         && (pow2_at_least(k) <= shared_keys
             || (scratch != nullptr && scratch_cols >= pow2_at_least(k)));
}

// The leader of warp 0 runs f (block-uniform state), then a barrier.
template <class F>
GRP_HD void lead(const F& f) {
  blk::step(kWarps, [&](const blk::Warp& g, int w) {
    if (w == 0 && grp::leader(g)) f();
  });
}

// 1. The select: leaves prefix, pmask, ge, n_sort, need in st.
GRP_HD void select(const Args& a, const float* x, Shared* sh) {
  State& st = sh->st;
  const long long n = a.width;
  lead([&] {
    st.prefix = 0u;
    st.pmask = 0u;
    st.remaining = a.k;
    st.ge = 0;
    st.done = 0;
    st.zeros = 0;
    st.n_sort = 0;
  });
  for (int round = 0; round < 3; ++round) {
    if (st.done) break;
    const int shift = round == 0 ? 20 : (round == 1 ? 8 : 0);
    const int nbins = round < 2 ? kBins : 256;
    const unsigned prefix = st.prefix, pmask = st.pmask;
    blk::step(kWarps, [&](const blk::Warp& g, int w) {
      blk::lanes(g, [&](int l) {
        for (int i = w * 32 + l; i < nbins; i += kThreads) sh->u.hist[i] = 0;
      });
    });
    // +0.0's bin holds most of a Stage-1 row: each lane counts it in a
    // register and adds the rest to the shared histogram one by one
    const int hot = static_cast<int>((kZero >> shift) & (nbins - 1));
    blk::step(kWarps, [&](const blk::Warp& g, int w) {
      blk::Lanes<int> zeros, in_hot;
      blk::lanes(g, [&](int l) {
        zeros[l] = in_hot[l] = 0;
        for (long long s0 = static_cast<long long>(w) * kSeg; s0 < n;
             s0 += kChunk) {
          float v[kPer];
#pragma unroll
          for (int j = 0; j < kPer; ++j) {
            const long long i = s0 + j * 32 + l;
            v[j] = i < n ? x[i] : 0.0f;
          }
#pragma unroll
          for (int j = 0; j < kPer; ++j) {
            const unsigned u = order_of(v[j]);
            if (s0 + j * 32 + l >= n || (u & pmask) != prefix) continue;
            zeros[l] += u == kZero;
            const int d = static_cast<int>((u >> shift) & (nbins - 1));
            if (d == hot) {
              ++in_hot[l];
            } else {
              blk::atomic_add(sh->u.hist + d, 1);
            }
          }
        }
      });
      const int z = blk::sum_int(g, [&](int l) { return zeros[l]; });
      const int h = blk::sum_int(g, [&](int l) { return in_hot[l]; });
      if (grp::leader(g)) {
        blk::atomic_add(&st.zeros, z);
        blk::atomic_add(sh->u.hist + hot, h);
      }
    });
    // each warp's total over its share of the bins, then the k-th's bin
    const int per = nbins / kWarps;
    blk::step(kWarps, [&](const blk::Warp& g, int w) {
      const int t = blk::sum_int(g, [&](int l) {
        int s = 0;
        for (int i = l; i < per; i += 32) s += sh->u.hist[w * per + i];
        return s;
      });
      if (grp::leader(g)) st.wtot[w] = t;
    });
    lead([&] {
      int rem = st.remaining, above = 0, ww = kWarps - 1;
      for (; ww > 0; --ww) {
        if (above + st.wtot[ww] >= rem) break;
        above += st.wtot[ww];
      }
      int d = (ww + 1) * per - 1;
      for (; d > ww * per; --d) {
        if (above + sh->u.hist[d] >= rem) break;
        above += sh->u.hist[d];
      }
      rem -= above;
      const int c = sh->u.hist[d];
      st.prefix = prefix | (static_cast<unsigned>(d) << shift);
      st.pmask = pmask | (static_cast<unsigned>(nbins - 1) << shift);
      st.remaining = rem;
      // every image at or above the bin sorts in shared memory (or the
      // bin holds just the ones still to take): S is all of them
      st.ge = c == rem || a.k - rem + c <= a.shared_keys;
      st.n_sort = a.k - rem + c;
      // the bin is +0.0's and holds nothing else: the k-th score is +0.0
      const bool zero = round == 0 && d == hot && st.zeros == c;
      if (zero && !st.ge) st.prefix = kZero, st.pmask = 0xFFFFFFFFu;
      st.done = st.ge || zero || shift == 0;
    });
  }
  lead([&] {
    st.need = st.ge ? 0 : st.remaining;
    if (!st.ge) st.n_sort = a.k - st.need;
    st.base_s = 0;
    st.base_b = 0;
  });
}

// Membership of an order image: the sorted set S, the boundary class B.
GRP_HD bool in_sorted(unsigned u, unsigned prefix, unsigned pmask, int ge) {
  const unsigned t = u & pmask;
  return t > prefix || (ge && t == prefix);
}

GRP_HD bool in_boundary(unsigned u, unsigned prefix, int ge) {
  return !ge && u == prefix;
}

// 2. The compaction: S's keys into `keys` (appended in any order: they
// are unique and sorted next), B's first `need` ids (and scores), in id
// order, to the output's tail. A chunk of kCompact ids a round: warp w
// reads its kSegs segments, appends S's members a ballot at a time and
// counts B's; then, while B is short, a prefix over the warps places B's
// members in a second read of the segments that hold any.
GRP_HD void compact(const Args& a, const float* x, Shared* sh,
                    unsigned long long* keys, float* out_s, int* out_i) {
  State& st = sh->st;
  const long long n = a.width;
  const unsigned prefix = st.prefix, pmask = st.pmask;
  const int ge = st.ge, n_sort = st.n_sort, need = st.need;
  for (long long c0 = 0; c0 < n; c0 += kCompact) {
    if (st.base_s >= n_sort && st.base_b >= need) break;
    const bool boundary = st.base_b < need;
    blk::step(kWarps, [&](const blk::Warp& g, int w) {
      const long long r0 = c0 + static_cast<long long>(w) * kSegs * kSeg;
      int cb = 0;
      for (int sg = 0; sg < kSegs; ++sg) {
        const long long s0 = r0 + sg * kSeg;
        blk::Lanes<unsigned> u[kPer];
        blk::lanes(g, [&](int l) {
#pragma unroll
          for (int j = 0; j < kPer; ++j) {
            const long long i = s0 + j * 32 + l;
            u[j][l] = i < n ? order_of(x[i]) : 0u;
          }
        });
#pragma unroll
        for (int j = 0; j < kPer; ++j) {
          const unsigned ms = grp::ballot(g, [&](int l) {
            return s0 + j * 32 + l < n
                   && in_sorted(u[j][l], prefix, pmask, ge);
          });
          if (ms != 0u) {
            const int base = blk::append(g, &st.base_s, blk::popc(ms));
            blk::lanes(g, [&](int l) {
              if ((ms >> l) & 1u) {
                keys[base + blk::popc(ms & blk::below(l))] =
                    key_of(u[j][l], s0 + j * 32 + l);
              }
            });
          }
          if (boundary) {
            cb += blk::popc(grp::ballot(g, [&](int l) {
              return s0 + j * 32 + l < n && in_boundary(u[j][l], prefix, ge);
            }));
          }
        }
      }
      if (grp::leader(g)) st.wcnt_b[w] = cb;
    });
    if (!boundary) continue;
    blk::step(kWarps, [&](const blk::Warp& g, int w) {
      int ob = st.base_b;
      for (int v = 0; v < w; ++v) ob += st.wcnt_b[v];
      if (st.wcnt_b[w] == 0 || ob >= need) return;
      const long long r0 = c0 + static_cast<long long>(w) * kSegs * kSeg;
      for (int sg = 0; sg < kSegs; ++sg) {
        const long long s0 = r0 + sg * kSeg;
#pragma unroll
        for (int j = 0; j < kPer; ++j) {
          const unsigned mb = grp::ballot(g, [&](int l) {
            const long long i = s0 + j * 32 + l;
            return i < n && in_boundary(order_of(x[i]), prefix, ge);
          });
          blk::lanes(g, [&](int l) {
            const int p = ob + blk::popc(mb & blk::below(l));
            if (((mb >> l) & 1u) && p < need) {
              const long long i = s0 + j * 32 + l;
              out_i[n_sort + p] = static_cast<int>(i);
              out_s[n_sort + p] = x[i];
            }
          });
          ob += blk::popc(mb);
        }
      }
    });
    lead([&] {
      for (int v = 0; v < kWarps; ++v) st.base_b += st.wcnt_b[v];
    });
  }
}

// 3. Sort S's keys descending (bitonic over a power of two, pads of 0)
// and write the first k ids and their scores to the output's head.
GRP_HD void sort_out(const float* x, int n_sort, int k,
                     unsigned long long* keys, float* out_s, int* out_i) {
  const long long n_pow = pow2_at_least(n_sort);
  blk::step(kWarps, [&](const blk::Warp& g, int w) {
    blk::lanes(g, [&](int l) {
      for (long long i = n_sort + w * 32 + l; i < n_pow; i += kThreads) {
        keys[i] = 0ull;
      }
    });
  });
  for (long long size = 2; size <= n_pow; size <<= 1) {
    for (long long stride = size >> 1; stride > 0; stride >>= 1) {
      blk::step(kWarps, [&](const blk::Warp& g, int w) {
        blk::lanes(g, [&](int l) {
          for (long long t = w * 32 + l; t < n_pow / 2; t += kThreads) {
            const long long lo = 2 * stride * (t / stride) + (t % stride);
            const long long hi = lo + stride;
            const bool desc = (lo & size) == 0;
            const unsigned long long p = keys[lo], q = keys[hi];
            if (desc ? p < q : p > q) {
              keys[lo] = q;
              keys[hi] = p;
            }
          }
        });
      });
    }
  }
  blk::step(kWarps, [&](const blk::Warp& g, int w) {
    blk::lanes(g, [&](int l) {
      for (long long i = w * 32 + l; i < n_sort && i < k; i += kThreads) {
        const long long id =
            0xFFFFFFFFll - static_cast<long long>(keys[i] & 0xFFFFFFFFull);
        out_i[i] = static_cast<int>(id);
        out_s[i] = x[id];
      }
    });
  });
}

// Row r's top k (a block of kThreads).
GRP_HD void row(const Args& a, int r, Shared* sh) {
  const float* x = a.scores + r * a.width;
  float* out_s = a.out_scores + static_cast<long long>(r) * a.k;
  int* out_i = a.out_ids + static_cast<long long>(r) * a.k;
  select(a, x, sh);
  const int n_sort = sh->st.n_sort;
  unsigned long long* keys = pow2_at_least(n_sort) <= a.shared_keys
                                 ? sh->u.keys
                                 : a.scratch + r * a.scratch_cols;
  compact(a, x, sh, keys, out_s, out_i);
  sort_out(x, n_sort, a.k, keys, out_s, out_i);
}

}  // namespace topk
