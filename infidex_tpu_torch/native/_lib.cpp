// infidex_tpu native data-plane kernels (host side).
//
// Behavioral reference: Infidex Metrics/LevenshteinDistance.cs,
// Metrics/StringMetrics.cs and Compression/GroupVarInt.cs — the reference
// implements these in C# with SIMD intrinsics; here they are C++ compiled
// -O3 (auto-vectorized) and exposed through a plain C ABI for ctypes.
//
// Everything operates on UTF-32 codepoint buffers (uint32_t) so Python can
// pass str data losslessly (PyUnicode -> array of ordinals) — the reference
// compares UTF-16 chars; codepoint equality is equivalent for our purposes.
//
// All functions are pure and thread-safe (no globals, no allocation beyond
// small stack arrays except where documented).

#include <cstdint>
#include <cstring>
#include <algorithm>

extern "C" {

// ---------------------------------------------------------------------
// Banded Levenshtein with budget clamp (LevenshteinDistance.Calculate):
// returns min(lev(a,b), max_dist + 1).
static int lev_budget(const uint32_t* a, int la, const uint32_t* b, int lb,
                      int max_dist) {
    if (la == 0) return lb <= max_dist ? lb : max_dist + 1;
    if (lb == 0) return la <= max_dist ? la : max_dist + 1;
    int diff = la > lb ? la - lb : lb - la;
    if (diff > max_dist) return max_dist + 1;

    // row DP over b, banded by max_dist
    static thread_local int rowbuf[4096];
    int* row = rowbuf;
    if (lb + 1 > 4096) return max_dist + 1;  // callers keep tokens short
    for (int j = 0; j <= lb; ++j) row[j] = j;
    for (int i = 1; i <= la; ++i) {
        int prev_diag = row[0];
        row[0] = i;
        int row_min = row[0];
        int lo = std::max(1, i - max_dist);
        int hi = std::min(lb, i + max_dist);
        if (lo > 1) { prev_diag = row[lo - 1]; row[lo - 1] = max_dist + 1; }
        for (int j = lo; j <= hi; ++j) {
            int cur = row[j];
            int cost = (a[i - 1] == b[j - 1]) ? 0 : 1;
            int v = std::min(std::min(row[j - 1] + 1, cur + 1),
                             prev_diag + cost);
            prev_diag = cur;
            row[j] = v;
            if (v < row_min) row_min = v;
        }
        if (hi < lb) row[hi + 1] = max_dist + 1;
        for (int j = hi + 2; j <= lb; ++j) row[j] = max_dist + 1;
        if (row_min > max_dist) return max_dist + 1;
    }
    return row[lb] <= max_dist ? row[lb] : max_dist + 1;
}

int infidex_levenshtein(const uint32_t* a, int la, const uint32_t* b, int lb,
                        int max_dist) {
    return lev_budget(a, la, b, lb, max_dist);
}

// CalculateDamerau (LevenshteinDistance.cs:281-341): plain Levenshtein with
// budget max_dist + 1; if the result lands exactly on max_dist + 1, scan to
// the FIRST mismatch, and if it is an adjacent transposition rescue with
// 1 + lev(rest) when that stays within budget. Mirrors
// utils/metrics.calculate_damerau exactly (incl. the max+2 fall-through).
int infidex_damerau(const uint32_t* a, int la, const uint32_t* b, int lb,
                    int max_dist) {
    int diff = la > lb ? la - lb : lb - la;
    if (diff > max_dist) return max_dist + 1;
    int d = lev_budget(a, la, b, lb, max_dist + 1);
    if (d <= max_dist) return d;
    if (d <= max_dist + 1) {
        int i = 0;
        int lim = la - 1;
        while (i < lim) {
            if (i >= lb) break;
            if (a[i] != b[i]) {
                if (i + 1 >= lb) break;
                if (a[i] == b[i + 1] && a[i + 1] == b[i]) {
                    int remaining = max_dist - 1;
                    if (remaining < 0) return max_dist + 1;
                    int rest = lev_budget(a + i + 2, la - i - 2,
                                          b + i + 2, lb - i - 2, remaining);
                    if (rest <= remaining) return 1 + rest;
                }
                break;  // only the first mismatch is examined
            }
            ++i;
        }
    }
    return d;
}

// CalculatePrefixDistance (PLD, Bast & Celikik 2011): min edit distance
// between q and any prefix of w; mirrors utils/metrics version (full DP,
// clamp to max_errors + 1 at the end).
int infidex_prefix_distance(const uint32_t* q, int lq, const uint32_t* w,
                            int lw, int max_errors) {
    if (lq == 0) return 0;
    if (lw == 0) return lq;
    if (lq - lw > max_errors) return max_errors + 1;
    static thread_local int prevbuf[4096], curbuf[4096];
    if (lq + 1 > 4096) return max_errors + 1;
    int* prev = prevbuf;
    int* cur = curbuf;
    for (int i = 0; i <= lq; ++i) prev[i] = i;
    int best = lq;
    for (int j = 1; j <= lw; ++j) {
        cur[0] = j;
        for (int i = 1; i <= lq; ++i) {
            int c = (q[i - 1] == w[j - 1]) ? 0 : 1;
            cur[i] = std::min(std::min(prev[i - 1] + c, prev[i] + 1),
                              cur[i - 1] + 1);
        }
        if (cur[lq] < best) best = cur[lq];
        std::swap(prev, cur);
    }
    return std::min(best, max_errors + 1);
}

// ---------------------------------------------------------------------
// StringMetrics "LCS" (StringMetrics.cs:12-36): containment-or-common-
// prefix with tolerance; mirrors utils/metrics.lcs exactly.
int infidex_lcs(const uint32_t* q, int lq, const uint32_t* r, int lr,
                int tolerance) {
    if (lq == 0 || lr == 0) return 0;
    // containment: q inside r (covers q == r)
    if (lq <= lr) {
        for (int s = 0; s + lq <= lr; ++s) {
            if (std::memcmp(q, r + s, lq * sizeof(uint32_t)) == 0) return lq;
        }
    }
    int m = std::min(lq, lr);
    int cp = 0;
    while (cp < m && q[cp] == r[cp]) ++cp;
    if (cp == 0) return 0;
    return std::min(cp + tolerance, m);
}

// Batch LCS over one query and many documents packed into a flat buffer.
// docs: concatenated codepoints; offsets[n+1] frames doc i.
void infidex_lcs_batch(const uint32_t* q, int lq, const uint32_t* docs,
                       const int64_t* offsets, int n, int tolerance,
                       int32_t* out) {
    for (int i = 0; i < n; ++i) {
        const uint32_t* r = docs + offsets[i];
        int lr = (int)(offsets[i + 1] - offsets[i]);
        out[i] = infidex_lcs(q, lq, r, lr, tolerance);
    }
}

// ---------------------------------------------------------------------
// GroupVarInt-GB codec (Compression/GroupVarInt.cs): 4 uint32 per 1-byte
// tag, 2 bits of byte-length each with value 0 in the TOP bits (matches
// utils/compression.group_varint_encode and the IFTS1 segment format),
// values little-endian. Returns encoded size in bytes; out must hold
// >= 1 + 16 bytes per group.
int64_t infidex_gvi_encode(const uint32_t* vals, int64_t n, uint8_t* out) {
    int64_t w = 0;
    for (int64_t g = 0; g < n; g += 4) {
        int64_t tag_pos = w++;
        uint8_t tag = 0;
        int cnt = (int)std::min<int64_t>(4, n - g);
        for (int k = 0; k < cnt; ++k) {
            uint32_t v = vals[g + k];
            int nb = v < 0x100 ? 1 : v < 0x10000 ? 2 : v < 0x1000000 ? 3 : 4;
            tag |= (uint8_t)((nb - 1) << ((3 - k) * 2));
            for (int b = 0; b < nb; ++b) out[w++] = (uint8_t)(v >> (8 * b));
        }
        out[tag_pos] = tag;
    }
    return w;
}

// Decodes exactly n values; returns bytes consumed.
int64_t infidex_gvi_decode(const uint8_t* in, int64_t n, uint32_t* out) {
    int64_t r = 0;
    for (int64_t g = 0; g < n; g += 4) {
        uint8_t tag = in[r++];
        int cnt = (int)std::min<int64_t>(4, n - g);
        for (int k = 0; k < cnt; ++k) {
            int nb = ((tag >> ((3 - k) * 2)) & 3) + 1;
            uint32_t v = 0;
            for (int b = 0; b < nb; ++b) v |= (uint32_t)in[r++] << (8 * b);
            out[g + k] = v;
        }
    }
    return r;
}

// Delta variants used by the segment format: docIds ascending.
int64_t infidex_gvi_encode_delta(const uint32_t* vals, int64_t n,
                                 uint8_t* out) {
    static thread_local uint32_t buf[65536];
    if (n <= 65536) {
        uint32_t prev = 0;
        for (int64_t i = 0; i < n; ++i) { buf[i] = vals[i] - prev; prev = vals[i]; }
        return infidex_gvi_encode(buf, n, out);
    }
    // large: allocate
    uint32_t* big = new uint32_t[n];
    uint32_t prev = 0;
    for (int64_t i = 0; i < n; ++i) { big[i] = vals[i] - prev; prev = vals[i]; }
    int64_t w = infidex_gvi_encode(big, n, out);
    delete[] big;
    return w;
}

int64_t infidex_gvi_decode_delta(const uint8_t* in, int64_t n,
                                 uint32_t* out) {
    int64_t r = infidex_gvi_decode(in, n, out);
    uint32_t acc = 0;
    for (int64_t i = 0; i < n; ++i) { acc += out[i]; out[i] = acc; }
    return r;
}

}  // extern "C"

// ===================================================================
// Bulk index builder: tokenize -> term dict -> postings accumulation,
// WordMatcher maps (exact / LD1 deletions / affix) and the positional
// prefix index, all in one pass over UTF-32 document blobs.
//
// Semantics replicate the Python host path exactly:
//   index/builder.py  TermPostings.increment_usage / first_cycle_add
//   tokenization/tokenizer.py  tokenize_for_indexing (+_effective_sizes,
//     _all_padding, split_words)
//   index/vector_model.py  _field_weight_at
//   index/word_matcher.py  load/_add/_deletions
//   index/short_query.py  PositionalPrefixIndex.index_document
// ===================================================================

#include <cstdint>
#include <cstring>
#include <chrono>
#include <cmath>
#include <mutex>
#include <vector>
#include <string>
#include <unordered_map>
#include <algorithm>

namespace bulk {

static const uint32_t PAD_START = 0xFFFF;
static const uint32_t PAD_STOP = 0xFFFE;

struct U32Span { const uint32_t* p; int32_t n; };

struct SpanHash {
    size_t operator()(const U32Span& s) const {
        // FNV-1a over code points
        uint64_t h = 1469598103934665603ull;
        for (int32_t i = 0; i < s.n; i++) {
            h ^= (uint64_t)s.p[i];
            h *= 1099511628211ull;
        }
        return (size_t)h;
    }
};
struct SpanEq {
    bool operator()(const U32Span& a, const U32Span& b) const {
        return a.n == b.n && std::memcmp(a.p, b.p, (size_t)a.n * 4) == 0;
    }
};

struct StrMap {
    // insertion-ordered string->id map over an arena (stable storage)
    std::vector<std::vector<uint32_t>> arena_blocks;
    size_t arena_used = 0;
    std::unordered_map<U32Span, int32_t, SpanHash, SpanEq> map;
    std::vector<U32Span> keys;  // by id

    const uint32_t* intern(const uint32_t* p, int32_t n) {
        if (arena_blocks.empty() ||
            arena_used + (size_t)n > arena_blocks.back().size()) {
            size_t cap = 1 << 20;
            while (cap < (size_t)n) cap <<= 1;
            arena_blocks.emplace_back(cap);
            arena_used = 0;
        }
        uint32_t* dst = arena_blocks.back().data() + arena_used;
        std::memcpy(dst, p, (size_t)n * 4);
        arena_used += (size_t)n;
        return dst;
    }

    int32_t get_or_add(const uint32_t* p, int32_t n, bool* added) {
        U32Span probe{p, n};
        auto it = map.find(probe);
        if (it != map.end()) { if (added) *added = false; return it->second; }
        U32Span owned{intern(p, n), n};
        int32_t id = (int32_t)keys.size();
        keys.push_back(owned);
        map.emplace(owned, id);
        if (added) *added = true;
        return id;
    }
};

struct Postings {
    std::vector<int32_t> docs;
    std::vector<uint8_t> weights;
    int64_t df = 0;  // -1 => stop term
};

struct DocListMap {   // word -> doc id list with last-doc dedupe
    StrMap dict;
    std::vector<std::vector<int32_t>> lists;
    void add(const uint32_t* p, int32_t n, int32_t doc) {
        bool added = false;
        int32_t id = dict.get_or_add(p, n, &added);
        if (added) lists.emplace_back();
        auto& v = lists[(size_t)id];
        if (v.empty() || v.back() != doc) v.push_back(doc);
    }
};

struct Builder {
    // config
    std::vector<int32_t> sizes;
    int32_t start_pad, stop_pad;
    std::vector<uint32_t> delims;    // sorted
    int32_t remove_dups;
    int64_t stop_limit;
    std::vector<float> field_weights;
    // wm config
    int32_t wm_enabled, wm_min_exact, wm_max_exact, wm_min_ld1, wm_max_ld1;
    int32_t wm_ld1, wm_affix;
    int32_t sq_enabled, sq_min, sq_max;

    StrMap terms;
    std::vector<Postings> postings;
    DocListMap wm_exact, wm_ld1_map, wm_affix_map;
    // prefix (packed key) -> (doc, token_pos) pairs
    StrMap sq_dict;
    std::vector<std::vector<int64_t>> sq_lists;  // doc<<32 | pos

    // export scratch
    std::vector<int64_t> exp_term_offsets;
    std::vector<uint32_t> exp_blob;
    std::vector<int64_t> exp_blob_offsets;

    bool is_delim(uint32_t c) const {
        return std::binary_search(delims.begin(), delims.end(), c);
    }
    float weight_at(int32_t pos, const int32_t* bpos, const int32_t* bwidx,
                    int64_t nb) const {
        if (nb == 0) return 1.0f;
        int32_t widx = 0;
        for (int64_t i = 0; i < nb; i++) {
            if (bpos[i] <= pos) widx = bwidx[i];
            else break;
        }
        if (widx < (int32_t)field_weights.size()) return field_weights[widx];
        return 1.0f;
    }
};

static inline int bankers_round(double x) {
    // C# Math.Round / Python round(): round-half-to-even
    double r = std::nearbyint(x);  // FE_TONEAREST default = half-to-even
    return (int)r;
}

static void add_token(Builder* b, const uint32_t* p, int32_t n, int32_t doc,
                      float fw) {
    bool added = false;
    int32_t tid = b->terms.get_or_add(p, n, &added);
    if (added) b->postings.emplace_back();
    Postings& post = b->postings[(size_t)tid];
    // increment_usage
    if (post.df != -1) {
        post.df += 1;
        if (post.df > b->stop_limit) post.df = -1;
    }
    // first_cycle_add
    if (post.df < 0) return;
    if ((int64_t)post.weights.size() >= b->stop_limit) {
        post.df = -1;
        post.docs.clear();
        post.weights.clear();
        return;
    }
    if (post.docs.empty() || post.docs.back() != doc) {
        int w = bankers_round((double)fw);
        if (w > 255) w = 255;
        post.docs.push_back(doc);
        post.weights.push_back((uint8_t)w);
    } else if (!b->remove_dups) {
        double new_w = (double)post.weights.back() + (double)fw;
        if (new_w <= 255.0) {
            post.weights.back() = (uint8_t)bankers_round(new_w);
            post.df -= 1;
        }
    }
}

}  // namespace bulk

extern "C" {

void* infidex_bulk_create(
    const int32_t* index_sizes, int32_t n_sizes,
    int32_t start_pad, int32_t stop_pad,
    const uint32_t* delims, int32_t n_delims,
    int32_t remove_dups, int64_t stop_limit,
    const float* field_weights, int32_t n_field_weights,
    int32_t wm_enabled, int32_t wm_min_exact, int32_t wm_max_exact,
    int32_t wm_min_ld1, int32_t wm_max_ld1, int32_t wm_ld1, int32_t wm_affix,
    int32_t sq_enabled, int32_t sq_min, int32_t sq_max) {
    auto* b = new bulk::Builder();
    b->sizes.assign(index_sizes, index_sizes + n_sizes);
    b->start_pad = start_pad;
    b->stop_pad = stop_pad;
    b->delims.assign(delims, delims + n_delims);
    std::sort(b->delims.begin(), b->delims.end());
    b->remove_dups = remove_dups;
    b->stop_limit = stop_limit;
    b->field_weights.assign(field_weights, field_weights + n_field_weights);
    b->wm_enabled = wm_enabled;
    b->wm_min_exact = wm_min_exact;
    b->wm_max_exact = wm_max_exact;
    b->wm_min_ld1 = wm_min_ld1;
    b->wm_max_ld1 = wm_max_ld1;
    b->wm_ld1 = wm_ld1;
    b->wm_affix = wm_affix;
    b->sq_enabled = sq_enabled;
    b->sq_min = sq_min < 1 ? 1 : sq_min;
    b->sq_max = sq_max;
    return b;
}

void infidex_bulk_free(void* h) { delete (bulk::Builder*)h; }

void infidex_bulk_add(
    void* h,
    // main tokenization text (normalize(index_text)) per doc
    const uint32_t* text, const int64_t* offsets,
    // short-query text (index_text) per doc
    const uint32_t* sq_text, const int64_t* sq_offsets,
    // word-matcher text (lower+normalize(raw)) per doc
    const uint32_t* wm_text, const int64_t* wm_offsets,
    const int32_t* doc_ids, const uint8_t* is_cont, int32_t n_docs,
    const int32_t* fw_pos, const int32_t* fw_widx, const int64_t* fw_off) {
    auto* b = (bulk::Builder*)h;
    std::vector<uint32_t> padded;
    std::vector<uint32_t> scratch;

    for (int32_t d = 0; d < n_docs; d++) {
        const int32_t doc = doc_ids[d];
        const uint32_t* t = text + offsets[d];
        const int64_t len = offsets[d + 1] - offsets[d];
        const int32_t* bpos = fw_pos + fw_off[d];
        const int32_t* bwidx = fw_widx + fw_off[d];
        const int64_t nb = fw_off[d + 1] - fw_off[d];
        const bool cont = is_cont[d] != 0;

        if (len > 0) {
            // ---- n-grams over the padded text -------------------------
            padded.clear();
            if (!cont)
                padded.insert(padded.end(), (size_t)b->start_pad,
                              bulk::PAD_START);
            padded.insert(padded.end(), t, t + len);
            padded.insert(padded.end(), (size_t)b->stop_pad, bulk::PAD_STOP);
            const int64_t pn = (int64_t)padded.size();

            // _effective_sizes
            int32_t max_size =
                b->sizes.empty() ? 0 : b->sizes[b->sizes.size() - 1];
            if (!b->sizes.empty() && pn <= b->sizes[0]) max_size = b->sizes[0];
            for (int32_t size : b->sizes) {
                if (pn >= size) {
                    for (int64_t i = 0; i + size <= pn; i++) {
                        const uint32_t* g = padded.data() + i;
                        bool all_pad = true;
                        for (int32_t j = 0; j < size; j++) {
                            if (g[j] != bulk::PAD_START &&
                                g[j] != bulk::PAD_STOP) {
                                all_pad = false;
                                break;
                            }
                        }
                        if (all_pad) continue;
                        float fw = b->weight_at((int32_t)i, bpos, bwidx, nb);
                        bulk::add_token(b, g, size, doc, fw);
                    }
                }
                if (size == max_size) break;
            }

            // ---- whole words >= min n-gram size ------------------------
            const int32_t base = cont ? 0 : b->start_pad;
            const int32_t min_size = b->sizes.empty() ? 1 : b->sizes[0];
            int64_t i = 0;
            while (i < len) {
                while (i < len && b->is_delim(t[i])) i++;
                if (i >= len) break;
                int64_t start = i;
                while (i < len && !b->is_delim(t[i])) i++;
                int64_t wl = i - start;
                if (wl >= min_size) {
                    float fw = b->weight_at((int32_t)(base + start), bpos,
                                            bwidx, nb);
                    bulk::add_token(b, t + start, (int32_t)wl, doc, fw);
                }
            }
        }

        // ---- short-query positional prefix index ----------------------
        if (b->sq_enabled) {
            const uint32_t* st = sq_text + sq_offsets[d];
            const int64_t sl = sq_offsets[d + 1] - sq_offsets[d];
            int64_t i = 0;
            int32_t token_index = 0;
            while (i < sl) {
                while (i < sl && b->is_delim(st[i])) i++;
                int64_t start = i;
                while (i < sl && !b->is_delim(st[i])) i++;
                int64_t wl = i - start;
                if (wl > 0) {
                    int32_t maxp = (int32_t)std::min<int64_t>(wl, b->sq_max);
                    for (int32_t plen = b->sq_min; plen <= maxp; plen++) {
                        bool added = false;
                        int32_t id = b->sq_dict.get_or_add(st + start, plen,
                                                           &added);
                        if (added) b->sq_lists.emplace_back();
                        b->sq_lists[(size_t)id].push_back(
                            ((int64_t)doc << 32) | (uint32_t)token_index);
                    }
                    token_index++;
                }
            }
        }

        // ---- word matcher ---------------------------------------------
        if (b->wm_enabled) {
            const uint32_t* wt = wm_text + wm_offsets[d];
            const int64_t wlen = wm_offsets[d + 1] - wm_offsets[d];
            int64_t i = 0;
            while (i < wlen) {
                while (i < wlen && b->is_delim(wt[i])) i++;
                if (i >= wlen) break;
                int64_t start = i;
                while (i < wlen && !b->is_delim(wt[i])) i++;
                int32_t n = (int32_t)(i - start);
                const uint32_t* w = wt + start;
                if (n >= b->wm_min_exact && n <= b->wm_max_exact)
                    b->wm_exact.add(w, n, doc);
                if (b->wm_ld1 && n >= b->wm_min_ld1 && n <= b->wm_max_ld1) {
                    scratch.resize((size_t)n - 1);
                    for (int32_t del = 0; del < n; del++) {
                        int32_t k = 0;
                        for (int32_t j = 0; j < n; j++)
                            if (j != del) scratch[(size_t)k++] = w[j];
                        b->wm_ld1_map.add(scratch.data(), n - 1, doc);
                    }
                }
                if (b->wm_affix && n >= b->wm_min_ld1)
                    b->wm_affix_map.add(w, n, doc);
            }
        }
    }
}

// ---- export: terms + CSR postings ----------------------------------

int64_t infidex_bulk_num_terms(void* h) {
    return (int64_t)((bulk::Builder*)h)->terms.keys.size();
}

int64_t infidex_bulk_terms_blob_len(void* h) {
    auto* b = (bulk::Builder*)h;
    int64_t n = 0;
    for (auto& k : b->terms.keys) n += k.n;
    return n;
}

void infidex_bulk_copy_terms(void* h, uint32_t* blob, int64_t* offsets) {
    auto* b = (bulk::Builder*)h;
    int64_t pos = 0;
    int64_t i = 0;
    for (auto& k : b->terms.keys) {
        offsets[i++] = pos;
        std::memcpy(blob + pos, k.p, (size_t)k.n * 4);
        pos += k.n;
    }
    offsets[i] = pos;
}

int64_t infidex_bulk_postings_len(void* h) {
    auto* b = (bulk::Builder*)h;
    int64_t n = 0;
    for (auto& p : b->postings)
        if (p.df > 0) n += (int64_t)p.docs.size();
    return n;
}

void infidex_bulk_copy_postings(void* h, int64_t* term_offsets,
                                int32_t* docs, uint8_t* weights,
                                int32_t* dfs) {
    auto* b = (bulk::Builder*)h;
    int64_t pos = 0;
    for (size_t t = 0; t < b->postings.size(); t++) {
        auto& p = b->postings[t];
        term_offsets[t] = pos;
        dfs[t] = (int32_t)p.df;
        if (p.df > 0 && !p.docs.empty()) {
            std::memcpy(docs + pos, p.docs.data(), p.docs.size() * 4);
            std::memcpy(weights + pos, p.weights.data(), p.weights.size());
            pos += (int64_t)p.docs.size();
        }
    }
    term_offsets[b->postings.size()] = pos;
}

// ---- export: word-matcher maps (which: 0=exact 1=ld1 2=affix) -------

static bulk::DocListMap* wm_map(void* h, int32_t which) {
    auto* b = (bulk::Builder*)h;
    if (which == 0) return &b->wm_exact;
    if (which == 1) return &b->wm_ld1_map;
    return &b->wm_affix_map;
}

int64_t infidex_bulk_wm_num_keys(void* h, int32_t which) {
    return (int64_t)wm_map(h, which)->dict.keys.size();
}

int64_t infidex_bulk_wm_blob_len(void* h, int32_t which) {
    int64_t n = 0;
    for (auto& k : wm_map(h, which)->dict.keys) n += k.n;
    return n;
}

int64_t infidex_bulk_wm_docs_len(void* h, int32_t which) {
    int64_t n = 0;
    for (auto& v : wm_map(h, which)->lists) n += (int64_t)v.size();
    return n;
}

void infidex_bulk_copy_wm(void* h, int32_t which, uint32_t* blob,
                          int64_t* key_offsets, int64_t* doc_offsets,
                          int32_t* doc_ids) {
    auto* m = wm_map(h, which);
    int64_t bpos = 0, dpos = 0;
    for (size_t i = 0; i < m->dict.keys.size(); i++) {
        key_offsets[i] = bpos;
        doc_offsets[i] = dpos;
        auto& k = m->dict.keys[i];
        std::memcpy(blob + bpos, k.p, (size_t)k.n * 4);
        bpos += k.n;
        auto& v = m->lists[i];
        std::memcpy(doc_ids + dpos, v.data(), v.size() * 4);
        dpos += (int64_t)v.size();
    }
    key_offsets[m->dict.keys.size()] = bpos;
    doc_offsets[m->dict.keys.size()] = dpos;
}

// ---- export: short-query prefix index --------------------------------

int64_t infidex_bulk_sq_num_keys(void* h) {
    return (int64_t)((bulk::Builder*)h)->sq_dict.keys.size();
}

int64_t infidex_bulk_sq_blob_len(void* h) {
    int64_t n = 0;
    for (auto& k : ((bulk::Builder*)h)->sq_dict.keys) n += k.n;
    return n;
}

int64_t infidex_bulk_sq_postings_len(void* h) {
    int64_t n = 0;
    for (auto& v : ((bulk::Builder*)h)->sq_lists) n += (int64_t)v.size();
    return n;
}

void infidex_bulk_copy_sq(void* h, uint32_t* blob, int64_t* key_offsets,
                          int64_t* post_offsets, int64_t* postings) {
    auto* b = (bulk::Builder*)h;
    int64_t bpos = 0, ppos = 0;
    for (size_t i = 0; i < b->sq_dict.keys.size(); i++) {
        key_offsets[i] = bpos;
        post_offsets[i] = ppos;
        auto& k = b->sq_dict.keys[i];
        std::memcpy(blob + bpos, k.p, (size_t)k.n * 4);
        bpos += k.n;
        auto& v = b->sq_lists[i];
        std::memcpy(postings + ppos, v.data(), v.size() * 8);
        ppos += (int64_t)v.size();
    }
    key_offsets[b->sq_dict.keys.size()] = bpos;
    post_offsets[b->sq_dict.keys.size()] = ppos;
}

}  // extern "C"

// ===================================================================
// Coverage token tables + per-doc word stats (ops/coverage_kernel.py
// CoverageTables.build and VectorModel._build_word_idf_cache /
// _build_document_metadata_cache loop replacements).
// ===================================================================

namespace bulk {

static bool py_isspace(uint32_t c) {
    // mirrors str.isspace() for the code points that can appear in
    // delimiter gaps
    if (c >= 0x09 && c <= 0x0D) return true;
    if (c >= 0x1C && c <= 0x1F) return true;
    if (c == 0x20 || c == 0x85 || c == 0xA0 || c == 0x1680) return true;
    if (c >= 0x2000 && c <= 0x200A) return true;
    if (c == 0x2028 || c == 0x2029 || c == 0x202F || c == 0x205F ||
        c == 0x3000)
        return true;
    return false;
}

struct CovTables {
    StrMap words;
    std::vector<int32_t> doc_tokens, doc_offsets, doc_count, doc_text_len,
        max_wlen;
    std::vector<uint8_t> doc_adj, overflow;
    int32_t d_max, l_max;
};

}  // namespace bulk

extern "C" {

void* infidex_cov_build(const uint32_t* text, const int64_t* offsets,
                        int64_t n_docs, const uint32_t* delims,
                        int32_t n_delims, int32_t d_max, int32_t l_max) {
    auto* ct = new bulk::CovTables();
    ct->d_max = d_max;
    ct->l_max = l_max;
    std::vector<uint32_t> sorted_delims(delims, delims + n_delims);
    std::sort(sorted_delims.begin(), sorted_delims.end());
    auto is_delim = [&](uint32_t c) {
        return std::binary_search(sorted_delims.begin(), sorted_delims.end(),
                                  c);
    };
    ct->doc_tokens.assign((size_t)n_docs * d_max, -1);
    ct->doc_offsets.assign((size_t)n_docs * d_max, 0);
    ct->doc_count.assign((size_t)n_docs, 0);
    ct->doc_adj.assign((size_t)n_docs * d_max, 0);
    ct->doc_text_len.assign((size_t)n_docs, 0);
    ct->overflow.assign((size_t)n_docs, 0);
    ct->max_wlen.assign((size_t)n_docs, 0);

    std::vector<std::pair<int64_t, int64_t>> toks;  // (start, len)
    for (int64_t d = 0; d < n_docs; d++) {
        const uint32_t* t = text + offsets[d];
        const int64_t ln = offsets[d + 1] - offsets[d];
        ct->doc_text_len[(size_t)d] = (int32_t)ln;
        toks.clear();
        int64_t i = 0;
        while (i < ln) {
            while (i < ln && is_delim(t[i])) i++;
            int64_t start = i;
            while (i < ln && !is_delim(t[i])) i++;
            if (i > start) toks.emplace_back(start, i - start);
        }
        if ((int64_t)toks.size() > ct->d_max) {
            ct->overflow[(size_t)d] = 1;
            toks.resize((size_t)ct->d_max);
        }
        ct->doc_count[(size_t)d] = (int32_t)toks.size();
        for (size_t j = 0; j < toks.size(); j++) {
            int64_t off = toks[j].first;
            int64_t wl = toks[j].second;
            if (wl > ct->l_max) {
                ct->overflow[(size_t)d] = 1;
                wl = ct->l_max;
            }
            if ((int32_t)wl > ct->max_wlen[(size_t)d])
                ct->max_wlen[(size_t)d] = (int32_t)wl;
            int32_t code = ct->words.get_or_add(t + off, (int32_t)wl,
                                                nullptr);
            ct->doc_tokens[(size_t)d * ct->d_max + j] = code;
            ct->doc_offsets[(size_t)d * ct->d_max + j] = (int32_t)off;
            if (j + 1 < toks.size()) {
                bool adj = true;
                for (int64_t g = off + wl; g < toks[j + 1].first; g++)
                    if (!bulk::py_isspace(t[g])) { adj = false; break; }
                ct->doc_adj[(size_t)d * ct->d_max + j] = adj ? 1 : 0;
            }
        }
    }
    return ct;
}

int64_t infidex_cov_num_words(void* h) {
    return (int64_t)((bulk::CovTables*)h)->words.keys.size();
}

void infidex_cov_copy(void* h, int32_t* word_chars, int32_t* word_chars_rev,
                      int32_t* word_lens, int32_t* doc_tokens,
                      int32_t* doc_offsets, int32_t* doc_count,
                      uint8_t* doc_adj, int32_t* doc_text_len,
                      uint8_t* overflow, int32_t* max_wlen) {
    auto* ct = (bulk::CovTables*)h;
    const int32_t L = ct->l_max;
    for (size_t c = 0; c < ct->words.keys.size(); c++) {
        auto& k = ct->words.keys[c];
        word_lens[c] = k.n;
        for (int32_t i = 0; i < k.n; i++) {
            word_chars[c * (size_t)L + i] = (int32_t)k.p[i];
            word_chars_rev[c * (size_t)L + (k.n - 1 - i)] = (int32_t)k.p[i];
        }
    }
    std::memcpy(doc_tokens, ct->doc_tokens.data(),
                ct->doc_tokens.size() * 4);
    std::memcpy(doc_offsets, ct->doc_offsets.data(),
                ct->doc_offsets.size() * 4);
    std::memcpy(doc_count, ct->doc_count.data(), ct->doc_count.size() * 4);
    std::memcpy(doc_adj, ct->doc_adj.data(), ct->doc_adj.size());
    std::memcpy(doc_text_len, ct->doc_text_len.data(),
                ct->doc_text_len.size() * 4);
    std::memcpy(overflow, ct->overflow.data(), ct->overflow.size());
    std::memcpy(max_wlen, ct->max_wlen.data(), ct->max_wlen.size() * 4);
}

void infidex_cov_free(void* h) { delete (bulk::CovTables*)h; }

// ---- per-doc word stats: word df (unique docs) + first token + count --

void* infidex_wordstats_build(const uint32_t* text, const int64_t* offsets,
                              int64_t n_docs, const uint32_t* delims,
                              int32_t n_delims, const uint8_t* skip) {
    // skip[d] != 0 -> doc excluded (deleted / empty)
    auto* m = new bulk::DocListMap();
    std::vector<uint32_t> sorted_delims(delims, delims + n_delims);
    std::sort(sorted_delims.begin(), sorted_delims.end());
    auto is_delim = [&](uint32_t c) {
        return std::binary_search(sorted_delims.begin(), sorted_delims.end(),
                                  c);
    };
    for (int64_t d = 0; d < n_docs; d++) {
        if (skip && skip[d]) continue;
        const uint32_t* t = text + offsets[d];
        const int64_t ln = offsets[d + 1] - offsets[d];
        int64_t i = 0;
        while (i < ln) {
            while (i < ln && is_delim(t[i])) i++;
            int64_t start = i;
            while (i < ln && !is_delim(t[i])) i++;
            if (i > start)
                m->add(t + start, (int32_t)(i - start), (int32_t)d);
        }
    }
    return m;
}

int64_t infidex_wordstats_num(void* h) {
    return (int64_t)((bulk::DocListMap*)h)->dict.keys.size();
}

int64_t infidex_wordstats_blob_len(void* h) {
    int64_t n = 0;
    for (auto& k : ((bulk::DocListMap*)h)->dict.keys) n += k.n;
    return n;
}

void infidex_wordstats_copy(void* h, uint32_t* blob, int64_t* key_offsets,
                            int64_t* dfs) {
    auto* m = (bulk::DocListMap*)h;
    int64_t bpos = 0;
    for (size_t i = 0; i < m->dict.keys.size(); i++) {
        key_offsets[i] = bpos;
        auto& k = m->dict.keys[i];
        std::memcpy(blob + bpos, k.p, (size_t)k.n * 4);
        bpos += k.n;
        dfs[i] = (int64_t)m->lists[i].size();
    }
    key_offsets[m->dict.keys.size()] = bpos;
}

void infidex_wordstats_free(void* h) { delete (bulk::DocListMap*)h; }


// ---------------------------------------------------------------------
// Exact BM25+ of pool docs over query terms (candidates.score_pool twin;
// identical f32 op order => bit-identical scores, rankings preserved).
// pool must be ascending; postings are doc-sorted, so each term joins
// with a monotone galloping search instead of per-element binary search.

void infidex_score_pool(const int64_t* term_offsets,
                        const int32_t* postings_docs,
                        const uint8_t* postings_weights,
                        const float* doc_lengths, int64_t n_docs,
                        float avgdl,
                        const int64_t* term_ids, const float* idfs,
                        int32_t n_terms,
                        const int64_t* pool, int32_t n_pool,
                        float* out) {
    const float K1 = 1.2f, Bc = 0.75f, DELTA = 1.0f;
    if (avgdl < 1e-9f) avgdl = 1e-9f;
    std::vector<float> norm((size_t)n_pool);
    for (int32_t i = 0; i < n_pool; i++) {
        int64_t d = pool[i];
        float dl = (d >= 0 && d < n_docs) ? doc_lengths[d] : 1.0f;
        if (dl <= 0.0f) dl = 1.0f;
        norm[(size_t)i] = K1 * (1.0f - Bc + Bc * (dl / avgdl));
        out[i] = 0.0f;
    }
    for (int32_t t = 0; t < n_terms; t++) {
        int64_t tid = term_ids[t];
        float idf = idfs[t];
        const int32_t* p = postings_docs + term_offsets[tid];
        const uint8_t* w = postings_weights + term_offsets[tid];
        int64_t n = term_offsets[tid + 1] - term_offsets[tid];
        if (n <= 0) continue;
        // Postings slices are cache-cold at 1M docs: a SEQUENTIAL scan
        // rides the hardware prefetcher (~2G entries/s), while each
        // probe is a ~100ns dependent miss. 3 probes/doc beats a linear
        // scan only when df >> ~600 * n_pool; below a conservative
        // 64 * n_pool, two-pointer linear merge wins outright. Join
        // strategy only — the accumulation order (ascending pool, term
        // outer loop) and f32 ops are identical either way.
        if (n <= (int64_t)n_pool * 64) {
            int64_t li = 0;
            for (int32_t i = 0; i < n_pool && li < n; i++) {
                int32_t d = (int32_t)pool[i];
                while (li < n && p[li] < d) li++;
                if (li < n && p[li] == d) {
                    float tf = (float)w[li];
                    out[i] += idf * ((tf * (K1 + 1.0f))
                                     / (tf + norm[(size_t)i]) + DELTA);
                    li++;
                }
            }
            continue;
        }
        int64_t lo = 0;
        for (int32_t i = 0; i < n_pool && lo < n; i++) {
            int32_t d = (int32_t)pool[i];
            if (d < p[lo]) continue;
            if (p[lo] == d) {
                float tf = (float)w[lo];
                out[i] += idf * ((tf * (K1 + 1.0f)) / (tf + norm[(size_t)i])
                                 + DELTA);
                lo++;
                continue;
            }
            if (d > p[n - 1]) { lo = n; break; }  // pool ascending: done
            // Interpolation-start probe: postings ids are near-uniform
            // over the doc space, so estimate the position and bracket
            // with a short local gallop — ~3 touches of the (large,
            // cache-cold) posting array instead of log2(df) ~ 20 for a
            // from-scratch binary search. Search strategy only; the
            // lower-bound result (and the f32 op order) are unchanged.
            double span = (double)p[n - 1] - (double)p[lo];
            int64_t est = lo;
            if (span > 0.0)
                est = lo + (int64_t)(((double)d - (double)p[lo]) / span
                                     * (double)(n - 1 - lo));
            if (est < lo) est = lo;
            if (est >= n) est = n - 1;
            int64_t a, b, step = 8;
            if (p[est] < d) {
                a = est + 1;
                b = a + step;
                while (b < n && p[b] < d) { a = b + 1; b += (step <<= 1); }
                if (b > n) b = n;
            } else {
                b = est;
                a = b - step;
                if (a < lo) a = lo;
                while (a > lo && p[a] > d) {
                    b = a;
                    a -= (step <<= 1);
                    if (a < lo) a = lo;
                }
            }
            while (a < b) {
                int64_t mid = (a + b) >> 1;
                if (p[mid] < d) a = mid + 1; else b = mid;
            }
            if (a < n && p[a] == d) {
                float tf = (float)w[a];
                out[i] += idf * ((tf * (K1 + 1.0f)) / (tf + norm[(size_t)i])
                                 + DELTA);
                lo = a + 1;
            } else {
                lo = a;
            }
        }
    }
}

// OR-into membership: mask[i] |= (cand[i] in post). cand ascending,
// post sorted unique ascending (a postings list). Already-set entries
// are SKIPPED — across the conjunctive filter's evidence lists the
// unresolved set shrinks monotonically, so total probe work drops with
// every list (numpy's searchsorted re-probes everything every time).
// The moving lower bound + gallop makes one pass O(n_cand * log(gap)).
void infidex_member_any(const int32_t* post, int64_t n_post,
                        const int64_t* cand, int64_t n_cand,
                        uint8_t* mask) {
    int64_t lo = 0;
    for (int64_t i = 0; i < n_cand && lo < n_post; i++) {
        if (mask[i]) continue;
        int32_t v = (int32_t)cand[i];
        if (v < post[lo]) continue;
        if (post[lo] == v) { mask[i] = 1; continue; }
        // gallop forward from lo, then binary-search the bracket
        int64_t step = 1, hi = lo;
        while (hi < n_post && post[hi] < v) {
            lo = hi + 1; hi = lo + step; step <<= 1;
        }
        if (hi > n_post) hi = n_post;
        while (lo < hi) {
            int64_t mid = (lo + hi) >> 1;
            if (post[mid] < v) lo = mid + 1; else hi = mid;
        }
        if (lo < n_post && post[lo] == v) mask[i] = 1;
    }
}

// ---------------------------------------------------------------------
// Tiered candidate selection (candidates.TieredCandidateSelector.select
// twin; behavioral reference Scoring/TieredCandidateSelector.cs tiered-AND
// path). Produces the IDENTICAL pool as the numpy implementation: same
// deterministic champion rule (top-cap by weight desc, doc asc), same
// intersection order (terms pre-sorted df-asc by the caller), same
// sorted-unique union, same per-tier size exits.

namespace tier {

// intersection of two sorted-unique int32 arrays (gallop the smaller
// through the larger with a moving lower bound); result ascending.
static void isect(const int32_t* a, int64_t na, const int32_t* b, int64_t nb,
                  std::vector<int32_t>& out) {
    out.clear();
    if (na > nb) { std::swap(a, b); std::swap(na, nb); }
    int64_t lo = 0;
    for (int64_t i = 0; i < na && lo < nb; i++) {
        int32_t v = a[i];
        int64_t step = 1, hi = lo;
        while (hi < nb && b[hi] < v) { lo = hi + 1; hi = lo + step; step <<= 1; }
        if (hi > nb) hi = nb;
        while (lo < hi) {
            int64_t mid = (lo + hi) >> 1;
            if (b[mid] < v) lo = mid + 1; else hi = mid;
        }
        if (lo < nb && b[lo] == v) out.push_back(v);
    }
}

// top-cap postings by (weight desc, doc asc), doc-ascending output —
// the deterministic champion rule (candidates._top_weight_idx twin).
static void champions(const int32_t* docs, const uint8_t* w, int64_t n,
                      int64_t cap, std::vector<int32_t>& out) {
    out.clear();
    if (n <= cap) { out.assign(docs, docs + n); return; }
    int64_t hist[256] = {0};
    for (int64_t i = 0; i < n; i++) hist[w[i]]++;
    int64_t above = 0, wt = 255;
    for (;; wt--) {               // largest wt with count(>= wt) >= cap
        if (above + hist[wt] >= cap || wt == 0) break;
        above += hist[wt];
    }
    int64_t take_eq = cap - above;
    out.reserve((size_t)cap);
    for (int64_t i = 0; i < n && (int64_t)out.size() < cap; i++) {
        if (w[i] > wt) out.push_back(docs[i]);
        else if (w[i] == wt && take_eq > 0) { out.push_back(docs[i]); take_eq--; }
    }
}

// sorted-unique union of sorted parts (repeated two-way merges; parts
// are few and cap-bounded).
static void merge_unique(const std::vector<std::vector<int32_t>>& parts,
                         std::vector<int32_t>& out) {
    out.clear();
    std::vector<int32_t> tmp;
    for (const auto& p : parts) {
        if (p.empty()) continue;
        if (out.empty()) { out = p; continue; }
        tmp.clear();
        tmp.reserve(out.size() + p.size());
        size_t i = 0, j = 0;
        while (i < out.size() && j < p.size()) {
            int32_t a = out[i], b = p[j];
            if (a < b) { tmp.push_back(a); i++; }
            else if (b < a) { tmp.push_back(b); j++; }
            else { tmp.push_back(a); i++; j++; }
        }
        while (i < out.size()) tmp.push_back(out[i++]);
        while (j < p.size()) tmp.push_back(p[j++]);
        out.swap(tmp);
    }
}

// Champion-list memo: champions(term, cap) is deterministic per index
// build, costs two full passes over a df-sized postings slice (the
// histogram + the selection scan — ~0.5ms at df 10^5), and serving
// streams repeat terms Zipf-style. Keyed by (tid, cap) and invalidated
// whenever the caller's generation token changes (BuiltIndex.gen bumps
// per finalize — same invalidation contract as the WordMatcher.lookup
// memo). Mutex-guarded: tier_select may run on prefetch-pool threads.
static std::mutex g_champ_mu;
static std::unordered_map<uint64_t, std::vector<int32_t>> g_champ;
static uint64_t g_champ_gen = ~(uint64_t)0;
static size_t g_champ_ints = 0;
static const size_t CHAMP_CACHE_MAX_INTS = 16u << 20;  // 64MB of int32

static void champions_cached(uint64_t generation, int64_t tid,
                             const int32_t* docs, const uint8_t* w,
                             int64_t n, int64_t cap,
                             std::vector<int32_t>& out) {
    if (n <= cap) { out.assign(docs, docs + n); return; }
    if (generation == 0) {  // no build token: caller opted out of memo
        tier::champions(docs, w, n, cap, out);
        return;
    }
    const uint64_t key = ((uint64_t)tid << 20) | (uint64_t)(cap & 0xFFFFF);
    {
        std::lock_guard<std::mutex> g(g_champ_mu);
        if (generation != g_champ_gen) {
            g_champ.clear();
            g_champ_ints = 0;
            g_champ_gen = generation;
        }
        auto it = g_champ.find(key);
        if (it != g_champ.end()) { out = it->second; return; }
    }
    tier::champions(docs, w, n, cap, out);
    std::lock_guard<std::mutex> g(g_champ_mu);
    if (generation == g_champ_gen) {
        if (g_champ_ints + out.size() > CHAMP_CACHE_MAX_INTS) {
            g_champ.clear();
            g_champ_ints = 0;
        }
        auto ins = g_champ.emplace(key, out);
        if (ins.second) g_champ_ints += out.size();
    }
}

// Cumulative per-phase wall seconds inside infidex_tier_select, for
// the measurement scripts (scripts/tier_profile.py): [0]=inter copy +
// all-terms isect, [1]=rarest champions, [2]=n-1 isect, [3]=selective
// champions, [4]=merges, [5]=call count. ~100ns of clock reads per
// call against a ~1ms body.
static double g_tier_phase[8] = {0};

}  // namespace tier

extern "C" void infidex_tier_phase_stats(double* out, int32_t reset) {
    for (int i = 0; i < 8; i++) out[i] = tier::g_tier_phase[i];
    if (reset)
        for (int i = 0; i < 8; i++) tier::g_tier_phase[i] = 0.0;
}

namespace tier {

// Shared select core (infidex_tier_select and infidex_tier_batch):
// ordered_tids df-asc, sel_tids the <=2 selective high-IDF ids. Fills
// ``merged`` (sorted-unique pool) and returns the tier label 1/2/3.
// Identical pool to the numpy twin; the only deviation from the numpy
// structure is intersecting the first two postings slices DIRECTLY
// instead of copying the rarest term's full df-sized slice first (the
// copy was ~25% of phase-0 time at 1M; the intersection result is
// identical).
static int32_t select_core(const int64_t* term_offsets,
                           const int32_t* postings_docs,
                           const uint8_t* postings_weights,
                           const int64_t* ordered_tids, int32_t n_terms,
                           const int64_t* sel_tids, int32_t n_sel,
                           int32_t top_k, uint64_t generation,
                           std::vector<int32_t>& merged) {
    const int64_t cap = (int64_t)top_k * 10;
    auto range = [&](int64_t t, const int32_t** d, const uint8_t** w,
                     int64_t* n) {
        int64_t s = term_offsets[t], e = term_offsets[t + 1];
        *d = postings_docs + s;
        *w = postings_weights + s;
        *n = e - s;
    };
    auto now = [] {
        return std::chrono::duration<double>(
            std::chrono::steady_clock::now().time_since_epoch()).count();
    };
    double t0 = now(), t1;
    g_tier_phase[5] += 1.0;

    std::vector<std::vector<int32_t>> parts;
    std::vector<int32_t> tmp;

    // Tier 1: all-terms intersection, rarest first.
    const int32_t* d0; const uint8_t* w0; int64_t n0;
    range(ordered_tids[0], &d0, &w0, &n0);
    std::vector<int32_t> inter;
    if (n_terms >= 2) {
        const int32_t* d1; const uint8_t* w1; int64_t n1;
        range(ordered_tids[1], &d1, &w1, &n1);
        isect(d0, n0, d1, n1, inter);
        for (int32_t i = 2; i < n_terms && !inter.empty(); i++) {
            const int32_t* di; const uint8_t* wi; int64_t ni;
            range(ordered_tids[i], &di, &wi, &ni);
            isect(inter.data(), (int64_t)inter.size(), di, ni, tmp);
            inter.swap(tmp);
        }
    } else {
        inter.assign(d0, d0 + n0);
    }
    int64_t inter_full = (int64_t)inter.size();
    if (inter_full > cap) inter.resize((size_t)cap);
    t1 = now(); g_tier_phase[0] += t1 - t0; t0 = t1;
    parts.push_back(inter);
    parts.emplace_back();
    champions_cached(generation, ordered_tids[0], d0, w0, n0, cap,
                     parts.back());
    t1 = now(); g_tier_phase[1] += t1 - t0; t0 = t1;
    merge_unique(parts, merged);
    t1 = now(); g_tier_phase[4] += t1 - t0; t0 = t1;
    int32_t label = 3;
    if (inter_full >= (int64_t)top_k * 2) {
        label = 1;
    } else {
        // Tier 2: n-1 terms (drop the rarest).
        if (n_terms >= 3) {
            const int32_t* d1; const uint8_t* w1; int64_t n1;
            range(ordered_tids[1], &d1, &w1, &n1);
            const int32_t* d2; const uint8_t* w2; int64_t n2;
            range(ordered_tids[2], &d2, &w2, &n2);
            std::vector<int32_t> inter2;
            isect(d1, n1, d2, n2, inter2);
            for (int32_t i = 3; i < n_terms && !inter2.empty(); i++) {
                const int32_t* di; const uint8_t* wi; int64_t ni;
                range(ordered_tids[i], &di, &wi, &ni);
                isect(inter2.data(), (int64_t)inter2.size(), di, ni, tmp);
                inter2.swap(tmp);
            }
            if ((int64_t)inter2.size() > cap) inter2.resize((size_t)cap);
            t1 = now(); g_tier_phase[2] += t1 - t0; t0 = t1;
            parts.push_back(std::move(inter2));
            merge_unique(parts, merged);
            t1 = now(); g_tier_phase[4] += t1 - t0; t0 = t1;
            if ((int64_t)merged.size() >= (int64_t)top_k * 3) label = 2;
        }
        if (label == 3) {
            // Tier 3: <= 2 selective high-IDF champion lists.
            for (int32_t i = 0; i < n_sel; i++) {
                const int32_t* di; const uint8_t* wi; int64_t ni;
                range(sel_tids[i], &di, &wi, &ni);
                parts.emplace_back();
                champions_cached(generation, sel_tids[i], di, wi, ni, cap,
                                 parts.back());
                t1 = now(); g_tier_phase[3] += t1 - t0; t0 = t1;
                merge_unique(parts, merged);
                t1 = now(); g_tier_phase[4] += t1 - t0; t0 = t1;
                if ((int64_t)merged.size() >= (int64_t)top_k * 10) break;
            }
        }
    }
    return label;
}

}  // namespace tier

// ordered_tids: live term ids sorted (df asc, stable); sel_tids: the
// <=2 selective high-IDF term ids (df-sorted); out_pool capacity >=
// 5 * top_k * 10. Returns pool size; *tier_out = 1 "all",
// 2 "all-minus-one", 3 "selective". ``generation`` keys the champion
// memo (bump per index build to invalidate).
int64_t infidex_tier_select(const int64_t* term_offsets,
                            const int32_t* postings_docs,
                            const uint8_t* postings_weights,
                            const int64_t* ordered_tids, int32_t n_terms,
                            const int64_t* sel_tids, int32_t n_sel,
                            int32_t top_k, uint64_t generation,
                            int64_t* out_pool, int32_t* tier_out) {
    std::vector<int32_t> merged;
    *tier_out = tier::select_core(term_offsets, postings_docs,
                                  postings_weights, ordered_tids, n_terms,
                                  sel_tids, n_sel, top_k, generation,
                                  merged);
    for (size_t i = 0; i < merged.size(); i++) out_pool[i] = merged[i];
    return (int64_t)merged.size();
}

// ---------------------------------------------------------------------
// Batched tier Stage-1 (VERDICT r4 task #3): select + deleted-filter +
// exact BM25 + top-k for a WHOLE batch of tier-gated queries in ONE
// GIL-released call — replaces per-query Python glue (thread-pool
// submit, ctypes marshalling, numpy temporaries, argsort) that cost
// ~0.7ms/query of the 2.4ms/query warm host cost at 1M docs.
//
// Per query q (replicating candidates.TieredCandidateSelector.select +
// TieredStage1.run EXACTLY — behavioral ref Scoring/
// TieredCandidateSelector.cs:108-236):
//   terms   = term_ids[q_off[q]:q_off[q+1]] with idfs aligned
//   live    = terms with df > 0 (df read straight from the CSR offsets)
//   union routing (single live term / missing terms / typo-suspect
//     df < 10) => label 0: caller sends the query to the device path
//   ordered = live stable-sorted df-asc; selective = idf >= 0.3*max,
//     stable df-asc, first 2
//   pool    = tier::select_core(...); deleted docs dropped
//   scores  = BM25+ over the ORIGINAL term order (f32 op order matches
//     the numpy twin bit-for-bit); top_k by (score desc, id asc)
// Outputs are zero-padded [n_queries x top_k] slabs. out_label[q] = 0
// means "route to device" (union or empty pool).
int64_t infidex_tier_batch(
    const int64_t* term_offsets, const int32_t* postings_docs,
    const uint8_t* postings_weights, const float* doc_lengths,
    int64_t n_docs, float avgdl,
    const int32_t* df,                 // BuiltIndex.df — NOT the CSR
                                       // delta: occurrence-counted, -1
                                       // for stop terms, decremented on
                                       // delete (builder.py Term)
    const int64_t* q_offsets,          // [n_queries + 1]
    const int64_t* term_ids_flat,      // query order, concatenated
    const float* idfs_flat,            // aligned with term_ids_flat
    int32_t n_queries, int32_t top_k, uint64_t generation,
    const uint8_t* deleted, int64_t n_deleted,   // 0 => no filter
    float* out_scores, int32_t* out_ids, int32_t* out_label) {
    const int32_t TYPO_SUSPECT_DF = 10;
    std::vector<int32_t> merged;
    std::vector<int64_t> pool;
    std::vector<float> scores;
    std::vector<int32_t> order;
    std::vector<int64_t> ordered, sel;
    std::vector<float> live_idf;
    std::vector<int64_t> live_t;

    for (int32_t q = 0; q < n_queries; q++) {
        float* o_sc = out_scores + (int64_t)q * top_k;
        int32_t* o_id = out_ids + (int64_t)q * top_k;
        std::memset(o_sc, 0, sizeof(float) * (size_t)top_k);
        std::memset(o_id, 0, sizeof(int32_t) * (size_t)top_k);
        out_label[q] = 0;
        const int64_t s = q_offsets[q], e = q_offsets[q + 1];
        const int64_t nt = e - s;
        if (nt <= 0) continue;

        // live terms (df > 0), preserving query order — df semantics
        // exactly as candidates.select: BuiltIndex.df, not the CSR span
        live_t.clear(); live_idf.clear();
        bool typo_suspect = false;
        for (int64_t i = s; i < e; i++) {
            int64_t t = term_ids_flat[i];
            if (t < 0 || df[t] <= 0) continue;
            if (df[t] < TYPO_SUSPECT_DF) typo_suspect = true;
            live_t.push_back(t);
            live_idf.push_back(idfs_flat[i]);
        }
        const int64_t nl = (int64_t)live_t.size();
        bool missing = nl < nt;
        if (nl == 0 || nl == 1 || missing || typo_suspect)
            continue;  // union => device path (label stays 0)

        // stable df-asc ordering of the live terms
        ordered.resize((size_t)nl);
        for (int64_t i = 0; i < nl; i++) ordered[(size_t)i] = i;
        std::stable_sort(ordered.begin(), ordered.end(),
                         [&](int64_t a, int64_t b) {
            return df[live_t[(size_t)a]] < df[live_t[(size_t)b]];
        });
        for (int64_t i = 0; i < nl; i++)
            ordered[(size_t)i] = live_t[(size_t)ordered[(size_t)i]];

        // selective: idf >= 0.3 * max_idf, stable df-asc, first 2.
        // Threshold in DOUBLE: the Python twin compares in float64
        // (idfs are f32-exact values, so widening loses nothing and the
        // borderline classification matches bit-for-bit).
        float max_idf = live_idf[0];
        for (float v : live_idf) if (v > max_idf) max_idf = v;
        sel.clear();
        for (int64_t i = 0; i < nl; i++)
            if ((double)live_idf[(size_t)i] >= 0.3 * (double)max_idf)
                sel.push_back(live_t[(size_t)i]);
        std::stable_sort(sel.begin(), sel.end(),
                         [&](int64_t a, int64_t b) {
            return df[a] < df[b];
        });
        if (sel.size() > 2) sel.resize(2);

        merged.clear();
        int32_t label = tier::select_core(
            term_offsets, postings_docs, postings_weights,
            ordered.data(), (int32_t)nl, sel.data(), (int32_t)sel.size(),
            top_k, generation, merged);

        // deleted filter (pool stays ascending)
        pool.clear();
        pool.reserve(merged.size());
        if (n_deleted > 0) {
            for (int32_t d : merged)
                if (!(d >= 0 && d < n_deleted && deleted[d]))
                    pool.push_back((int64_t)d);
        } else {
            for (int32_t d : merged) pool.push_back((int64_t)d);
        }
        const int64_t np = (int64_t)pool.size();
        if (np == 0) continue;  // label 0: device fallback

        // exact BM25+ over the LIVE terms in ORIGINAL query order —
        // bit-identical to the numpy twin scoring the full list, since
        // dead terms (t < 0 or empty postings) contribute exactly 0 and
        // skipping them cannot reorder the f32 accumulation. (Negative
        // ids would also be out-of-bounds reads on term_offsets here.)
        scores.resize((size_t)np);
        infidex_score_pool(term_offsets, postings_docs, postings_weights,
                           doc_lengths, n_docs, avgdl,
                           live_t.data(), live_idf.data(), (int32_t)nl,
                           pool.data(), (int32_t)np, scores.data());

        // top_k by (score desc, pool index asc) == top_desc_idx
        order.resize((size_t)np);
        for (int64_t i = 0; i < np; i++) order[(size_t)i] = (int32_t)i;
        auto cmp = [&](int32_t a, int32_t b) {
            float sa = scores[(size_t)a], sb = scores[(size_t)b];
            if (sa != sb) return sa > sb;
            return a < b;
        };
        const int64_t k = np < (int64_t)top_k ? np : (int64_t)top_k;
        if (np > (int64_t)top_k)
            std::partial_sort(order.begin(), order.begin() + (size_t)k,
                              order.end(), cmp);
        else
            std::sort(order.begin(), order.end(), cmp);
        for (int64_t i = 0; i < k; i++) {
            o_sc[i] = scores[(size_t)order[(size_t)i]];
            o_id[i] = (int32_t)pool[(size_t)order[(size_t)i]];
        }
        out_label[q] = label;
    }
    return 0;
}

// ---------------------------------------------------------------------
// Token-conjunctive candidate pool (conjunctive.conjunctive_pool twin):
// per pivot token, its anchor-union candidates filtered so every OTHER
// token has evidence; pools merged, ranked by (strong-evidence count
// desc, doc token count asc, exact BM25 desc, id asc), clipped.
// Evidence membership comes from per-token PACKED BITSETS (bit d =
// doc d carries the token's anchors / any gram; built and memoized per
// query WORD on the Python side — Zipf reuse makes the per-query
// filter O(n_tok^2 * n_cand) byte gathers instead of galloping probes
// over full posting lists). Byte-identical to the numpy path.

namespace conjp {

static inline bool bit(const uint8_t* bits, int64_t d) {
    return (bits[d >> 3] >> (d & 7)) & 1;
}

}  // namespace conjp

int64_t infidex_conj_pool(
    const int64_t* term_offsets, const int32_t* postings_docs,
    const uint8_t* postings_weights,
    const float* doc_lengths, int64_t n_docs, float avgdl,
    const int32_t* anchors_flat, const int64_t* anchor_offsets,
    const uint8_t* ev_bits,   // [n_tok * nbytes] evidence (anchors|grams)
    const uint8_t* an_bits,   // [n_tok * nbytes] anchors only
    const uint8_t* has_ev,    // [n_tok] token has any evidence
    int64_t nbytes,
    int32_t n_tok,
    const int64_t* score_tids, const float* score_idfs, int32_t n_score,
    const int32_t* tok_count, int64_t tok_count_len,
    int32_t anchor_clip, int32_t conj_cap,
    int64_t* out_pool) {
    using conjp::bit;

    std::vector<std::vector<int32_t>> pools;
    std::vector<int32_t> cand, next;
    for (int32_t pi = 0; pi < n_tok; pi++) {
        const int32_t* pa = anchors_flat + anchor_offsets[pi];
        int64_t pn = anchor_offsets[pi + 1] - anchor_offsets[pi];
        if (pn == 0) continue;
        if (pn > anchor_clip) pn = anchor_clip;
        cand.assign(pa, pa + pn);
        for (int32_t oi = 0; oi < n_tok; oi++) {
            if (oi == pi || !has_ev[oi]) continue;
            if (cand.empty()) break;
            const uint8_t* bits = ev_bits + (int64_t)oi * nbytes;
            next.clear();
            for (int32_t c : cand)
                if (bit(bits, c)) next.push_back(c);
            cand.swap(next);
        }
        if (!cand.empty()) pools.push_back(cand);
    }
    if (pools.empty()) return 0;
    std::vector<int32_t> pool;
    tier::merge_unique(pools, pool);
    const int64_t n_pool = (int64_t)pool.size();

    if (n_score == 0) {  // unranked (no Stage-1 prep): plain clip
        int64_t n = n_pool < conj_cap ? n_pool : conj_cap;
        for (int64_t i = 0; i < n; i++) out_pool[i] = pool[(size_t)i];
        return n;
    }

    // strong-evidence (anchor-class) token count per pool doc
    std::vector<int32_t> strong((size_t)n_pool, 0);
    for (int32_t t = 0; t < n_tok; t++) {
        const uint8_t* bits = an_bits + (int64_t)t * nbytes;
        for (int64_t i = 0; i < n_pool; i++)
            strong[(size_t)i] += bit(bits, pool[(size_t)i]);
    }
    std::vector<int32_t> tok_n((size_t)n_pool, 0);
    if (tok_count != nullptr && tok_count_len > 0) {
        for (int64_t i = 0; i < n_pool; i++) {
            int64_t d = pool[(size_t)i];
            if (d >= tok_count_len) d = tok_count_len - 1;
            tok_n[(size_t)i] = tok_count[d];
        }
    }
    // BM25 is only the THIRD ranking key: a (strong, tok_n) class that
    // starts at or past conj_cap can never surface, whatever its
    // scores. Order by class first (scoreless), keep the prefix of
    // whole classes covering conj_cap, and score ONLY those docs —
    // at 1M a 10-30k merged pool shrinks to ~conj_cap scored docs with
    // an unchanged result (class-internal order is all scores decide).
    //
    // The class order is one PACKED 64-bit key per doc — strong
    // (inverted, desc) | tok_n (asc) | pool index (asc == id asc, pool
    // is sorted-unique) — so prefix selection is a branch-predictable
    // nth_element + partition over plain integers, O(n_pool), instead
    // of a full comparator sort doing ~log(n) random gathers per doc
    // (the former conj_pool hot spot: ~3-4ms of a 5.5ms call at 1M).
    // Bit budget: strong <= n_tok < 2^15, tok_n clamped to 2^24-1 (doc
    // token count; clamping merges the classes of >16M-token docs,
    // which only widens the kept set — class clipping is result-
    // neutral, so a superset is too), index < 2^24. Pools are anchor-
    // clip-bounded per query token (n_pool <= n_tok * ANCHOR_CLIP), so
    // a swept ANCHOR_CLIP can push n_pool past 2^24 — in that case the
    // index field would corrupt class order; skip clipping entirely
    // (score the whole pool: slower, identical result).
    const int64_t IDX_MAX = (int64_t)1 << 24;
    std::vector<uint64_t> keys((size_t)n_pool);
    if (n_pool < IDX_MAX)
        for (int64_t i = 0; i < n_pool; i++) {
            uint64_t tn = (uint64_t)(uint32_t)tok_n[(size_t)i];
            if (tn >= (uint64_t)IDX_MAX) tn = (uint64_t)IDX_MAX - 1;
            keys[(size_t)i] =
                ((uint64_t)(n_tok - strong[(size_t)i]) << 48)
                | (tn << 24)
                | (uint64_t)i;
        }
    const uint64_t CLASS_MASK = ~(uint64_t)0 << 24;
    int64_t kept = n_pool;
    std::vector<int64_t> order;
    order.reserve((size_t)n_pool);
    if (n_pool > conj_cap && n_pool < IDX_MAX) {
        // The kept set is every whole class up to and including the
        // straddling one — the class of the (conj_cap-1)-th key in
        // ascending order (classes before it lie inside the prefix;
        // the boundary class extends to its end, exactly the old
        // "extend through the straddling class" loop).
        std::vector<uint64_t> sel(keys);
        std::nth_element(sel.begin(), sel.begin() + (conj_cap - 1),
                         sel.end());
        const uint64_t boundary = sel[(size_t)(conj_cap - 1)] & CLASS_MASK;
        for (int64_t i = 0; i < n_pool; i++)
            if ((keys[(size_t)i] & CLASS_MASK) <= boundary)
                order.push_back(i);
        kept = (int64_t)order.size();
    } else {
        for (int64_t i = 0; i < n_pool; i++) order.push_back(i);
    }
    // exact BM25 of the kept docs (score_pool wants ascending ids —
    // ``order`` is built index-ascending == id-ascending already)
    std::vector<int64_t> kept_docs((size_t)kept);
    for (int64_t i = 0; i < kept; i++)
        kept_docs[(size_t)i] = pool[(size_t)order[(size_t)i]];
    std::vector<float> kept_scores((size_t)kept);
    infidex_score_pool(term_offsets, postings_docs, postings_weights,
                       doc_lengths, n_docs, avgdl, score_tids, score_idfs,
                       n_score, kept_docs.data(), (int32_t)kept,
                       kept_scores.data());
    std::vector<float> scores((size_t)n_pool, 0.0f);
    for (int64_t i = 0; i < kept; i++)
        scores[(size_t)order[(size_t)i]] = kept_scores[(size_t)i];
    // final order within the kept prefix: (strong desc, tok_n asc,
    // score desc, id asc) — ids unique, so the comparator is a total
    // order == numpy's stable lexsort over the full pool.
    std::sort(order.begin(), order.begin() + kept, [&](int64_t x,
                                                       int64_t y) {
        if (strong[(size_t)x] != strong[(size_t)y])
            return strong[(size_t)x] > strong[(size_t)y];
        if (tok_n[(size_t)x] != tok_n[(size_t)y])
            return tok_n[(size_t)x] < tok_n[(size_t)y];
        if (scores[(size_t)x] != scores[(size_t)y])
            return scores[(size_t)x] > scores[(size_t)y];
        return pool[(size_t)x] < pool[(size_t)y];
    });
    int64_t n = n_pool < conj_cap ? n_pool : conj_cap;
    for (int64_t i = 0; i < n; i++)
        out_pool[i] = pool[(size_t)order[(size_t)i]];
    return n;
}

}  // extern "C"
