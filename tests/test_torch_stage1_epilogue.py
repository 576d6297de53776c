"""The Stage-1 epilogue of the port (infidex_tpu_torch/index/device.py:
``fuzzy_presence``, ``stage1_epilogue``, ``stable_top_k``, ``lim_rows``).

* The plain versions against the JAX package's functions
  (``_fuzzy_block``, ``stable_top_k``, ``_coverage_class``, ``_lim_rows``,
  run eagerly on the CPU): top-k ids and order, LIM rows, counts and the
  fuzzy cover exactly; fuzzy scores to ``MAX_ULP`` (XLA's CPU backend
  contracts the doc factor's multiply-adds, the port rounds each
  operation); each group's df against a numpy union of its posting docs.
* The four kernels' cell code (csrc/stage1_fuzzy_cell.cuh,
  stage1_epilogue_cell.cuh, stage1_topk_cell.cuh, stage1_lim_cell.cuh,
  over csrc/block_steps.cuh), compiled for the host with g++
  -ffp-contract=off behind the kernels' own C interfaces, driven through
  the port's wrappers (``_kernels.stage1_*`` with ``lib``), each block's
  shared memory filled with 0x7f bytes first: bit-equal to the plain
  versions on heavy ties, a boundary class straddling k, -0.0 and
  negative scores, k in {1, 37, 500, 2000, n_pad}, all-zero rows,
  duplicate docs across one group's terms, df-0 groups and groups above
  the stop limit, pad groups, deleted docs and a filter mask, a doc window
  (a shard), fewer than LIM_K class members, a LIM window below n_pad, and
  the fuzzy cover's union.
* ``DeviceIndex.search_batch`` (and 4 CPU shards) through the kernel
  route of the dispatchers, with the host build in place of the card's
  library, against the plain route; and the plain route against the
  reference, with fuzzy groups.
* On a card (``gpu``), each kernel against its plain version on the same
  inputs.

Inputs are made with numpy from a seed.
"""

import functools
import os

import numpy as np
import pytest
import torch

os.environ["INFIDEX_TPU_PALLAS_INTERPRET"] = "1"

import jax.numpy as jnp  # noqa: E402

from infidex_tpu.index import device as ref_dev  # noqa: E402
from infidex_tpu_torch import runtime  # noqa: E402
from infidex_tpu_torch.index import builder as port_builder  # noqa: E402
from infidex_tpu_torch.index import device as port_dev  # noqa: E402
from infidex_tpu_torch.ops import _kernels  # noqa: E402
from infidex_tpu_torch.ops import stage1_lanes as lanes  # noqa: E402
from infidex_tpu_torch.parallel import sharding  # noqa: E402
from infidex_tpu_torch.parallel.sharding import (  # noqa: E402
    ShardedDeviceIndex, make_mesh)
from tests.test_torch_coverage_lcs import compile_cell  # noqa: E402
from tests.test_torch_device import (  # noqa: E402
    MAX_ULP, _assert_same, _random_index, _ref_index, _ulps)

runtime.set_device("cpu")
# the suite runs in several worker processes on shared cores; one intra-op
# thread each keeps torch from oversubscribing them
torch.set_num_threads(1)

_HOST = r"""
#include <vector>
#include "stage1_fuzzy_cell.cuh"
#include "stage1_epilogue_cell.cuh"
#include "stage1_topk_cell.cuh"
#include "stage1_lim_cell.cuh"
// The four kernels' C interfaces on the host: every block in turn (rows
// last to first: the card runs blocks in no order, and a row that wrote
// past its end into the next one shows), each block's shared memory
// filled with 0x7f bytes first; the top-k and LIM kernels' clusters as
// their blocks' Shared in an array, each cluster step run by the blocks in
// turn.
template <class S>
static S* fresh(std::vector<unsigned char>& buf) {
  buf.assign(sizeof(S), 0x7f);
  return reinterpret_cast<S*>(buf.data());
}
// the fuzzy kernel's warps last to first, or first to last after
// fuzzy_warps_forward(1): which lane turns a bit on differs, the df not
static int g_forward = 0;
extern "C" void fuzzy_warps_forward(int f) { g_forward = f; }
extern "C" int stage1_fuzzy(const int* starts, const int* group,
    const int* cum, int n_terms, long long n_lanes, const int* docs,
    int doc_lo, int doc_hi, unsigned* bits, long long words, int n_grp,
    int* df, void*) {
  if (n_grp <= 0) return 0;
  const fuzzy::Args a{starts, group, cum, n_terms, n_lanes, docs, doc_lo,
                      doc_hi, bits, words, n_grp, df};
  const long long n_warps = (n_lanes + 31) / 32;
  for (long long k = 0; k < n_warps; ++k) {
    const long long w = g_forward ? k : n_warps - 1 - k;
    fuzzy::mark_warp(blk::Warp{}, a, 32 * w);
  }
  return 0;
}
extern "C" int stage1_epilogue(float* scores, float* cnt, long long width,
    int n_q, const float* live, const unsigned* bits, long long words,
    const float* fidf, const float* doc_fac, const int* q_off,
    const int* q_grp, int has_fz, int* rowmax, void*) {
  const epi::Args a{scores, cnt, width, n_q, live, bits, words, fidf,
                    doc_fac, q_off, q_grp, has_fz, rowmax};
  std::vector<unsigned char> buf;
  for (int q = 0; q < n_q; ++q) {
    for (long long b = 0; b * epi::kDocs < width; ++b) {
      epi::block(a, q, b, fresh<epi::Shared>(buf));
    }
  }
  return 0;
}
extern "C" int stage1_topk(const float* scores, long long width, int n_rows,
    int k, int shared_keys, int run_keys, int slices,
    unsigned long long* scratch, long long scratch_cols, float* out_scores,
    int* out_ids, void*) {
  if (!topk::args_ok(width, k, shared_keys, run_keys, slices, scratch,
                     scratch_cols)) {
    return 1;
  }
  const topk::Args a{scores, width, n_rows, k, shared_keys, run_keys,
                     slices, scratch, scratch_cols, out_scores, out_ids};
  std::vector<std::vector<unsigned char>> bufs(slices);
  std::vector<topk::Shared*> sh(slices);
  for (int r = n_rows - 1; r >= 0; --r) {
    for (int b = 0; b < slices; ++b) {
      bufs[b].assign(topk::shared_bytes(run_keys), 0x7f);
      sh[b] = reinterpret_cast<topk::Shared*>(bufs[b].data());
    }
    topk::row(a, r, topk::Cl(slices, sh.data()));
  }
  return 0;
}
extern "C" int stage1_lim(const float* cnt, long long width, int n_q,
    const float* live, const float* thresh, const unsigned* bits,
    long long words, const float* fidf, const int* q_off, const int* q_grp,
    int has_fz, long long window, int k2, int k_out, int id_offset, int pad,
    int* out, int slices, int list_keys, int* scratch, void*) {
  if (!lim::args_ok(slices, list_keys, k2, scratch)) return 1;
  const lim::Args a{cnt, width, n_q, live, thresh, bits, words, fidf, q_off,
                    q_grp, has_fz, window, k2, k_out, id_offset, pad, out,
                    slices, list_keys, scratch};
  std::vector<std::vector<unsigned char>> bufs(slices);
  std::vector<lim::Shared*> sh(slices);
  for (int q = n_q - 1; q >= 0; --q) {
    for (int b = 0; b < slices; ++b) sh[b] = fresh<lim::Shared>(bufs[b]);
    lim::row(a, q, lim::Cl(slices, sh.data()));
  }
  return 0;
}
"""

#: depths of the top-k cases; the last is the row width (n_pad)
WIDTH = 5000
DEPTHS = (1, 37, 500, 2000, WIDTH)


@pytest.fixture(scope="module")
def host(tmp_path_factory):
    """The four cells behind the kernels' C interfaces, bound by
    ``_kernels.bind``."""
    return _kernels.bind(compile_cell(tmp_path_factory, "stage1_epilogue",
                                      _HOST))


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    return torch.device("cuda")


def bits_of(t):
    return t.contiguous().view(torch.int32)


def unpack(bits, width):
    """A presence bitset (int32 [n_grp, words]) as bool [n_grp, width]."""
    b = np.ascontiguousarray(bits.cpu().numpy()).view(np.uint8)
    out = np.unpackbits(b, axis=1, bitorder="little").astype(bool)
    return out[:, :width], out[:, width:]


# ---- inputs ------------------------------------------------------------


def fuzzy_index(seed):
    """A random CSR (tests/test_torch_device.py's) and five queries of 1-3
    fuzzy groups each: groups of 2-4 terms (their docs overlap: duplicates
    across one group's terms), one group of empty terms (df 0), a group
    count that is not a power of two (pad groups)."""
    rng = np.random.default_rng(seed)
    built = _random_index(rng, n_docs=900, n_terms=50,
                          cls=port_builder.BuiltIndex)
    empty = np.flatnonzero(built.df == 0)
    qs = []
    for q in range(5):
        tids = [int(t) for t in rng.choice(50, 2, replace=False)
                if built.df[t] > 0] or [int(np.argmax(built.df))]
        idfs = np.asarray([ref_dev.compute_idf(built.num_docs,
                                               int(built.df[t]))
                           for t in tids], np.float32)
        groups = [np.sort(rng.choice(50, rng.integers(2, 5), replace=False))
                  for _ in range(1 + q % 3)]
        if q == 2 and empty.size:
            groups.append(empty[:2])
        qs.append((np.asarray(tids, np.int64), idfs,
                   [g.astype(np.int64) for g in groups]))
    return built, qs


class Group:
    """One Stage-1 group of ``fuzzy_index``'s queries on ``dev``: the
    scattered score and count matrices, the fuzzy tables, the index."""

    def __init__(self, seed, dev="cpu", deleted=0.05):
        built, self.queries = fuzzy_index(seed)
        rng = np.random.default_rng(100 + seed)
        dele = rng.random(built.num_docs) < deleted
        self.index = port_dev.DeviceIndex(built, dele, device=dev)
        di = self.index
        self.n_q = len(self.queries)
        prep = port_dev.prepare_batch_arrays(built, self.queries)
        fz_starts, fz_lens, fz_group, grp_query, _, self.n_grp = prep[6:]
        self.n_groups = sum(len(q[2]) for q in self.queries)
        self.fz = port_dev.fuzzy_groups(fz_starts, fz_lens, fz_group,
                                        grp_query, self.n_q, di.device)
        n = self.n_q * di.n_pad
        s = torch.zeros(n, dtype=torch.float32, device=di.device)
        c = torch.zeros_like(s)
        lanes.scatter_lanes_plain(s, c, di.stage1_chunks(self.queries)
                                  .ranked(), di.postings_docs, di.cfac)
        self.scores = s.view(self.n_q, di.n_pad)
        self.cnt = c.view(self.n_q, di.n_pad)
        # a filter mask on top of the deletions
        mask = np.zeros(di.n_pad, np.float32)
        mask[:built.num_docs] = rng.random(built.num_docs) < 0.6
        self.filtered = torch.from_numpy(mask).to(di.device) * di.live_mask

    def fidf(self, df, stop_limit=1e9):
        dev = self.index.device
        return port_dev.fuzzy_idf(
            df, torch.tensor(float(self.index.num_docs), device=dev),
            torch.tensor(float(stop_limit), device=dev))


def union_df(index, fz, n_grp, lo, hi):
    """Each group's distinct posting docs in [lo, hi), by numpy."""
    docs = index.postings_docs.cpu().numpy()
    out = np.zeros(n_grp, np.int64)
    sets = [set() for _ in range(n_grp)]
    for s, n, g in zip(fz.starts, fz.lens, fz.group):
        sets[g].update(int(d) for d in docs[s:s + n] if lo <= d < hi)
    for g, st in enumerate(sets):
        out[g] = len(st)
    return out


def lane_counts(index, fz, n_grp, lo, hi):
    """Each group's posting lanes whose doc lies in [lo, hi), by numpy."""
    docs = index.postings_docs.cpu().numpy()
    out = np.zeros(n_grp, np.int64)
    for s, n, g in zip(fz.starts, fz.lens, fz.group):
        out[g] += int(((docs[s:s + n] >= lo) & (docs[s:s + n] < hi)).sum())
    return out


def topk_rows(seed, width=WIDTH):
    """Rows that reach every branch of the select: heavy ties, -0.0 and
    negatives, all zeros, distinct values, fewer positives than k, a tie
    class straddling every depth, values that differ only in their low
    bits, +-0 interleaved, and denormals among zeros (+0.0's bin then holds
    more than +0.0)."""
    rng = np.random.default_rng(seed)
    rows = np.zeros((9, width), np.float32)
    rows[0] = np.round(rng.random(width) * 8) / 4
    rows[1] = np.round(rng.random(width) * 8) / 4 - 1.0
    rows[1, :100] = -0.0
    rows[3] = rng.random(width).astype(np.float32) * 10
    pos = rng.choice(width, 30, replace=False)
    rows[4, pos] = rng.random(30).astype(np.float32) + 0.5
    rows[5] = 1.0
    rows[5, rng.choice(width, 2100 * width // WIDTH, replace=False)] = 2.0
    rows[5, rng.choice(width, 20, replace=False)] = 3.0
    base = np.float32(1.5).view(np.int32)
    rows[6] = (base + rng.integers(0, 300, width)).astype(np.int32) \
        .view(np.float32)
    rows[7] = np.where(rng.random(width) < 0.5, -0.0, 0.0)
    rows[7, rng.choice(width, 40, replace=False)] = -2.0
    rows[8, rng.choice(width, 30, replace=False)] = 1.0
    n_den = min(600, width // 2)
    rows[8, rng.choice(width, n_den, replace=False)] = (
        rng.integers(1, 50, n_den).astype(np.int32).view(np.float32))
    return torch.from_numpy(rows)


# ---- the plain versions against the reference --------------------------


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_plain_top_k_equals_the_reference(seed):
    """Ids, order and scores against the reference, and every row against
    a numpy oracle. Rows 1 and 7 hold -0.0 and +0.0 together: the port
    orders them as equal floats (by id), as the oracle does; the
    reference's lax.top_k puts +0.0 first where both lie above the k-th
    score. Row 8 holds denormals, which XLA's CPU backend flushes to zero.
    Those three rows are held to the oracle only."""
    rows = topk_rows(seed)
    same = [0, 2, 3, 4, 5, 6]
    for k in DEPTHS:
        s, ids = port_dev.stable_top_k_plain(rows, k)
        rs, rids = ref_dev.stable_top_k(jnp.asarray(rows.numpy()[same]), k)
        assert np.array_equal(ids.numpy()[same], np.asarray(rids)), k
        # equal as floats: the reference fills the boundary class with the
        # k-th score, whose zero may carry either sign
        assert np.array_equal(s.numpy()[same], np.asarray(rs)), k
        for b, row in enumerate(rows.numpy()):
            want = np.lexsort((np.arange(row.size), -row))[:k]
            assert np.array_equal(ids[b].numpy(), want), (b, k)
            assert np.array_equal(bits_of(s[b]).numpy(),
                                  row[want].view(np.int32)), (b, k)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_plain_fuzzy_block_and_lim_equal_the_reference(seed):
    """presence + df + idf + ``stage1_epilogue_plain`` (live all ones)
    against ``_fuzzy_block``; ``lim_rows_plain`` against
    ``_coverage_class`` and ``_lim_rows``."""
    g = Group(seed)
    di, fz, n_q = g.index, g.fz, g.n_q
    presence, df = port_dev.fuzzy_presence(di.postings_docs, fz, g.n_grp, 0,
                                           di.n_pad)
    assert np.array_equal(df.numpy(), union_df(di, fz, g.n_grp, 0, di.n_pad))
    assert int(df.sum()) < int(fz.lens.sum())          # duplicates
    assert g.n_grp > g.n_groups                          # pad groups
    assert (df[:g.n_groups] == 0).any()                  # a df-0 group
    stop = float(df.max()) - 1                           # one above it
    fidf = g.fidf(df, stop)
    ones = torch.ones(di.n_pad)
    s, c, rowmax, fz_any = port_dev.stage1_epilogue_plain(
        g.scores.clone(), g.cnt.clone(), ones, presence, fidf, di.doc_fac,
        fz.grp_query)
    f_pad = port_dev._bucket(max(fz.n_lanes, 1), 1024)
    rs, rc, rany = ref_dev._fuzzy_block(
        jnp.asarray(g.scores.numpy()), jnp.asarray(g.cnt.numpy()),
        jnp.asarray(di.postings_docs.numpy()),
        jnp.asarray(di.doc_lengths.numpy()), jnp.asarray(fz.starts),
        jnp.asarray(fz.lens), jnp.asarray(fz.group),
        jnp.asarray(fz.grp_query), jnp.float32(di.num_docs),
        jnp.float32(stop), jnp.maximum(jnp.float32(di.built.avgdl), 1e-9),
        f_pad=f_pad, n_grp=g.n_grp, n_q=n_q)
    assert _ulps(np.asarray(rs), s.numpy()).max() <= MAX_ULP
    assert np.array_equal(np.asarray(rc), c.numpy())
    assert np.array_equal(np.asarray(rany), fz_any.numpy())
    live = di.live_mask
    for k in (37, 500):
        cls = ref_dev._coverage_class(jnp.asarray(c.numpy()),
                                      jnp.asarray(live.numpy()))
        m = cls | (rany & (jnp.asarray(live.numpy())[None, :] > 0))
        want = np.asarray(ref_dev._lim_rows(m, k)).astype(np.int64)
        _, _, rm, _ = port_dev.stage1_epilogue_plain(
            s, c, live, None, None, None, None)
        got = port_dev.lim_rows_plain(c, live, rm, fz_any, k,
                                      min(port_dev.LIM_K, k),
                                      port_dev.LIM_WINDOW, 0,
                                      max(1 << 24, di.n_pad))
        assert np.array_equal(got.numpy(), want)


def test_plain_lim_rows_equal_the_reference_inside_a_window(monkeypatch):
    rng = np.random.default_rng(3)
    m = rng.random((3, 4000)) > 0.97
    monkeypatch.setattr(ref_dev, "LIM_WINDOW", 1000)
    monkeypatch.setattr(port_dev, "LIM_WINDOW", 1000)
    want = np.asarray(ref_dev._lim_rows(jnp.asarray(m), 300))
    got = port_dev._lim_rows(torch.from_numpy(m), 300)
    assert np.array_equal(got.numpy(), want.astype(np.int32))
    assert (got.numpy() < (1 << 24)).sum(axis=1).max() < 256


# ---- the cells against the plain versions ------------------------------


#: the top-k kernel's shared-memory sort sizes the tests run: the
#: kernel's own (every row here sorts after one round), one that sends the
#: crowded rows through all three rounds, the boundary class and the
#: global scratch, and 1 (every path but the first round's shortcut)
SHARED_KEYS = (_kernels.TOPK_SHARED_KEYS, 512, 1)


def run_topk(rows, k, shared_keys, lib=None):
    return _kernels.stage1_topk(rows.contiguous(), k,
                                shared_keys=shared_keys, lib=lib)


@pytest.mark.parametrize("shared_keys", SHARED_KEYS)
@pytest.mark.parametrize("seed", [0, 1])
def test_topk_cell_equals_plain(host, seed, shared_keys):
    rows = topk_rows(seed)
    for k in DEPTHS:
        want_s, want_i = port_dev.stable_top_k_plain(rows, k)
        got_s, got_i = run_topk(rows, k, shared_keys, host)
        assert torch.equal(got_i, want_i), k
        assert torch.equal(bits_of(got_s), bits_of(want_s)), k


@pytest.mark.parametrize("shared_keys", SHARED_KEYS)
def test_topk_cell_on_a_real_group_and_widths(host, shared_keys):
    """A scattered score matrix of the random index, and row widths that
    are not multiples of a warp's segment, at every depth that fits."""
    g = Group(4)
    for rows in (g.scores * g.index.live_mask,
                 topk_rows(5, width=301), topk_rows(6, width=4097)):
        for k in [d for d in DEPTHS if d <= rows.shape[1]] + [rows.shape[1]]:
            want = port_dev.stable_top_k_plain(rows, k)
            got = run_topk(rows, k, shared_keys, host)
            assert torch.equal(got[1], want[1]), k
            assert torch.equal(bits_of(got[0]), bits_of(want[0])), k


def fuzzy_cases():
    return [(seed, window) for seed in (0, 1, 2)
            for window in (None, (200, 456), (31, 64))]


@pytest.mark.parametrize("seed,window", fuzzy_cases())
def test_fuzzy_cell_equals_plain(host, seed, window):
    """The one-pass kernel's warps in either order: the bitset, and the df
    counted by the lanes that turned a bit on (a doc in several of a
    group's terms once), against the plain version's row sums and a numpy
    union."""
    g = Group(seed)
    di, fz = g.index, g.fz
    lo, hi = window or (0, di.n_pad)
    want_p, want_df = port_dev.fuzzy_presence(di.postings_docs, fz, g.n_grp,
                                              lo, hi)
    # the case has docs shared by two terms of one group
    assert (union_df(di, fz, g.n_grp, lo, hi)
            < lane_counts(di, fz, g.n_grp, lo, hi)).any()
    for forward in (0, 1):
        host.fuzzy_warps_forward(forward)
        bits, df = _kernels.stage1_fuzzy(di.postings_docs, fz.d_starts,
                                         fz.d_group, fz.d_cum, fz.n_lanes,
                                         g.n_grp, lo, hi, lib=host)
        inside, past = unpack(bits, hi - lo)
        assert np.array_equal(inside, want_p.numpy() > 0)
        assert not past.any()
        assert torch.equal(df, want_df)
        assert np.array_equal(df.numpy(), union_df(di, fz, g.n_grp, lo, hi))
    host.fuzzy_warps_forward(0)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_fuzzy_cell_on_shard_windows(host, seed):
    """Four shards' windows of one group (the sharded route's calls): each
    window's df equals the plain version's, and the windows' df add up to
    the whole index's."""
    g = Group(seed)
    di, fz = g.index, g.fz
    edges = [0, 230, 450, 677, di.n_pad]
    total = torch.zeros(g.n_grp, dtype=torch.int32)
    for lo, hi in zip(edges, edges[1:]):
        want_p, want_df = port_dev.fuzzy_presence(di.postings_docs, fz,
                                                  g.n_grp, lo, hi)
        bits, df = _kernels.stage1_fuzzy(di.postings_docs, fz.d_starts,
                                         fz.d_group, fz.d_cum, fz.n_lanes,
                                         g.n_grp, lo, hi, lib=host)
        assert np.array_equal(unpack(bits, hi - lo)[0], want_p.numpy() > 0)
        assert torch.equal(df, want_df)
        total += df
    assert np.array_equal(total.numpy(),
                          union_df(di, fz, g.n_grp, 0, di.n_pad))


def epilogue_cases():
    return [(seed, fuzzy, live) for seed in (0, 1, 2)
            for fuzzy in (True, False) for live in ("live", "filtered")]


@pytest.mark.parametrize("seed,fuzzy,live", epilogue_cases())
def test_epilogue_and_lim_cells_equal_plain(host, seed, fuzzy, live):
    g = Group(seed)
    di, fz = g.index, g.fz
    lv = di.live_mask if live == "live" else g.filtered
    bits = presence = fidf = None
    if fuzzy:
        presence, df = port_dev.fuzzy_presence(di.postings_docs, fz,
                                               g.n_grp, 0, di.n_pad)
        bits, _ = _kernels.stage1_fuzzy(di.postings_docs, fz.d_starts,
                                        fz.d_group, fz.d_cum, fz.n_lanes,
                                        g.n_grp, 0, di.n_pad, lib=host)
        # one group above the stop limit (its idf 0: present, not scoring)
        fidf = g.fidf(df, float(df.max()) - 1)
        assert (fidf[:g.n_groups] == 0).sum() >= 2
    want_s, want_c, want_m, fz_any = port_dev.stage1_epilogue_plain(
        g.scores.clone(), g.cnt.clone(), lv, presence, fidf, di.doc_fac,
        fz.grp_query if fuzzy else None)
    got_s, got_c = g.scores.clone(), g.cnt.clone()
    got_m = _kernels.stage1_epilogue(
        got_s, got_c, lv, bits, fidf, di.doc_fac,
        fz.d_qoff if fuzzy else None, fz.d_qgrp if fuzzy else None,
        lib=host)
    for a, b in ((got_s, want_s), (got_c, want_c), (got_m, want_m)):
        assert torch.equal(bits_of(a), bits_of(b))
    assert (want_m > 0).all()
    if fuzzy:
        assert not torch.equal(want_s, g.scores * lv)     # groups added
    # LIM rows: the main path's, a window below n_pad, k below LIM_K, a
    # shard's (global ids, another threshold)
    n = di.n_pad
    for k_out, k2, window, offset, thresh in (
            (500, 256, n, 0, want_m), (500, 256, 301, 0, want_m),
            (37, 37, n, 0, want_m), (100, 100, n, 3000, want_m * 0 + 1.0),
            (300, 256, 700, 64, want_m + 1.0)):
        pad = max(1 << 24, n + offset)
        want = port_dev.lim_rows_plain(want_c, lv, thresh, fz_any, k_out, k2,
                                       window, offset, pad)
        got = _kernels.stage1_lim(
            got_c, lv, thresh, bits, fidf, fz.d_qoff if fuzzy else None,
            fz.d_qgrp if fuzzy else None, k_out, k2, window, offset, pad,
            lib=host)
        assert torch.equal(got, want), (k_out, k2, window, offset)
    # fewer than LIM_K members in some rows, and the fuzzy cover reached
    # where the count class alone would not
    members = (want < n).sum(dim=1)
    assert (members < 256).any()
    if fuzzy:
        no_fz = port_dev.lim_rows_plain(want_c, lv, want_m, None, 500, 256,
                                        n, 0, max(1 << 24, n))
        assert not torch.equal(no_fz, port_dev.lim_rows_plain(
            want_c, lv, want_m, fz_any, 500, 256, n, 0, max(1 << 24, n)))


def test_lim_cell_with_more_groups_than_it_stages(host):
    """A query with more scoring groups than the LIM kernel stages in
    shared memory (kGroups, 64) reads them from the group table."""
    rng = np.random.default_rng(11)
    n_q, width, n_grp = 3, 3000, 90
    words = -(-width // 32)
    cover = rng.random((n_grp, width)) < 0.002
    padded = np.zeros((n_grp, words * 32), bool)
    padded[:, :width] = cover
    bits = torch.from_numpy(np.packbits(padded, axis=1, bitorder="little")
                            .view(np.int32).copy())
    fidf = torch.from_numpy(np.where(rng.random(n_grp) < 0.1, 0.0,
                                     rng.random(n_grp) + 0.1)
                            .astype(np.float32))
    grp_query = np.r_[np.zeros(80, np.int32), np.ones(10, np.int32)]
    q_off = torch.tensor([0, 80, 90, 90], dtype=torch.int32)
    q_grp = torch.arange(n_grp, dtype=torch.int32)
    cnt = torch.from_numpy(rng.integers(0, 3, (n_q, width))
                           .astype(np.float32))
    live = torch.from_numpy((rng.random(width) < 0.9).astype(np.float32))
    thresh = torch.tensor([5.0, 2.0, 0.0])
    scoring = fidf.numpy() > 0
    assert scoring[:80].sum() > 64 and not scoring.all()
    fz_any = torch.from_numpy(np.stack([
        (cover & scoring[:, None])[grp_query == q].any(axis=0)
        for q in range(n_q)]))
    for k_out, k2, window in ((300, 256, width), (40, 40, 1000)):
        want = port_dev.lim_rows_plain(cnt, live, thresh, fz_any, k_out, k2,
                                       window, 0, 1 << 24)
        got = _kernels.stage1_lim(cnt, live, thresh, bits, fidf, q_off,
                                  q_grp, k_out, k2, window, 0, 1 << 24,
                                  lib=host)
        assert torch.equal(got, want)
        assert (want[0] < width).sum() > 0 and (want[2] < width).sum() == 0


# ---- the cluster cells: several blocks a row ----------------------------


#: blocks a row the cluster cells run with: one (a pool row's), and slices
#: down to the kernels' alignment, the last ones empty at these widths
SLICES = (1, 2, 4, 16)
#: (shared_keys, run_keys) of the top-k cluster cells: the kernel's own;
#: every run in shared memory; small runs, so that most go to the global
#: scratch and the select takes its later rounds; one key (every path but
#: the first round's shortcut, every run of two keys or more in scratch)
TOPK_SIZES = ((_kernels.TOPK_SHARED_KEYS, _kernels.TOPK_RUN_KEYS),
              (_kernels.TOPK_SHARED_KEYS, 16384), (512, 64), (1, 1))


def cluster_rows(seed, width=WIDTH):
    """``topk_rows`` and three more: all zeros, all one score, and a tie
    class of every seventh id (1.0) under 20 ids of 2.0, so that the
    boundary class's lowest ids at k 500 lie in several slices."""
    rng = np.random.default_rng(seed)
    extra = np.zeros((3, width), np.float32)
    extra[1] = 1.5
    extra[2, ::7] = 1.0
    extra[2, rng.choice(width, 20, replace=False)] = 2.0
    return torch.cat([topk_rows(seed, width), torch.from_numpy(extra)])


def assert_topk(rows, k, lib, **kw):
    want_s, want_i = port_dev.stable_top_k_plain(rows.cpu(), k)
    got_s, got_i = _kernels.stage1_topk(rows.contiguous(), k, lib=lib, **kw)
    assert torch.equal(got_i.cpu(), want_i), (k, kw)
    assert torch.equal(bits_of(got_s.cpu()), bits_of(want_s)), (k, kw)


@pytest.mark.parametrize("sizes", TOPK_SIZES)
@pytest.mark.parametrize("slices", SLICES)
def test_topk_cluster_cell_equals_plain(host, slices, sizes):
    """Every depth, on rows that reach every select path, a boundary class
    across slices, zero and one-score rows."""
    shared_keys, run_keys = sizes
    rows = cluster_rows(slices)
    kth = port_dev.stable_top_k_plain(rows[-1:], 500)[0][0, -1]
    assert float(kth) == 1.0      # the tie row's k-th is in its tie class
    for k in DEPTHS:
        assert_topk(rows, k, host, shared_keys=shared_keys,
                    run_keys=run_keys, slices=slices)


@pytest.mark.parametrize("n_rows", [1, 2, 128])
def test_topk_cluster_cell_row_counts(host, n_rows):
    """1, 2 and 128 rows of 3,000 ids (a mix of ``cluster_rows``' kinds)
    at 1, 4 and 16 slices."""
    rows = torch.cat([cluster_rows(100 + i, 3000) for i in range(11)])
    rows = rows[np.random.default_rng(n_rows).permutation(
        rows.shape[0])[:n_rows]]
    for slices in (1, 4, 16):
        for k in (1, 500, 3000):
            assert_topk(rows, k, host, slices=slices)
        assert_topk(rows, 2000, host, shared_keys=512, run_keys=64,
                    slices=slices)


def test_topk_cluster_cell_slices_agree(host):
    """Any slice count gives the same ids and scores, and so does each
    shared-memory size, on a scattered score matrix."""
    g = Group(4)
    rows = g.scores * g.index.live_mask
    want = _kernels.stage1_topk(rows, 300, slices=1, lib=host)
    for slices in SLICES[1:]:
        for shared_keys, run_keys in TOPK_SIZES:
            got = _kernels.stage1_topk(rows, 300, shared_keys=shared_keys,
                                       run_keys=run_keys, slices=slices,
                                       lib=host)
            assert torch.equal(got[1], want[1])
            assert torch.equal(bits_of(got[0]), bits_of(want[0]))


def test_row_slices_and_scratch_columns():
    def host(c):
        return _kernels.resident_clusters("stage1_topk", torch.device("cpu"),
                                          c)

    assert host(2) == 132
    assert [_kernels.row_slices(1, w, host) for w in
            (1, 16384, 32767, 32768, 65536, 1 << 18, 1 << 20)] == [
                1, 1, 1, 2, 4, 16, 16]
    assert [_kernels.row_slices(n, 1 << 20, host) for n in
            (1, 8, 16, 17, 32, 64, 128, 133)] == [16, 16, 16, 8, 8, 4, 2, 1]
    assert _kernels.topk_scratch_cols(500) == 2 * 16384
    assert _kernels.topk_scratch_cols(500, run_keys=16384) == 0
    assert _kernels.topk_scratch_cols(20000, run_keys=16384) == 40000
    with pytest.raises(ValueError):
        _kernels.stage1_topk(torch.zeros(2, 10), 3, slices=3)
    with pytest.raises(ValueError):
        _kernels.stage1_lim(torch.zeros(2, 10), torch.ones(10),
                            torch.ones(2), None, None, None, None, 5, 5, 10,
                            0, 1 << 24, slices=32)


def lim_case(seed, width=20000, k2=256):
    """LIM rows of a class cnt >= 2 (live all ones but a few): the k2-th
    member in the first slice (a dense class), in the last slice (members
    only in the last 3 % of the window), in a middle slice (members of
    every slice), in none (fewer than k2 members: pads), no member at all,
    and a zero threshold (no class)."""
    rng = np.random.default_rng(seed)
    cnt = np.zeros((6, width), np.float32)
    cnt[0] = rng.integers(1, 3, width)
    tail = width - width * 3 // 100
    cnt[1, tail:] = 2 + (rng.random(width - tail) < 0.5)
    cnt[2, ::31] = 2.0
    cnt[3, rng.choice(width, k2 // 3, replace=False)] = 3.0
    cnt[5] = 2.0
    live = np.ones(width, np.float32)
    live[rng.choice(width, width // 50, replace=False)] = 0.0
    thresh = np.array([2, 2, 2, 2, 2, 0], np.float32)
    return (torch.from_numpy(cnt), torch.from_numpy(live),
            torch.from_numpy(thresh))


@pytest.mark.parametrize("list_keys", [_kernels.LIM_LIST_KEYS, 8])
@pytest.mark.parametrize("slices", SLICES)
def test_lim_cluster_cell_equals_plain(host, slices, list_keys):
    cnt, live, thresh = lim_case(slices)
    n = cnt.shape[1]
    want = port_dev.lim_rows_plain(cnt, live, thresh, None, 300, 256, n, 0,
                                   1 << 24)
    members = (want < n).sum(dim=1).tolist()
    assert members[:3] == [256] * 3 and 0 < members[3] < 256
    assert members[4:] == [0, 0]
    assert want[1, 255] >= n - n * 3 // 100 and want[0, 255] < 1024
    for k_out, k2, window, offset in ((300, 256, n, 0), (256, 256, n, 7),
                                      (40, 40, 12345, 0), (300, 256, 900, 3)):
        want = port_dev.lim_rows_plain(cnt, live, thresh, None, k_out, k2,
                                       window, offset, 1 << 24)
        got = _kernels.stage1_lim(cnt, live, thresh, None, None, None, None,
                                  k_out, k2, window, offset, 1 << 24,
                                  slices=slices, list_keys=list_keys,
                                  lib=host)
        assert torch.equal(got, want), (k_out, k2, window, offset)


@pytest.mark.parametrize("slices", SLICES[1:])
@pytest.mark.parametrize("seed,fuzzy", [(0, True), (1, False), (2, True)])
def test_lim_cluster_cell_with_fuzzy_groups(host, seed, fuzzy, slices):
    """The fuzzy cover through a cluster: the random index's group, its
    presence bitset and the groups' idf, at k2 256 and 37."""
    g = Group(seed)
    di, fz = g.index, g.fz
    lv = g.filtered
    bits = presence = fidf = fz_any = None
    if fuzzy:
        presence, df = port_dev.fuzzy_presence(di.postings_docs, fz,
                                               g.n_grp, 0, di.n_pad)
        bits, _ = _kernels.stage1_fuzzy(di.postings_docs, fz.d_starts,
                                        fz.d_group, fz.d_cum, fz.n_lanes,
                                        g.n_grp, 0, di.n_pad, lib=host)
        fidf = g.fidf(df, float(df.max()) - 1)
    _, c, m, fz_any = port_dev.stage1_epilogue_plain(
        g.scores.clone(), g.cnt.clone(), lv, presence, fidf, di.doc_fac,
        fz.grp_query if fuzzy else None)
    for k_out, k2 in ((500, 256), (37, 37)):
        want = port_dev.lim_rows_plain(c, lv, m, fz_any, k_out, k2, di.n_pad,
                                       0, 1 << 24)
        got = _kernels.stage1_lim(c, lv, m, bits, fidf,
                                  fz.d_qoff if fuzzy else None,
                                  fz.d_qgrp if fuzzy else None, k_out, k2,
                                  di.n_pad, 0, 1 << 24, slices=slices,
                                  lib=host)
        assert torch.equal(got, want)


# ---- the whole Stage 1 through the kernel route -----------------------


@pytest.fixture
def kernel_route(host, monkeypatch):
    """The dispatchers take the kernel route on CPU tensors, with the host
    build in place of the card's library."""
    monkeypatch.setattr(port_dev, "_use_plain", lambda t: False)
    for name in ("stage1_fuzzy", "stage1_epilogue", "stage1_topk",
                 "stage1_lim"):
        monkeypatch.setattr(_kernels, name, functools.partial(
            getattr(_kernels, name), lib=host))


def _search(seed, k, sharded):
    built, qs = fuzzy_index(seed)
    dele = np.random.default_rng(seed).random(built.num_docs) < 0.05
    if sharded:
        return ShardedDeviceIndex(built, make_mesh(n_devices=4),
                                  dele).search_batch(qs, k)
    return port_dev.DeviceIndex(built, dele).search_batch(qs, k)


@pytest.mark.parametrize("lim_window", [None, 300])
@pytest.mark.parametrize("sharded", [False, True])
@pytest.mark.parametrize("k", [20, 300, 1100])
def test_search_batch_kernel_route_equals_plain(request, monkeypatch, sharded,
                                                k, lim_window):
    if lim_window is not None:     # below n_pad, and below a shard's end
        monkeypatch.setattr(port_dev, "LIM_WINDOW", lim_window)
        monkeypatch.setattr(sharding, "LIM_WINDOW", lim_window)
    plain = _search(7, k, sharded)
    request.getfixturevalue("kernel_route")
    got = _search(7, k, sharded)
    _assert_same(plain, got, exact_scores=True)
    if lim_window is not None:
        assert all((lim[lim < (1 << 24)] < lim_window).all()
                   for _, _, lim in got)


@pytest.mark.parametrize("sharded", [False, True])
def test_search_batch_kernel_route_with_clusters_equals_plain(
        request, monkeypatch, sharded):
    """Slices of 128 ids, so that the top-k and LIM cells run clusters of
    up to 16 blocks a row on these small indexes."""
    plain = _search(7, 300, sharded)
    request.getfixturevalue("kernel_route")
    monkeypatch.setattr(_kernels, "SLICE_IDS", 128)
    assert _kernels.row_slices(5, 1024, lambda c: 264 // c) == 8
    got = _search(7, 300, sharded)
    _assert_same(plain, got, exact_scores=True)


@pytest.mark.parametrize("seed,n_shards,k", [(0, 4, 10), (1, 8, 300),
                                             (2, 3, 25)])
def test_sharded_merges_through_the_kernel_route(kernel_route, seed, n_shards,
                                                 k):
    """The shards' score and LIM merges through the top-k cell: the score
    merge equals one top-k over packed (score, id) keys (the merge's
    definition) and the whole rows' top-k, on tie-heavy rows; the LIM
    merge the lowest ids."""
    rng = np.random.default_rng(seed)
    size, n_q = 400, 5
    scores = torch.from_numpy(rng.choice(
        np.float32([0.0, -0.0, 1.5, 2.0, 3.25]), (n_q, n_shards * size)))
    k_local = min(k, size)
    tops = [port_dev.stable_top_k(scores[:, s * size:(s + 1) * size],
                                  k_local) for s in range(n_shards)]
    all_s = torch.cat([t[0] for t in tops], 1)
    all_i = torch.cat([t[1].long() + s * size for s, t in enumerate(tops)],
                      1)
    got_s, got_i = sharding._stable_merge(all_s, all_i, k)
    pos = torch.topk(port_dev.order_keys(all_s, all_i), k, dim=1).indices
    assert torch.equal(got_i, torch.gather(all_i, 1, pos))
    assert torch.equal(bits_of(got_s), bits_of(torch.gather(all_s, 1, pos)))
    one_s, one_i = port_dev.stable_top_k_plain(scores, k)
    assert torch.equal(got_i.int(), one_i)
    pad = 1 << 24
    lows = torch.where(all_s > 1.0, all_i, pad)
    lows = torch.cat([torch.sort(lows[:, s * k_local:(s + 1) * k_local],
                                 dim=1).values for s in range(n_shards)], 1)
    k2 = min(256, k)
    assert torch.equal(sharding._lim_merge(lows, k2, pad), torch.topk(
        lows, k2, dim=1, largest=False, sorted=True).values)


@pytest.mark.parametrize("seed", [0, 1])
def test_search_batch_with_fuzzy_groups_matches_reference(seed):
    built, qs = fuzzy_index(seed)
    ref_built, _ = fuzzy_index(seed)
    ref = _ref_index(ref_built).search_batch(qs, 200)
    got = port_dev.DeviceIndex(built).search_batch(qs, 200)
    _assert_same(ref, got, exact_scores=False)


# ---- on a card ----------------------------------------------------------


@pytest.mark.gpu
@pytest.mark.parametrize("shared_keys", SHARED_KEYS)
@pytest.mark.parametrize("seed", [0, 1])
def test_topk_kernel_equals_plain(cuda, seed, shared_keys):
    rows = topk_rows(seed)
    for k in DEPTHS:
        want = port_dev.stable_top_k_plain(rows, k)
        got = run_topk(rows.to(cuda), k, shared_keys)
        assert torch.equal(got[1].cpu(), want[1]), k
        assert torch.equal(bits_of(got[0].cpu()), bits_of(want[0])), k
    # the dispatcher takes the kernel for CUDA tensors
    got = port_dev.stable_top_k(rows[3].to(cuda), 37)
    want = port_dev.stable_top_k_plain(rows[3], 37)
    assert torch.equal(got[1].cpu(), want[1])


@pytest.mark.gpu
@pytest.mark.parametrize("sizes", TOPK_SIZES)
@pytest.mark.parametrize("slices", SLICES)
def test_topk_cluster_kernel_equals_plain(cuda, slices, sizes):
    shared_keys, run_keys = sizes
    rows = cluster_rows(slices)
    for k in DEPTHS:
        assert_topk(rows.to(cuda), k, None, shared_keys=shared_keys,
                    run_keys=run_keys, slices=slices)
    for n_rows in (1, 2, 128):
        many = torch.cat([cluster_rows(100 + i, 3000) for i in range(11)])
        many = many[:n_rows].to(cuda)
        for k in (1, 500, 3000):
            assert_topk(many, k, None, shared_keys=shared_keys,
                        run_keys=run_keys, slices=slices)


@pytest.mark.gpu
@pytest.mark.parametrize("list_keys", [_kernels.LIM_LIST_KEYS, 8])
@pytest.mark.parametrize("slices", SLICES)
def test_lim_cluster_kernel_equals_plain(cuda, slices, list_keys):
    cnt, live, thresh = lim_case(slices)
    n = cnt.shape[1]
    for k_out, k2, window, offset in ((300, 256, n, 0), (256, 256, n, 7),
                                      (40, 40, 12345, 0), (300, 256, 900, 3)):
        want = port_dev.lim_rows_plain(cnt, live, thresh, None, k_out, k2,
                                       window, offset, 1 << 24)
        got = _kernels.stage1_lim(cnt.to(cuda), live.to(cuda),
                                  thresh.to(cuda), None, None, None, None,
                                  k_out, k2, window, offset, 1 << 24,
                                  slices=slices, list_keys=list_keys)
        assert torch.equal(got.cpu(), want), (k_out, k2, window, offset)


@pytest.mark.gpu
@pytest.mark.parametrize("seed,window", fuzzy_cases())
def test_fuzzy_kernel_equals_plain(cuda, seed, window):
    g, gc = Group(seed), Group(seed, dev=cuda)
    lo, hi = window or (0, g.index.n_pad)
    want_p, want_df = port_dev.fuzzy_presence(g.index.postings_docs, g.fz,
                                              g.n_grp, lo, hi)
    bits, df = port_dev.fuzzy_presence(gc.index.postings_docs, gc.fz,
                                       gc.n_grp, lo, hi)
    inside, past = unpack(bits, hi - lo)
    assert np.array_equal(inside, want_p.numpy() > 0) and not past.any()
    assert torch.equal(df.cpu(), want_df)


@pytest.mark.gpu
@pytest.mark.parametrize("seed,fuzzy,live", epilogue_cases())
def test_epilogue_and_lim_kernels_equal_plain(cuda, seed, fuzzy, live):
    g, gc = Group(seed), Group(seed, dev=cuda)
    out = {}
    for grp in (g, gc):
        di = grp.index
        lv = di.live_mask if live == "live" else grp.filtered
        fz = grp.fz if fuzzy else None
        presence = fidf = None
        if fuzzy:
            presence, df = port_dev.fuzzy_presence(di.postings_docs, fz,
                                                   grp.n_grp, 0, di.n_pad)
            fidf = grp.fidf(df, float(df.max()) - 1)
        s, c, m, fz_any = port_dev.stage1_epilogue(
            grp.scores.clone(), grp.cnt.clone(), lv, fz, presence, fidf,
            di.doc_fac)
        lims = [port_dev.lim_rows(c, lv, m, 500, k2=256, window=w, pad=pad,
                                  id_offset=off, fz_any=fz_any,
                                  presence=presence, fidf=fidf, fz=fz).cpu()
                for w, off, pad in ((di.n_pad, 0, 1 << 24),
                                    (301, 64, 1 << 25))]
        out[di.device.type] = (s.cpu(), c.cpu(), m.cpu(), lims)
    (s, c, m, lims), (cs, cc, cm, clims) = out["cpu"], out["cuda"]
    for a, b in ((s, cs), (c, cc), (m, cm)):
        assert torch.equal(bits_of(a), bits_of(b))
    for a, b in zip(lims, clims):
        assert torch.equal(a, b)


@pytest.mark.gpu
@pytest.mark.parametrize("sharded", [False, True])
def test_search_batch_cuda_equals_cpu(cuda, sharded):
    built, qs = fuzzy_index(3)
    out = {}
    for dev in ("cpu", "cuda"):
        if sharded:
            idx = ShardedDeviceIndex(built, make_mesh(devices=[dev] * 4))
        else:
            idx = port_dev.DeviceIndex(built, device=dev)
        out[dev] = idx.search_batch(qs, 300)
    _assert_same(out["cpu"], out["cuda"], exact_scores=True)
