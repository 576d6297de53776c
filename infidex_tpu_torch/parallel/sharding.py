"""Document-sharded serving over an ordered list of devices (PyTorch).

Port of ``infidex_tpu/parallel/sharding.py``. Documents (the score axis)
are split into equal contiguous shards, one per entry of the mesh;
postings and queries replicate. Each shard scatters the BM25+
contributions of the postings that land in its documents, takes a local
top-k, and the per-shard lists merge into the global top-k: the analogue
of Infidex's per-segment search + heap merge (VectorModel.cs:573-585).

The mesh is an ordered list of ``torch.device``s driven by ONE process,
as the reference's single-controller ``shard_map`` drives its mesh from
one process (and the engine is an embeddable library with no launcher).
A device may appear more than once: one card can serve several shards.
Replicated state (postings, per-posting factors, word tables) is held
once per distinct device, not once per shard. The reference's
collectives become copies onto the first shard's device, in shard order:

* the fuzzy virtual-term df ``psum`` is the sum of the shards' integer
  dfs (each the count of its window's presence), so every idf is the
  unsharded one;
* the ``pmax`` of the per-shard coverage-count row maxima is a max;
* the ``all_gather`` + merge of the per-shard top-k lists is a
  concatenation in shard order and one packed-key top-k.

Each shard runs the Stage-1 epilogue through ``index/device.py``'s
dispatchers (on CUDA the four epilogue kernels: presence over its doc
window, the pass, its local top-k, and its LIM rows against the global
row max with global ids).

Every per-doc score is the unsharded one bit for bit (the lane scatter
adds a cell's terms in the same rank order, the fuzzy arithmetic is per
doc), so a sharded index returns the unsharded ids, scores and LIM rows.

Stage 2/3 shards the same way (``ShardedCoverageTables``,
``sharded_coverage_batch``): the host buckets candidates by owning shard
and each shard scores its own with the port's coverage program over its
table slice, with no text table (the fake-LCS runs on the host, as on the
reference's mesh).

``ShardedDeviceIndex.search`` is the single-query route (the reference's
``sharded_stage1_topk``): each shard scatters the query's lanes in its
doc window, applies its live mask and takes its own top-k; the lists
merge as a batch's do. It returns ``DeviceIndex.search``'s ids and scores
bit for bit. Not ported: the reference's 2^24-document cap, which exists
for its f32 id readback.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from .. import runtime
from ..index.device import (_LIM_PAD, DeviceIndex, LIM_K, LIM_WINDOW,
                            fuzzy_doc_factor, fuzzy_groups, fuzzy_idf,
                            fuzzy_presence, lim_rows, prepare_batch_arrays,
                            read_top_k, single_query_chunks,
                            split_batch_by_lanes, stable_top_k,
                            stage1_epilogue)
from ..ops import stage1_lanes as lanes
from ..ops.coverage_kernel import _upload, coverage_fusion_batch

_F32 = torch.float32


def _device(dev) -> torch.device:
    d = torch.device(dev)
    if d.type not in ("cpu", "cuda"):
        raise ValueError(f"make_mesh: unsupported device {d}")
    if d.type == "cuda" and d.index is None:
        d = torch.device("cuda", torch.cuda.current_device())
    return d


def make_mesh(n_devices: Optional[int] = None, devices=None) -> list:
    """The ordered list of shard devices.

    ``devices`` is taken as given and may repeat a device (one card
    serving several shards). Otherwise: with ``runtime.device()`` on CUDA,
    the visible cards (the first ``n_devices`` of them); on the CPU,
    ``n_devices`` CPU shards (one by default). A card that is missing
    raises: no shard moves to the CPU."""
    if devices is not None:
        mesh = [_device(d) for d in devices]
    elif runtime.device().type == "cuda":
        n_vis = torch.cuda.device_count()
        n = n_vis if n_devices is None else int(n_devices)
        if n > n_vis:
            raise ValueError(f"make_mesh: {n} devices asked, {n_vis} CUDA "
                             f"devices visible")
        mesh = [torch.device("cuda", i) for i in range(n)]
    else:
        mesh = [torch.device("cpu")] * (1 if n_devices is None
                                        else int(n_devices))
    if not mesh:
        raise ValueError("make_mesh: no devices")
    return mesh


def _distinct(mesh) -> list:
    return list(dict.fromkeys(mesh))


def _stable_merge(all_s, all_i, k: int):
    """Global top-k of gathered per-shard (score, global id) rows by
    (score desc, id asc), the boundary tie class at the k-th score filled
    with its lowest ids, as the reference's merge fills it and as
    ``stable_top_k`` does on one device (membership nests across depths).
    Each shard's local selection is stable, so the global boundary class's
    lowest ids are always among the gathered rows.

    The rows hold the shards' lists in shard order, and the shards hold
    rising id windows in that order, each list in (score desc, id asc)
    order: so among equal scores a row's positions rise with the ids, and
    ``stable_top_k`` over the scores (score desc, position asc; the kernel
    on a card) picks the merge's entries in the merge's order. The ids are
    gathered after."""
    one_d = all_s.dim() == 1
    if one_d:
        all_s, all_i = all_s[None, :], all_i[None, :]
    out_s, pos = stable_top_k(all_s.contiguous(), k)
    out_i = torch.gather(all_i, 1, pos.long())
    if one_d:
        return out_s[0], out_i[0]
    return out_s, out_i


def _lim_merge(lows, k2: int, pad: int):
    """The ``k2`` lowest ids of gathered per-shard LIM rows, ascending
    (``pad`` after them). Each shard's row holds its ids ascending, then
    pads, and the shards' windows rise in shard order: so a row's ids are
    ascending in position once the pads are skipped, and the first ``k2``
    non-pad positions (``stable_top_k`` of a 1/0 flag: flags desc, position
    asc) are the lowest ids; pads fill the rest."""
    _, pos = stable_top_k((lows < pad).to(torch.float32), k2)
    return torch.gather(lows, 1, pos.long())


class _Replica(NamedTuple):
    """Replicated Stage-1 state on one device."""

    postings_docs: torch.Tensor   # int32 [P + CHUNK]
    cfac: torch.Tensor            # f32 [P + CHUNK]
    doc_lengths: torch.Tensor     # f32 [n_pad] (shards view their slice)
    avgdl: torch.Tensor           # f32 scalar
    doc_fac: torch.Tensor         # f32 [n_pad] fuzzy per-doc factor


class ShardedDeviceIndex:
    """Document-sharded Stage-1 index image over a mesh (``make_mesh``)."""

    def __init__(self, built, mesh, deleted: Optional[np.ndarray] = None):
        self.built = built
        self.mesh = list(mesh)
        n = built.num_docs
        self.num_docs = n
        n_dev = len(self.mesh)
        # doc axis padded to a multiple of 8 * n_devices (+ parking slot)
        unit = 8 * n_dev
        self.n_pad = max(((n + 1 + unit - 1) // unit) * unit, unit)
        self.shard_size = self.n_pad // n_dev

        built.ensure_champions()
        ext_d = (built.ext_docs if built.ext_docs.size
                 else np.zeros(1, np.int32))
        ext_w = (built.ext_weights if built.ext_weights.size
                 else np.zeros(1, np.uint8))
        pd = np.zeros(ext_d.size + lanes.CHUNK, np.int32)
        pd[:ext_d.size] = ext_d
        pw = np.zeros(pd.size, np.uint8)
        pw[:ext_w.size] = ext_w
        dl = np.zeros(self.n_pad, np.float32)
        dl[:n] = built.doc_lengths
        avgdl = float(np.float32(built.avgdl))
        self._replicas = {}
        for dev in _distinct(self.mesh):
            docs = _upload(pd, dev)
            dl_t = _upload(dl, dev)
            avg = torch.tensor(avgdl, dtype=_F32, device=dev)
            self._replicas[dev] = _Replica(
                docs, lanes.posting_cfac(docs, _upload(pw, dev), dl_t, avg),
                dl_t, avg, fuzzy_doc_factor(dl_t, avg))
        self.doc_lengths = [
            self._replicas[dev].doc_lengths[lo:lo + self.shard_size]
            for lo, dev in self._shards()]
        self.set_deleted(deleted)

    def _shards(self):
        """(first doc, device) of each shard, in shard order."""
        return [(s * self.shard_size, dev) for s, dev in enumerate(self.mesh)]

    def set_deleted(self, deleted: Optional[np.ndarray]) -> None:
        live = DeviceIndex._live(self.num_docs, self.n_pad, deleted)
        full = {dev: _upload(live, dev) for dev in _distinct(self.mesh)}
        self.live_mask = [full[dev][lo:lo + self.shard_size]
                          for lo, dev in self._shards()]

    def search(self, term_ids, term_idf, top_k: int):
        """Mesh twin of ``DeviceIndex.search`` without extra postings (as
        the reference's): the lane kernel over each shard's doc window,
        its live mask (the epilogue pass) and its own top-k of
        min(top_k, shard_size), ids made global; the lists merged on the
        first shard's device. Returns (scores f32[k], ids int32[k])
        numpy arrays, k = min(top_k, n_pad)."""
        size, dev0 = self.shard_size, self.mesh[0]
        chunks = {dev: single_query_chunks(self.built, term_ids, term_idf,
                                           size, dev)
                  for dev in self._replicas}
        k = min(int(top_k), self.n_pad)
        tops_s, tops_i = [], []
        for s, (lo, dev) in enumerate(self._shards()):
            rep = self._replicas[dev]
            scores = torch.zeros((1, size), dtype=_F32, device=dev)
            cnt = torch.zeros_like(scores)
            lanes.scatter_lanes(scores.view(-1), cnt.view(-1), chunks[dev],
                                rep.postings_docs, rep.cfac, lo, lo + size)
            scores = stage1_epilogue(scores, cnt, self.live_mask[s], None,
                                     None, None, None)[0]
            top_s, top_i = stable_top_k(scores, min(k, size))
            tops_s.append(top_s.to(dev0))
            tops_i.append((top_i.long() + lo).to(dev0))
        return read_top_k(*_stable_merge(torch.cat(tops_s, dim=1),
                                         torch.cat(tops_i, dim=1), k))

    def search_batch(self, queries, top_k: int,
                     total_docs: Optional[int] = None,
                     stop_term_limit: int = 1_250_000,
                     live_override=None) -> list:
        """Mesh twin of ``DeviceIndex.search_batch``: same host prep, same
        output ([(scores f32[k], ids int32[k], lim int32[k])] per query),
        scoring sharded over the document axis.

        ``live_override`` (single-device pre-filtering) is accepted for
        interface parity and ignored: the engine disables pre-filtering
        under sharded serving and filtered queries post-filter."""
        n_q = len(queries)
        if n_q == 0:
            return []
        # flat scatter keys are query * shard_size + local doc in int32
        max_q = max(1, ((1 << 31) - 1) // self.shard_size)
        if n_q > max_q:
            out: list = []
            for lo in range(0, n_q, max_q):
                out.extend(self.search_batch(
                    queries[lo:lo + max_q], top_k, total_docs=total_docs,
                    stop_term_limit=stop_term_limit))
            return out
        groups = split_batch_by_lanes(self.built, queries)
        if len(groups) > 1:
            out = []
            for lo, hi in groups:
                out.extend(self.search_batch(
                    queries[lo:hi], top_k, total_docs=total_docs,
                    stop_term_limit=stop_term_limit))
            return out
        return self._search_group(queries, top_k, total_docs,
                                  stop_term_limit)

    def _search_group(self, queries, top_k, total_docs,
                      stop_term_limit) -> list:
        """Stage 1 of one lane-capped group on every shard, then the
        merge on the first shard's device."""
        n_q = len(queries)
        size = self.shard_size
        dev0 = self.mesh[0]
        prep = prepare_batch_arrays(self.built, queries)
        _, starts, lens, idfs, tq = prep[:5]
        fz_starts, fz_lens, fz_group, grp_query, _, n_grp = prep[6:]
        n_t = sum(len(q[0]) for q in queries)   # pad terms have no lanes
        chunks = {dev: lanes.build_query_chunks(
            starts[:n_t], lens[:n_t], idfs[:n_t], tq[:n_t], n_q, size, dev)
            for dev in self._replicas}

        fz = ({dev: fuzzy_groups(fz_starts, fz_lens, fz_group, grp_query,
                                 n_q, dev) for dev in self._replicas}
              if n_grp else None)

        # 1-2. the lane kernel over each shard's doc window (one launch
        # per shard) and the fuzzy groups' presence over its docs
        shards = []
        for lo, dev in self._shards():
            rep = self._replicas[dev]
            scores = torch.zeros(n_q * size, dtype=_F32, device=dev)
            cnt = torch.zeros(n_q * size, dtype=_F32, device=dev)
            lanes.scatter_lanes(scores, cnt, chunks[dev], rep.postings_docs,
                                rep.cfac, lo, lo + size)
            presence, df = (fuzzy_presence(rep.postings_docs, fz[dev], n_grp,
                                           lo, lo + size)
                            if n_grp else (None, None))
            shards.append((scores.view(n_q, size), cnt.view(n_q, size),
                           presence, df))

        # 3. global df: the shards' integer dfs, summed in shard order on
        # the first device
        df = None
        if n_grp:
            for *_, part in shards:
                part = part.to(dev0)
                df = part if df is None else df + part
        td = float(np.float32(total_docs if total_docs is not None
                              else self.num_docs))
        sl = float(np.float32(stop_term_limit))

        # 4. fuzzy scores, live mask and the local stable top-k per shard;
        # the lists merge on the first device
        k = min(int(top_k), self.n_pad)
        k_local = min(k, size)
        tops_s, tops_i, row_max, lim_in = [], [], [], []
        for s, (lo, dev) in enumerate(self._shards()):
            scores, cnt, presence, _ = shards[s]
            shards[s] = None        # each shard's matrices go when done
            fidf = (fuzzy_idf(df.to(dev),
                              torch.tensor(td, dtype=_F32, device=dev),
                              torch.tensor(sl, dtype=_F32, device=dev))
                    if n_grp else None)
            scores, cnt, rowmax, fz_any = stage1_epilogue(
                scores, cnt, self.live_mask[s], fz[dev] if n_grp else None,
                presence, fidf, self._replicas[dev].doc_fac[lo:lo + size])
            top_s, top_i = stable_top_k(scores, k_local)
            tops_s.append(top_s.to(dev0))
            tops_i.append((top_i.long() + lo).to(dev0))
            row_max.append(rowmax.to(dev0))
            lim_in.append((cnt, fz_any, presence, fidf))
        g_s, g_i = _stable_merge(torch.cat(tops_s, dim=1),
                                 torch.cat(tops_i, dim=1), k)

        # 5. LIM rows: the class of each query's top distinct-term count
        # over the whole index (the max of the shards' row maxima), each
        # shard's lowest global ids in it, then the lowest of those
        gmax = row_max[0]
        for m in row_max[1:]:
            gmax = torch.maximum(gmax, m)
        pad = max(_LIM_PAD, self.n_pad)
        k2_local = min(LIM_K, k_local)
        lows = []
        for s, (lo, dev) in enumerate(self._shards()):
            cnt, fz_any, presence, fidf = lim_in[s]
            lows.append(lim_rows(
                cnt, self.live_mask[s], gmax.to(dev), k2_local, k2=k2_local,
                window=min(max(LIM_WINDOW - lo, 0), size), pad=pad,
                id_offset=lo, fz_any=fz_any, presence=presence, fidf=fidf,
                fz=fz[dev] if n_grp else None).long().to(dev0))
        k2 = min(LIM_K, k)
        lim = torch.full((n_q, k), pad, dtype=torch.int64, device=dev0)
        lim[:, :k2] = _lim_merge(torch.cat(lows, dim=1), k2, pad)

        scores = g_s.cpu().numpy()
        ids = g_i.to(torch.int32).cpu().numpy()
        lim = lim.to(torch.int32).cpu().numpy()
        return [(scores[b], ids[b], lim[b]) for b in range(n_q)]


# ======================================================================
# Sharded Stage 2/3: coverage + fusion over document-sharded token tables.
#
# Candidates go to the shard that owns their document's table rows (the
# host buckets them), every shard scores its own with the port's coverage
# program over its table slice, and the host puts the rows back into the
# input order. Queries are replicated (tiny).

_WORD_TABLES = ("word_chars", "word_chars_rev", "word_lens")
_DOC_TABLES = ("doc_tokens", "doc_tok_offsets", "doc_tok_count",
               "doc_adj_ws", "doc_text_len")


class _CoverageShard(NamedTuple):
    """One shard's coverage tables, in ``coverage_fusion_batch``'s order."""

    word_chars: torch.Tensor
    word_chars_rev: torch.Tensor
    word_lens: torch.Tensor
    doc_tokens: torch.Tensor
    doc_tok_offsets: torch.Tensor
    doc_tok_count: torch.Tensor
    doc_adj_ws: torch.Tensor
    doc_text_len: torch.Tensor


def _pad_rows(t: torch.Tensor, rows: int) -> torch.Tensor:
    if t.shape[0] == rows:
        return t
    out = torch.zeros((rows,) + tuple(t.shape[1:]), dtype=t.dtype,
                      device=t.device)
    out[:t.shape[0]] = t
    return out


class ShardedCoverageTables:
    """Document-sharded image of ``ops.coverage_kernel.CoverageTables``:
    each shard's rows of the doc tables on its device (views where the
    device is the tables' own), the word tables once per distinct
    device."""

    def __init__(self, tables, mesh):
        self.mesh = list(mesh)
        n_dev = len(self.mesh)
        n = int(tables.doc_tokens.shape[0])
        self.n_pad = ((n + n_dev - 1) // n_dev) * n_dev
        self.shard_size = self.n_pad // n_dev
        home = tables.doc_tokens.device
        words = {dev: [getattr(tables, f).to(dev) for f in _WORD_TABLES]
                 for dev in _distinct(self.mesh)}
        docs = [_pad_rows(getattr(tables, f), self.n_pad)
                for f in _DOC_TABLES]
        self.shards = []
        for s, dev in enumerate(self.mesh):
            rows = slice(s * self.shard_size, (s + 1) * self.shard_size)
            part = [d[rows] if dev == home else d[rows].to(dev)
                    for d in docs]
            self.shards.append(_CoverageShard(*words[dev], *part))


def sharded_coverage_batch(sharded_tables: ShardedCoverageTables,
                           text_ids, qsel, q_args: tuple, lcs_vals,
                           base_scores, query_len,
                           config) -> torch.Tensor:
    """Score candidates of B queries across the mesh; returns the packed
    f32 [3, C] (score, tiebreaker, word_hits) in the input candidate
    order, on the first shard's device. Each shard runs
    ``coverage_fusion_batch`` over the candidates whose documents it
    owns (local ids), with no text table."""
    st = sharded_tables
    dev0 = st.mesh[0]
    text_ids = np.asarray(text_ids, np.int64)
    qsel = np.asarray(qsel, np.int32)
    lcs_vals = np.asarray(lcs_vals, np.float32)
    base_scores = np.asarray(base_scores, np.float32)
    n = text_ids.size
    shard_of = text_ids // st.shard_size
    order = np.argsort(shard_of, kind="stable")
    counts = np.bincount(shard_of, minlength=len(st.mesh))
    outs = []
    lo = 0
    for s, tables in enumerate(st.shards):
        sel = order[lo:lo + counts[s]]
        lo += counts[s]
        if sel.size == 0:
            continue
        out = coverage_fusion_batch(
            *tables, (text_ids[sel] - s * st.shard_size).astype(np.int32),
            qsel[sel], *q_args, lcs_vals[sel], base_scores[sel], query_len,
            config=config)
        outs.append(out.to(dev0))
    if not outs:
        return torch.zeros((3, 0), dtype=_F32, device=dev0)
    inverse = np.empty(n, np.int64)
    inverse[order] = np.arange(n)
    return torch.cat(outs, dim=1)[:, torch.from_numpy(inverse).to(dev0)]
