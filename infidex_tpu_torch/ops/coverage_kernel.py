"""Batched Stage-2/3 coverage + fusion scoring (PyTorch around four
hand-written kernels).

Port of ``infidex_tpu/ops/coverage_kernel.py``: all candidates of a query
batch are scored in one program over char tensors that replaces the
per-candidate matcher cascade (Coverage/*.cs + Scoring/FusionScorer.cs):

  1. whole-word -> joined -> prefix/suffix -> fuzzy cascade with
     single-consumption token deactivation,
  2. CoverageScorer.CalculateFinalScore,
  3. FusionSignalComputer.ComputeSignals,
  4. FusionScorer.Calculate -> (score, tiebreaker),

plus the device fake-LCS (StringMetrics.cs:12-36). Data layout, static
capacities and the packed output are the reference's; each
``lax.fori_loop`` is a Python loop over its small static bound, and every
float reduction over the query-token axis is an explicit sequential sum,
so the result does not depend on a library's reduction order.

After the gather, a block is four launches on the card:
``coverage_pair_block`` (the word relations and edit distances of every
(query token, doc token) pair, one packed int32 each, and in the same
launch the relations alone for the fusion query tokens),
``coverage_cascade`` (step 1's four
matchers over those words), ``coverage_lcs`` (the fake-LCS) and
``coverage_fusion`` (steps 2-4 and the pack). For CPU tensors each takes
its plain PyTorch version (``coverage_pairs_plain``, twice for the pair
block, ``coverage_cascade_plain``, ``coverage_lcs_plain``,
``coverage_fusion_plain``), with the same results bit for bit.

Eager PyTorch materialises what XLA fused: the largest intermediates of
the plain versions are [Q, L, D, C] masks and the [W, Q, 3D, C] DP band of
the prefix sweep. The candidate axis is therefore processed in blocks of
``ROW_BLOCK`` rows (candidates are scored independently), which bounds
peak device memory whatever chunk size the pipeline dispatches.

Candidates whose shapes exceed the static capacities (tokens > D, token
chars > L, query tokens > Q) are flagged at table build and re-scored by
the host oracle.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch

from .. import runtime
from . import _kernels
from .editdistance_multi import coverage_distances_plain, unpack_distances
from .editdistance_multi import first_true as _first

# Static capacities
D_MAX = 64    # doc tokens per candidate
L_MAX = 24    # chars per token
Q_MAX = 16    # coverage query tokens
FQ_MAX = 16   # fusion (unfiltered) query tokens
D_CAP_NARROW = 16  # narrow doc-token program width (see CoverageConfig.d_cap)
D_CAP_SMALL = 8    # small-bucket doc-token width (short docs, short words)
L_CAP_SMALL = 12   # small-bucket char width (all words <= 12 chars)

# Device fake-LCS shape caps: the text axis is the smallest bucket holding
# the corpus' longest (eligible) text; longer docs keep the host LCS.
T_LCS_BUCKETS = (64, 128, 192, 256)
QT_LCS = 64        # full-query char cap for the device fake-LCS

INTENT_BONUS_PER_SIGNAL = 0.15
ANCHOR_STEM_LENGTH = 3
MAX_TRAILING_LEN = 2

#: candidate rows scored per block (bounds eager intermediates; at the
#: widest shapes a block's largest tensors are ~1 GB)
ROW_BLOCK = 8192

_I32 = torch.int32
_F32 = torch.float32


class CoverageConfig(NamedTuple):
    """Static CoverageSetup knobs of one program."""

    min_word_size: int = 2
    levenshtein_max_word_size: int = 20
    num_typos: int = 2
    min_length_one_typo: int = 3
    min_length_two_typos: int = 7
    cover_whole_query: bool = True
    cover_whole_words: bool = True
    cover_fuzzy_words: bool = True
    cover_joined_words: bool = True
    cover_prefix_suffix: bool = True
    # Doc-token axis cap: 0 = full table width. The caller routes
    # candidates whose tok_count <= d_cap to a narrower program.
    d_cap: int = 0

    @staticmethod
    def from_setup(s) -> "CoverageConfig":
        return CoverageConfig(
            min_word_size=s.min_word_size,
            levenshtein_max_word_size=s.levenshtein_max_word_size,
            num_typos=s.num_typos,
            min_length_one_typo=s.min_length_one_typo,
            min_length_two_typos=s.min_length_two_typos,
            cover_whole_query=s.cover_whole_query,
            cover_whole_words=s.cover_whole_words,
            cover_fuzzy_words=s.cover_fuzzy_words,
            cover_joined_words=s.cover_joined_words,
            cover_prefix_suffix=s.cover_prefix_suffix,
        )


def _pad_bucket(n: int, minimum: int = 1024) -> int:
    b = minimum
    while b < n:
        b *= 4
    return b


def _upload(arr, dev) -> torch.Tensor:
    """numpy -> tensor on ``dev`` (read-only arrays are copied first:
    torch tensors are always writable)."""
    arr = np.ascontiguousarray(arr)
    if not arr.flags.writeable:
        arr = arr.copy()
    return torch.from_numpy(arr).to(dev)


def _tables_from_arrays(word_chars, word_chars_rev, word_lens, doc_tokens,
                        doc_offsets, doc_count, doc_adj, doc_text_len,
                        overflow, max_wlen, dev) -> "CoverageTables":
    """Bucket-pad the word and doc axes (the reference's table shapes)
    and upload. Pad rows are invalid (-1 token codes) and are never
    selected as candidates."""
    n = doc_tokens.shape[0]
    v = word_chars.shape[0]
    n_pad = _pad_bucket(n)
    v_pad = _pad_bucket(v)

    def padded(arr, rows, fill=0):
        if arr.shape[0] == rows:
            return arr
        out = np.empty((rows,) + arr.shape[1:], dtype=arr.dtype)
        out[: arr.shape[0]] = arr
        out[arr.shape[0]:] = fill
        return out

    return CoverageTables(
        word_chars=_upload(padded(word_chars, v_pad), dev),
        word_chars_rev=_upload(padded(word_chars_rev, v_pad), dev),
        word_lens=_upload(padded(word_lens, v_pad), dev),
        doc_tokens=_upload(padded(doc_tokens, n_pad, fill=-1), dev),
        doc_tok_offsets=_upload(padded(doc_offsets, n_pad), dev),
        doc_tok_count=_upload(padded(doc_count, n_pad), dev),
        doc_adj_ws=_upload(padded(doc_adj, n_pad), dev),
        doc_text_len=_upload(padded(doc_text_len, n_pad), dev),
        overflow=padded(overflow, n_pad),
        tok_count_host=padded(doc_count, n_pad),
        max_wlen_host=padded(max_wlen, n_pad),
        n_docs=n,
        n_words=v,
    )


@dataclass
class CoverageTables:
    """Device-resident doc token tables (+ host mirrors for routing)."""

    word_chars: torch.Tensor       # int32 [W, L]
    word_chars_rev: torch.Tensor   # int32 [W, L]
    word_lens: torch.Tensor        # int32 [W]
    doc_tokens: torch.Tensor       # int32 [N, D] (-1 padded)
    doc_tok_offsets: torch.Tensor  # int32 [N, D]
    doc_tok_count: torch.Tensor    # int32 [N]
    doc_adj_ws: torch.Tensor       # bool [N, D]
    doc_text_len: torch.Tensor     # int32 [N]
    overflow: np.ndarray  # bool [N]: doc exceeds D_MAX/L_MAX -> host path
    tok_count_host: np.ndarray = None  # int32 [N] host copy for D routing
    max_wlen_host: np.ndarray = None   # int32 [N] longest word, for L routing
    # full normalized-lowercase text chars (utf-16 code units) for the
    # fake-LCS; lcs_ok=False keeps a doc on the host LCS path
    text_chars: torch.Tensor = None    # uint16 [N, T] (stored as int32)
    lcs_ok: torch.Tensor = None        # bool [N]
    lcs_ok_host: np.ndarray = None     # bool [N] host copy (resolve gating)
    n_docs: int = -1
    n_words: int = -1

    @staticmethod
    def build(doc_texts, delimiters, device=None) -> "CoverageTables":
        """Encode normalized lowercase doc texts into token tables on
        ``device`` (default ``runtime.device()``)."""
        return CoverageTables.from_arrays(
            _encode_doc_arrays(doc_texts, delimiters), doc_texts, device)

    @staticmethod
    def from_arrays(arrays, doc_texts, device=None,
                    text_blob=None) -> "CoverageTables":
        """The tables of ``_encode_doc_arrays``' bundle ``arrays`` for the
        texts ``doc_texts``; ``text_blob`` (the bulk pass's UTF-32 texts,
        offsets and per-text flags, see ``_attach_text_lcs``) spares
        encoding the texts again."""
        dev = torch.device(device) if device is not None else runtime.device()
        t = _tables_from_arrays(*arrays, dev)
        _attach_text_lcs(t, doc_texts, text_blob)
        return t

    def append_texts(self, doc_texts, delimiters, start_id: int) -> bool:
        """Append ``doc_texts`` as docs ``start_id..`` by writing their
        rows into the existing tables in place (``_append_update``) and
        the host mirrors — O(delta) instead of re-encoding the corpus at
        every incremental finalize. New words get fresh codes past
        ``n_words``; duplicate words across base and delta get duplicate
        rows, which is harmless (the program compares characters through
        gathers, never code identity). Returns False when an axis bucket
        would overflow or a new text needs a larger LCS bucket: the
        caller then rebuilds, which re-buckets."""
        k = len(doc_texts)
        if k == 0:
            return True
        if self.n_docs < 0 or self.n_words < 0 or start_id != self.n_docs:
            return False
        if self.text_chars is None or self.lcs_ok_host is None:
            return False
        (word_chars, word_chars_rev, word_lens, doc_tokens, doc_offsets,
         doc_count, doc_adj, doc_text_len, overflow,
         max_wlen) = _encode_doc_arrays(doc_texts, delimiters)
        w_new = int(word_chars.shape[0])
        if not word_lens.any():
            w_new = 0  # no real words (the encoder pads an empty vocab row)
        n_pad = int(self.overflow.shape[0])
        v_pad = int(self.word_lens.shape[0])
        # local word codes -> global (past the current vocabulary)
        doc_tokens = np.where(doc_tokens >= 0,
                              doc_tokens + np.int32(self.n_words),
                              np.int32(-1))
        # text-LCS rows for the new docs (utf-16 code units, stored int32)
        t_cap = int(self.text_chars.shape[1])
        encs = [t.encode("utf-16-le") for t in doc_texts]
        if any(t_cap < (len(b) >> 1) <= T_LCS_BUCKETS[-1] for b in encs):
            return False  # a full rebuild picks a bigger text bucket
        tc_rows = np.zeros((k, t_cap), np.int32)
        lok_rows = np.zeros(k, bool)
        for i, b in enumerate(encs):
            m = len(b) >> 1
            if 0 < m <= t_cap:
                tc_rows[i, :m] = np.frombuffer(b, "<u2")
                lok_rows[i] = True
        lok_rows &= ~((tc_rows >= 0xD800) & (tc_rows < 0xE000)).any(axis=1)

        k_pad = _append_bucket(k)
        w_pad = _append_bucket(w_new) if w_new else 0
        if start_id + k_pad > n_pad or self.n_words + w_pad > v_pad:
            return False

        def pad_rows(a, rows, fill=0):
            out = np.full((rows,) + a.shape[1:], fill, dtype=a.dtype)
            out[: a.shape[0]] = a
            return out

        if w_pad:
            _append_update(self.n_words, (
                (self.word_chars, pad_rows(word_chars, w_pad)),
                (self.word_chars_rev, pad_rows(word_chars_rev, w_pad)),
                (self.word_lens, pad_rows(word_lens, w_pad))))
        _append_update(start_id, (
            (self.doc_tokens, pad_rows(doc_tokens, k_pad, fill=-1)),
            (self.doc_tok_offsets, pad_rows(doc_offsets, k_pad)),
            (self.doc_tok_count, pad_rows(doc_count, k_pad)),
            (self.doc_adj_ws, pad_rows(doc_adj, k_pad)),
            (self.doc_text_len, pad_rows(doc_text_len, k_pad)),
            (self.text_chars, pad_rows(tc_rows, k_pad)),
            (self.lcs_ok, pad_rows(lok_rows, k_pad))))
        # host mirrors (exact rows, not the padded update)
        self.overflow[start_id:start_id + k] = overflow
        self.tok_count_host[start_id:start_id + k] = doc_count
        self.max_wlen_host[start_id:start_id + k] = max_wlen
        self.lcs_ok_host[start_id:start_id + k] = lok_rows
        self.n_docs = start_id + k
        self.n_words += w_new
        return True


#: row-count buckets of incremental appends (the reference's): an update
#: writes its rows padded to one of these, so when a table overflows is
#: the reference's decision exactly
_APPEND_BUCKETS = (16, 64, 256, 1024, 4096)


def _append_bucket(n: int) -> int:
    for b in _APPEND_BUCKETS:
        if n <= b:
            return b
    return n  # very large appends: exact size


def _append_update(start: int, blocks) -> None:
    """In-place row updates of device tables: each (table, rows) pair
    copies the host rows into ``table[start:start + len(rows)]``. Pad rows
    of an update re-write pad rows with the content they already hold.
    The copies are blocking (pageable numpy source) and run on the
    current stream, after every kernel already queued on it; the caller
    holds the engine's write lock, so no reader is between its dispatch
    and its readback."""
    for table, rows in blocks:
        src = torch.from_numpy(np.ascontiguousarray(rows))
        table[start:start + src.shape[0]].copy_(src.to(table.dtype))


def _encode_doc_arrays(doc_texts, delimiters):
    """Raw (unpadded) token-table arrays for ``doc_texts`` — native C++
    pass when available, Python fallback otherwise (identical outputs)."""
    try:
        from ..native.bulk import build_coverage_arrays

        arrays = build_coverage_arrays(list(doc_texts), delimiters,
                                       D_MAX, L_MAX)
    except Exception:
        arrays = None
    if arrays is not None:
        return arrays
    delims = set(delimiters)
    word_to_code = {}
    words = []
    n = len(doc_texts)
    doc_tokens = np.full((n, D_MAX), -1, dtype=np.int32)
    doc_offsets = np.zeros((n, D_MAX), dtype=np.int32)
    doc_count = np.zeros(n, dtype=np.int32)
    doc_adj = np.zeros((n, D_MAX), dtype=bool)
    doc_text_len = np.zeros(n, dtype=np.int32)
    overflow = np.zeros(n, dtype=bool)
    max_wlen = np.zeros(n, dtype=np.int32)

    for doc_id, text in enumerate(doc_texts):
        doc_text_len[doc_id] = len(text)
        toks = []  # (word, offset)
        i, ln = 0, len(text)
        while i < ln:
            while i < ln and text[i] in delims:
                i += 1
            start = i
            while i < ln and text[i] not in delims:
                i += 1
            if i > start:
                toks.append((text[start:i], start))
        if len(toks) > D_MAX:
            overflow[doc_id] = True
            toks = toks[:D_MAX]
        doc_count[doc_id] = len(toks)
        for j, (w, off) in enumerate(toks):
            if len(w) > L_MAX:
                overflow[doc_id] = True
                w = w[:L_MAX]
            if len(w) > max_wlen[doc_id]:
                max_wlen[doc_id] = len(w)
            code = word_to_code.get(w)
            if code is None:
                code = len(words)
                word_to_code[w] = code
                words.append(w)
            doc_tokens[doc_id, j] = code
            doc_offsets[doc_id, j] = off
            if j + 1 < len(toks):
                gap = text[off + len(w): toks[j + 1][1]]
                doc_adj[doc_id, j] = all(c.isspace() for c in gap)

    w_count = max(len(words), 1)
    word_chars = np.zeros((w_count, L_MAX), dtype=np.int32)
    word_chars_rev = np.zeros((w_count, L_MAX), dtype=np.int32)
    word_lens = np.zeros(w_count, dtype=np.int32)
    for code, w in enumerate(words):
        word_lens[code] = len(w)
        for k, ch in enumerate(w):
            word_chars[code, k] = ord(ch)
            word_chars_rev[code, len(w) - 1 - k] = ord(ch)

    return (word_chars, word_chars_rev, word_lens, doc_tokens, doc_offsets,
            doc_count, doc_adj, doc_text_len, overflow, max_wlen)


def _attach_text_lcs(tables: CoverageTables, doc_texts,
                     text_blob=None) -> None:
    """Build + upload the [N, T] utf-16 text table for the fake-LCS (N
    padded like the token tables; T the smallest T_LCS_BUCKETS entry that
    covers the corpus' longest eligible text).

    ``text_blob``: (UTF-32 blob, offsets, slow) of ``doc_texts``, slow
    where a text's UTF-16 code units are not its code points (a surrogate
    or a code point past the BMP). The other texts' rows are copied from
    the blob; only the slow ones are encoded."""
    n_pad = int(tables.doc_tok_count.shape[0])
    if text_blob is not None:
        _attach_text_lcs_blob(tables, doc_texts, n_pad, *text_blob)
        return
    encs = [t.encode("utf-16-le") for t in doc_texts]
    lens = np.fromiter((len(b) >> 1 for b in encs), np.int64,
                       len(encs)) if encs else np.zeros(0, np.int64)
    t_cap = _lcs_cap(lens)
    chars = np.zeros((n_pad, t_cap), np.uint16)
    ok = np.zeros(n_pad, bool)
    for i, b in enumerate(encs):
        m = len(b) >> 1
        if 0 < m <= t_cap:
            chars[i, :m] = np.frombuffer(b, "<u2")
            ok[i] = True
    _upload_text_lcs(tables, chars, ok)


def _lcs_cap(lens: np.ndarray) -> int:
    t_cap = T_LCS_BUCKETS[0]
    if lens.size:
        longest = int(lens[lens <= T_LCS_BUCKETS[-1]].max(initial=0))
        for b in T_LCS_BUCKETS:
            if b >= longest:
                t_cap = b
                break
    return t_cap


def _attach_text_lcs_blob(tables, doc_texts, n_pad, blob, offsets, slow):
    n = offsets.size - 1
    lens = np.diff(offsets)
    slow_ids = np.flatnonzero(slow)
    encs = {i: doc_texts[i].encode("utf-16-le") for i in slow_ids.tolist()}
    for i, b in encs.items():
        lens[i] = len(b) >> 1
    t_cap = _lcs_cap(lens)
    chars = np.zeros((n_pad, t_cap), np.uint16)
    ok = np.zeros(n_pad, bool)
    ok[:n] = (lens > 0) & (lens <= t_cap)
    fast = ok[:n] & ~slow
    cols = np.arange(t_cap)
    chars[:n][fast[:, None] & (cols < lens[:, None])] = \
        blob[:offsets[-1]][np.repeat(fast, np.diff(offsets))]
    for i, b in encs.items():
        if ok[i]:
            chars[i, :len(b) >> 1] = np.frombuffer(b, "<u2")
    _upload_text_lcs(tables, chars, ok)


def _upload_text_lcs(tables, chars, ok) -> None:
    # surrogate pairs: code units no longer align with Python chars
    ok &= ~((chars >= 0xD800) & (chars < 0xE000)).any(axis=1)
    dev = tables.doc_tok_count.device
    # torch has no uint16 arithmetic on every device: the code units ride
    # as int32 (values unchanged)
    tables.text_chars = _upload(chars.astype(np.int32), dev)
    tables.lcs_ok = _upload(ok, dev)
    tables.lcs_ok_host = ok


def encode_query_lcs(query_lower: str, cap: int = QT_LCS):
    """(chars uint16 [cap], len, ok) for the device fake-LCS.

    ok=False (query too long / contains surrogate pairs) keeps the whole
    query on the host LCS path."""
    b = np.frombuffer(query_lower.encode("utf-16-le"), "<u2")
    ok = bool(b.size and b.size <= cap
              and not ((b >= 0xD800) & (b < 0xE000)).any())
    arr = np.zeros(cap, np.uint16)
    if ok:
        arr[: b.size] = b
    return arr, np.int32(b.size if ok else 0), ok


def encode_query_tokens(tokens, max_tokens: int):
    """(chars [max,L], rev_chars [max,L], lens, offsets, count, overflow)."""
    chars = np.zeros((max_tokens, L_MAX), dtype=np.int32)
    rev = np.zeros((max_tokens, L_MAX), dtype=np.int32)
    lens = np.zeros(max_tokens, dtype=np.int32)
    offsets = np.zeros(max_tokens, dtype=np.int32)
    overflow = len(tokens) > max_tokens
    for i, t in enumerate(tokens[:max_tokens]):
        text = t.lower
        if len(text) > L_MAX:
            overflow = True
            text = text[:L_MAX]
        lens[i] = len(text)
        offsets[i] = t.position
        for k, ch in enumerate(text):
            chars[i, k] = ord(ch)
            rev[i, len(text) - 1 - k] = ord(ch)
    return chars, rev, lens, offsets, min(len(tokens), max_tokens), overflow


# ======================================================================
# Small helpers (C-minor layout: the candidate axis is last everywhere)


def _seq_sum(x: torch.Tensor) -> torch.Tensor:
    """Sum over axis 0 in index order, starting from 0 (one rounding per
    term, the host oracle's order)."""
    acc = torch.zeros_like(x[0])
    for i in range(x.shape[0]):
        acc = acc + x[i]
    return acc


def _rdiv(a: float, t: torch.Tensor) -> torch.Tensor:
    """``a / t`` as ONE f32 division (PyTorch's scalar / tensor is a
    reciprocal times the scalar, two roundings)."""
    return torch.full_like(t, a) / t


def _div(t: torch.Tensor, a: float) -> torch.Tensor:
    """``t / a`` as ONE f32 division on every device: for a CUDA tensor
    divided by a Python scalar, PyTorch multiplies by the scalar's
    reciprocal (two roundings; the CPU divides), so the divisor is given
    as a tensor."""
    return t / torch.full_like(t, a)


def _iota(n: int, dev) -> torch.Tensor:
    return torch.arange(n, dtype=_I32, device=dev)


# ======================================================================
# Pairwise primitives: [S, D, C] relations between query and doc tokens.


def _pairwise_primitives(q_chars, q_lens, q_rev, chars_t, chars_rev_t,
                         lens, valid):
    """EQ / D startswith Q / D endswith Q / Q endswith D / D contains Q /
    common-prefix length. q_chars/q_rev [S,L,C]; chars_t/chars_rev_t
    [L,D,C]; lens/valid [D,C]. Outputs [S,D,C], masked by ``valid``."""
    L, D, C = chars_t.shape
    S = q_chars.shape[0]
    l4 = _iota(L, chars_t.device)[None, :, None, None]

    q_t = q_chars[:, :, None, :]                       # [S,L,1,C]
    qr_t = q_rev[:, :, None, :]
    d_t = chars_t[None]                                # [1,L,D,C]
    dr_t = chars_rev_t[None]
    ql = q_lens[:, None, :]                            # [S,1,C]
    ql4 = q_lens[:, None, None, :]                     # [S,1,1,C]
    dl = lens[None]                                    # [1,D,C]
    dl4 = lens[None, None]                             # [1,1,D,C]
    v = valid[None]                                    # [1,D,C]

    all_eq = ((q_t == d_t) | (l4 >= ql4)).all(dim=1)           # [S,D,C]
    eq = v & (dl == ql) & all_eq
    d_sw_q = v & (dl >= ql) & all_eq

    rev_pref_q = ((qr_t == dr_t) | (l4 >= ql4)).all(dim=1)
    d_ew_q = v & (dl >= ql) & rev_pref_q
    rev_pref_d = ((qr_t == dr_t) | (l4 >= dl4)).all(dim=1)
    q_ew_d = v & (ql >= dl) & rev_pref_d

    # d contains q: slide q over a zero-padded copy of d
    padded = torch.cat([chars_t, torch.zeros_like(chars_t)], dim=0)  # [2L,D,C]
    d_cont_q = torch.zeros((S, D, C), dtype=torch.bool, device=chars_t.device)
    for sw in range(L):
        sh = padded[sw:sw + L][None]
        hit = ((sh == q_t) | (l4 >= ql4)).all(dim=1) & (sw + ql <= dl)
        d_cont_q = d_cont_q | hit
    d_cont_q = d_cont_q & v

    both4 = torch.minimum(ql4, dl4)
    mism = (q_t != d_t) & (l4 < both4)
    any_m = mism.any(dim=1)
    first_m = _first(mism, 1)
    common_prefix = torch.where(any_m, first_m,
                                torch.minimum(ql, dl).expand(any_m.shape))
    return eq, d_sw_q, d_ew_q, q_ew_d, d_cont_q, common_prefix


def _q_startswith_d_t(q_chars, q_lens, chars_t, lens, valid):
    """q token starts with doc token: [S,D,C]."""
    L = chars_t.shape[0]
    l4 = _iota(L, chars_t.device)[None, :, None, None]
    q_t = q_chars[:, :, None, :]
    d_t = chars_t[None]
    ql = q_lens[:, None, :]
    dl = lens[None]
    dl4 = lens[None, None]
    ch_eq = ((q_t == d_t) | (l4 >= dl4)).all(dim=1)
    return valid[None] & (ql >= dl) & ch_eq


# ======================================================================
# Pair words and the matcher cascade: two hand-written kernels on the card
# (csrc/coverage_pairs.cu, csrc/coverage_cascade.cu), each with its plain
# PyTorch version here.


def pack_pairs(relations, prefix, distances=None) -> torch.Tensor:
    """The pair word of ``_kernels.PAIR_*``: six relation tensors (bool
    [S,D,C], in the order EQ, D_SW_Q, D_EW_Q, Q_EW_D, D_CONT_Q, Q_SW_D) in
    bits 0-5, the common-prefix length from bit 8 and, when given, the five
    distances (each at most 4) in three bits each from bit 16."""
    word = prefix.to(_I32) << _kernels.PAIR_PREFIX_SHIFT
    for bit, rel in enumerate(relations):
        word = word | (rel.to(_I32) << bit)
    if distances is not None:
        for shift, dist in zip(_kernels.PAIR_DIST_SHIFTS, distances):
            word = word | (dist << shift)
    return word


def unpack_relations(pairs: torch.Tensor):
    """``(EQ, D_SW_Q, D_EW_Q, Q_EW_D, D_CONT_Q, Q_SW_D, common_prefix)``
    out of pair words: six bool tensors and one int32."""
    rels = tuple((pairs & (1 << bit)) != 0 for bit in range(6))
    return rels + ((pairs >> _kernels.PAIR_PREFIX_SHIFT) & 31,)


def coverage_pairs_plain(q_chars, q_rev, q_lens, chars_t, chars_rev_t, lens,
                         valid, distances: bool) -> torch.Tensor:
    """Plain PyTorch version of ``coverage_pairs`` (same arguments, same
    result bit for bit), on any device."""
    eq, d_sw_q, d_ew_q, q_ew_d, d_cont_q, prefix = _pairwise_primitives(
        q_chars, q_lens, q_rev, chars_t, chars_rev_t, lens, valid)
    q_sw_d = _q_startswith_d_t(q_chars, q_lens, chars_t, lens, valid)
    dists = coverage_distances_plain(
        q_chars, q_rev, q_lens, chars_t, chars_rev_t, lens) \
        if distances else None
    return pack_pairs((eq, d_sw_q, d_ew_q, q_ew_d, d_cont_q, q_sw_d), prefix,
                      dists)


def coverage_pairs(q_chars, q_rev, q_lens, chars_t, chars_rev_t, lens, valid,
                   distances: bool) -> torch.Tensor:
    """One int32 pair word [S, D, C] per (query token, doc token,
    candidate): the six word relations (masked by the doc token's
    ``valid``), the common-prefix length and, with ``distances``, the five
    Damerau distances of ``coverage_distances_plain``; see ``pack_pairs``.

    ``q_chars``/``q_rev`` int32 [S, L, C], ``q_lens`` int32 [S, C];
    ``chars_t``/``chars_rev_t`` int32 [L, D, C], ``lens`` int32 and
    ``valid`` bool [D, C]; lengths at most L. CUDA tensors launch the
    kernel; CPU tensors take the plain version."""
    if chars_t.device.type == "cpu":
        return coverage_pairs_plain(q_chars, q_rev, q_lens, chars_t,
                                    chars_rev_t, lens, valid, distances)
    return _kernels.coverage_pairs(q_chars, q_rev, q_lens, chars_t,
                                   chars_rev_t, lens, valid, distances)


def coverage_pair_block(q_set, fq_set, chars_t, chars_rev_t, lens, valid):
    """A coverage block's two sets of pair words over the same doc
    tokens: ``coverage_pairs`` of the Q tokens ``q_set`` = (``q_chars``,
    ``q_rev``, ``q_lens``) with distances and of the fusion tokens
    ``fq_set`` without. Returns the two int32 [*, D, C] tensors. CUDA
    tensors launch the kernel once for both; CPU tensors take the plain
    version (``coverage_pair_block_plain``)."""
    if chars_t.device.type == "cpu":
        return coverage_pair_block_plain(q_set, fq_set, chars_t, chars_rev_t,
                                         lens, valid)
    return _kernels.coverage_pair_block(q_set, fq_set, chars_t, chars_rev_t,
                                        lens, valid)


def coverage_pair_block_plain(q_set, fq_set, chars_t, chars_rev_t, lens,
                              valid):
    """Plain PyTorch version of ``coverage_pair_block``: the plain
    version of ``coverage_pairs`` for each set, on any device."""
    doc = (chars_t, chars_rev_t, lens, valid)
    return (coverage_pairs_plain(*q_set, *doc, True),
            coverage_pairs_plain(*fq_set, *doc, False))


def coverage_cascade(pairs, lens, offsets, codes, first_char, tok_count,
                     qlens2, qsorted2, qc3, qcount, config):
    """The Stage-2 matcher cascade over one block of candidates: whole
    word -> joined word -> prefix/suffix -> fuzzy word, each query token
    and each doc token consumed once.

    ``pairs`` int32 [Q, D, C] pair words with distances; ``lens`` (0 where
    the token is invalid), ``offsets``, ``codes`` (-1 padded),
    ``first_char`` int32 [D, C]; ``tok_count``, ``qcount`` int32 [C];
    ``qlens2``, ``qsorted2`` int32 [Q, C]; ``qc3`` int32 [Q, L, C].
    Returns ``(term_matched f32 [Q, C], term_has_whole, term_has_joined,
    term_has_prefix bool [Q, C], term_first_pos int32 [Q, C], word_hits
    int32 [C], cov_count [C])``. CUDA tensors launch the kernel; CPU
    tensors take the plain version."""
    if pairs.device.type == "cpu":
        return coverage_cascade_plain(pairs, lens, offsets, codes, first_char,
                                      tok_count, qlens2, qsorted2, qc3,
                                      qcount, config)
    return _kernels.coverage_cascade(pairs, lens, offsets, codes, first_char,
                                     tok_count, qlens2, qsorted2, qc3, qcount,
                                     config)


def coverage_cascade_plain(pairs, lens, offsets, codes, first_char,
                           tok_count, qlens2, qsorted2, qc3, qcount, config):
    """Plain PyTorch version of ``coverage_cascade`` (same arguments, same
    result: integers equal, ``term_matched`` bit for bit), on any device;
    ``cov_count`` comes out int64 here."""
    dev = pairs.device
    f32 = _F32
    Q, D, C = pairs.shape
    (EQ, D_SW_Q, D_EW_Q, Q_EW_D, D_CONT_Q, _Q_SW_D,
     _cp) = unpack_relations(pairs)
    dam1, dam2, pdam1, pdam2, pdam3 = unpack_distances(pairs)

    d_iota = _iota(D, dev)
    all_valid = (codes >= 0) & (d_iota[:, None] < tok_count[None])  # [D,C]
    cov = all_valid & (lens >= config.min_word_size)
    same = codes[:, None, :] == codes[None, :, :]            # [D,D',C]
    earlier = (d_iota[None, :] < d_iota[:, None])[:, :, None]
    dup = (same & earlier & cov[None]).any(dim=1) & cov
    unique = cov & ~dup
    cov_count = cov.sum(dim=0)

    q_iota = _iota(Q, dev)
    q_valid = q_iota[:, None] < qcount[None]         # [Q,C]

    def first_true(mask):
        """mask [D,C] -> (any [C], first index [C])."""
        return mask.any(dim=0), _first(mask, 0)

    def at(arr, j):
        """arr [D,C] at per-candidate index j [C] -> [C]."""
        return arr.gather(0, j.long()[None])[0]

    def at_q(arr, qi):
        """arr [Q,C] at per-candidate index qi [C] -> [C] (qi < Q)."""
        return arr.gather(0, qi.long()[None])[0]

    def set_at_false(arr, j, cond):
        mask = (d_iota[:, None] == j[None, :]) & cond[None, :]
        return arr & ~mask

    def note_pos(first_pos, i, pos, cond):
        cur = first_pos[i]
        new = torch.where((cur == -1) | (pos < cur), pos, cur)
        first_pos[i] = torch.where(cond, new, cur)

    def note_pos_q(first_pos, qi, upd, m, pos):
        """term_first_pos update at per-candidate query row qi."""
        cur = at_q(first_pos, qi)
        new = torch.where((cur == -1) | (pos < cur), pos, cur)
        return torch.where(upd, torch.where(m, new, cur)[None, :], first_pos)

    # ---------------- matcher state ------------------------------------
    q_active = q_valid.clone()                       # [Q,C]
    d_active = unique.clone()                        # [D,C]
    term_matched = torch.zeros((Q, C), dtype=f32, device=dev)
    term_has_whole = torch.zeros((Q, C), dtype=torch.bool, device=dev)
    term_has_joined = torch.zeros((Q, C), dtype=torch.bool, device=dev)
    term_has_prefix = torch.zeros((Q, C), dtype=torch.bool, device=dev)
    term_first_pos = torch.full((Q, C), -1, dtype=_I32, device=dev)
    word_hits = torch.zeros((C,), dtype=_I32, device=dev)
    # The reference also accumulates the CoverageScorer numerator (whole /
    # joined / prefix-suffix / fuzzy credit minus the order penalty); no
    # output reads it, so the port does not compute it.

    # ---------------- 1. whole word matcher ----------------------------
    if config.cover_whole_words:
        for i in range(Q):
            ql = qlens2[i]
            eq_i = EQ[i]
            any_m, j = first_true(eq_i & d_active)
            m = any_m & q_active[i] & (i < qcount)
            word_hits = word_hits + m
            term_matched[i] = term_matched[i] + torch.where(m, ql.to(f32),
                                                            0.0)
            term_has_whole[i] |= m
            term_has_prefix[i] |= m
            note_pos(term_first_pos, i, at(offsets, j), m)
            q_active[i] &= ~m
            d_active = set_at_false(d_active, j, m)

    # ---------------- 2. joined word matcher ---------------------------
    if config.cover_joined_words:
        for i in range(Q - 1):
            cond_q = q_active[i] & q_active[i + 1] & (i + 1 < qcount)
            jl = qlens2[i] + qlens2[i + 1]                 # [C]
            dmask = d_active & (lens == jl[None, :]) & D_SW_Q[i] & \
                D_EW_Q[i + 1]
            any_m, j = first_true(dmask)
            m = any_m & cond_q
            word_hits = word_hits + 2 * m.to(_I32)
            pos = at(offsets, j)
            term_matched[i] = term_matched[i] + torch.where(
                m, qlens2[i].to(f32), 0.0)
            term_has_joined[i] |= m
            term_has_prefix[i] |= m
            note_pos(term_first_pos, i, pos, m)
            term_matched[i + 1] = term_matched[i + 1] + torch.where(
                m, qlens2[i + 1].to(f32), 0.0)
            term_has_joined[i + 1] |= m
            note_pos(term_first_pos, i + 1, pos, m)
            q_active[i] &= ~m
            q_active[i + 1] &= ~m
            d_active = set_at_false(d_active, j, m)

        # doc-joined: adjacent ACTIVE doc pair == one query token
        for i in range(D - 1):
            di_active = d_active[i]
            later = d_active & (d_iota[:, None] > i)
            has_nxt, nxt = first_true(later)
            cond = di_active & has_nxt
            len_i = lens[i]
            jl = len_i + at(lens, nxt)
            q_sw_di = _Q_SW_D[:, i]                                  # [Q,C]
            q_ew_dn = Q_EW_D.gather(
                1, nxt.long()[None, None].expand(Q, 1, C))[:, 0]     # [Q,C]
            qmask = q_active & (qlens2 == jl[None, :]) & q_sw_di & q_ew_dn
            any_q = qmask.any(dim=0)
            qi = _first(qmask, 0)
            m = cond & any_q
            word_hits = word_hits + m
            upd = m[None, :] & (q_iota[:, None] == qi[None, :])
            term_matched = term_matched + \
                torch.where(upd, jl[None, :].to(f32), 0.0)
            term_has_joined = term_has_joined | upd
            term_has_prefix = term_has_prefix | upd
            term_first_pos = note_pos_q(term_first_pos, qi, upd, m,
                                        offsets[i])
            q_active = q_active & ~upd
            d_active[i] &= ~m
            d_active = set_at_false(d_active, nxt, m)

    # ---------------- 3. prefix/suffix matcher -------------------------
    if config.cover_prefix_suffix:
        d_key = torch.where(d_active, -lens, 10 ** 6) * D + d_iota[:, None]

        def first_in_order(flags):
            """First flagged doc token in (length desc, index asc) order."""
            masked = torch.where(flags, d_key, 2 ** 30)
            return flags.any(dim=0), masked.argmin(dim=0).to(_I32)

        def take_q(arr_sdc, qi):
            """arr [S,D,C] at per-candidate token index qi [C] -> [D,C]."""
            idx = qi.long()[None, None].expand(1, arr_sdc.shape[1], C)
            return arr_sdc.gather(0, idx)[0]

        for si in range(Q):
            qi = qsorted2[si]
            qi_c = torch.clamp(qi, 0, Q - 1)
            in_q = qi < Q
            ql = torch.where(in_q, at_q(qlens2, qi_c), 0)          # [C]
            qlc = ql[None, :]
            qa = at_q(q_active, qi_c) & in_q & (qi < qcount)

            shorter = qlc < lens
            longer = qlc > lens
            pre = shorter & take_q(D_SW_Q, qi_c) & in_q
            suf = shorter & ~pre & take_q(D_EW_Q, qi_c) & in_q
            cont = shorter & ~pre & ~suf & (qlc >= 4) & \
                take_q(D_CONT_Q, qi_c) & in_q
            dq = longer & take_q(Q_EW_D, qi_c) & in_q
            is_match = (pre | suf | cont | dq) & d_active
            qlf = qlc.to(f32).expand(lens.shape)
            score = torch.where(
                pre, qlf,
                torch.where(suf, torch.clamp_min(qlc // 2, 1).to(f32)
                            .expand(lens.shape),
                            torch.where(cont, qlf * 0.6, lens.to(f32))))
            any_m, j = first_in_order(is_match)
            m = any_m & qa
            sc = at(torch.where(is_match, score, 0.0), j)
            is_pre = at(pre, j)
            word_hits = word_hits + m
            upd = m[None, :] & (q_iota[:, None] == qi[None, :])
            term_matched = term_matched + torch.where(upd, sc[None, :], 0.0)
            term_has_prefix = term_has_prefix | (upd & is_pre[None, :])
            term_first_pos = note_pos_q(term_first_pos, qi_c, upd, m,
                                        at(offsets, j))
            q_active = q_active & ~upd
            d_active = set_at_false(d_active, j, m)

        for si in range(Q):
            qi = qsorted2[si]
            qi_c = torch.clamp(qi, 0, Q - 1)
            in_q = qi < Q
            ql = torch.where(in_q, at_q(qlens2, qi_c), 0)
            qlc = ql[None, :]
            qa = at_q(q_active, qi_c) & in_q & (qi < qcount)
            eligible_q = (ql >= 4) | ((qi == qcount - 1) & (ql >= 2))
            d_elig = d_active & (qlc < lens)

            d1 = torch.where(in_q, take_q(pdam1, qi_c), 0)
            d2 = torch.where(in_q, take_q(pdam2, qi_c), 0)
            d3 = torch.where(in_q, take_q(pdam3, qi_c), 0)
            m1 = d1 <= 1
            m2 = ~m1 & (lens > qlc) & (d2 <= 1)
            m3 = ~m1 & ~m2 & (lens > qlc) & (qlc > 1) & (d3 <= 1)
            score = torch.where(
                m1, torch.clamp_min((qlc - d1).to(f32), 0.1),
                torch.where(m2, torch.clamp_min((qlc - d2).to(f32), 0.1),
                            torch.clamp_min((qlc - 1 - d3).to(f32), 0.1)))
            is_match = (m1 | m2 | m3) & d_elig
            any_m, j = first_in_order(is_match)
            m = any_m & qa & eligible_q
            sc = at(torch.where(is_match, score, 0.0), j)
            word_hits = word_hits + m
            upd = m[None, :] & (q_iota[:, None] == qi[None, :])
            term_matched = term_matched + torch.where(upd, sc[None, :], 0.0)
            term_first_pos = note_pos_q(term_first_pos, qi_c, upd, m,
                                        at(offsets, j))
            q_active = q_active & ~upd
            d_active = set_at_false(d_active, j, m)

    # ---------------- 4. fuzzy word matcher ----------------------------
    if config.cover_fuzzy_words:
        fully = (qlens2 <= 0) | (term_matched >= qlens2.to(f32)) | ~q_valid
        all_full = fully.all(dim=0)
        max_q_len = torch.where(q_active & q_valid, qlens2, 0).amax(dim=0)
        max_edit = torch.where(
            max_q_len >= config.min_length_two_typos, 2,
            torch.where(max_q_len >= config.min_length_one_typo, 1, 0))
        special_global = (max_q_len == 2) & (max_edit == 0) & \
            (config.num_typos >= 1)
        max_edit = torch.where(special_global, 1, max_edit)
        max_edit = torch.clamp_max(max_edit, config.num_typos)

        for edit_dist in (1, 2):
            if edit_dist > config.num_typos:
                break
            round_on = (edit_dist <= max_edit) & ~all_full
            dist_all = dam1 if edit_dist == 1 else dam2
            for i in range(Q):
                ql = qlens2[i]
                qa = q_active[i] & (i < qcount) & round_on
                if config.min_word_size > 0:
                    qa = qa & (ql >= config.min_word_size)
                token_max = torch.where(
                    ql >= config.min_length_two_typos, 2,
                    torch.where(ql >= config.min_length_one_typo, 1, 0))
                special = (ql == 2) & (token_max == 0) & \
                    (config.num_typos >= 1)
                token_max = torch.where(special, 1, token_max)
                token_max = torch.clamp_max(token_max, config.num_typos)
                qa = qa & (edit_dist <= token_max)
                if edit_dist != 1:
                    qa = qa & ~special
                min_len = torch.clamp_min(ql - edit_dist,
                                          config.min_word_size)[None, :]
                max_len = torch.clamp_max(
                    torch.clamp_max(ql + edit_dist,
                                    config.levenshtein_max_word_size),
                    63)[None, :]
                window = (lens >= min_len) & (lens <= max_len)
                first_char_ok = ~special[None, :] | (
                    (lens > 0) & (first_char == qc3[i, 0][None, :]))
                dist = dist_all[i]
                is_match = d_active & window & first_char_ok & \
                    (dist <= edit_dist)
                any_m, j = first_true(is_match)
                m = any_m & qa
                dd = at(dist, j)
                credit = torch.where(m, (ql - dd).to(f32), 0.0)
                word_hits = word_hits + m
                term_matched[i] = term_matched[i] + credit
                note_pos(term_first_pos, i, at(offsets, j), m)
                q_active[i] &= ~m
                d_active = set_at_false(d_active, j, m)
    return (term_matched, term_has_whole, term_has_joined, term_has_prefix,
            term_first_pos, word_hits, cov_count)


# ======================================================================
# The program


def _as_dev(x, dev, dtype=None) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.to(dev) if dtype is None else x.to(dev, dtype)
    a = np.asarray(x)
    if a.dtype == np.uint16 or dtype is not None:
        a = a.astype(np.int32)
    return _upload(a, dev)


def _check_ids(name: str, ids, n: int) -> None:
    """Raise IndexError unless every row id of a host array ``ids`` is in
    [0, n): the gather kernel reads the tables at these rows unchecked. A
    device tensor is taken as it is (reading it back would wait for the
    card); the engine passes host arrays."""
    if isinstance(ids, torch.Tensor):
        return
    a = np.asarray(ids)
    if a.size and (int(a.min()) < 0 or int(a.max()) >= n):
        raise IndexError(f"coverage_fusion_batch: {name} outside [0, {n})")


def coverage_fusion_batch(
    word_chars, word_chars_rev, word_lens, doc_tokens, doc_tok_offsets,
    doc_tok_count, doc_adj_ws, doc_text_len,
    text_ids,            # int32 [C] internal id whose text is scored
    qsel,                # int32 [C] which query each candidate belongs to
    q_chars, q_chars_rev,        # int32 [B, Q, L]
    q_lens, q_idf, q_word_idf,   # [B, Q]
    q_count,                     # int32 [B]
    q_sorted,                    # int32 [B, Q] length-desc stable order
    fq_chars, fq_chars_rev,      # int32 [B, FQ, L]
    fq_lens,                     # int32 [B, FQ]
    fq_count,                    # int32 [B]
    fq_last_is_alpha,            # bool [B]
    lcs_vals,            # f32 [C] (host LCS; 0 where device-computable)
    base_scores,         # f32 [C]
    query_len,           # int32 [B] (full query string lengths)
    text_chars=None,     # [N, T] full-text chars (device fake-LCS)
    lcs_ok_dev=None,     # bool [N]
    q_text=None,         # uint16 [B, QT]
    q_text_len=None,     # int32 [B]
    q_lcs_tol=None,      # int32 [B] per-query error tolerance
    q_lcs_ok=None,       # bool [B]
    *,
    config: CoverageConfig,
) -> torch.Tensor:
    """Score C candidates; returns packed f32 ``[2, C]`` (score,
    tie<<16 | word_hits<<8 | lcs) when ``text_chars`` is given, else
    ``[3, C]`` (score, tie, word_hits). Arguments other than the tables
    may be numpy arrays; everything runs on the tables' device."""
    dev = doc_tokens.device
    tables = (word_chars, word_chars_rev, word_lens, doc_tokens,
              doc_tok_offsets, doc_tok_count, doc_adj_ws, doc_text_len)
    queries = tuple(_as_dev(x, dev) for x in (
        q_chars, q_chars_rev, q_lens, q_idf, q_word_idf, q_count, q_sorted,
        fq_chars, fq_chars_rev, fq_lens, fq_count, fq_last_is_alpha,
        query_len))
    lcs = None
    if text_chars is not None:
        lcs = (text_chars, lcs_ok_dev, _as_dev(q_text, dev, _I32),
               _as_dev(q_text_len, dev), _as_dev(q_lcs_tol, dev),
               _as_dev(q_lcs_ok, dev))
    _check_ids("text_ids", text_ids, doc_tokens.shape[0])
    _check_ids("qsel", qsel, queries[2].shape[0])
    rows = tuple(_as_dev(x, dev) for x in (text_ids, qsel, lcs_vals,
                                           base_scores))
    n = rows[0].shape[0]
    outs = []
    for lo in range(0, max(n, 1), ROW_BLOCK):
        blk = tuple(r[lo:lo + ROW_BLOCK] for r in rows)
        outs.append(_coverage_block(tables, queries, lcs, *blk,
                                    config=config))
    return outs[0] if len(outs) == 1 else torch.cat(outs, dim=1)


class GatheredBlock(NamedTuple):
    """One coverage block's inputs gathered per candidate, candidate-minor
    (C last), what the pair, cascade, fake-LCS and fusion kernels read."""

    qc3: torch.Tensor          # int32 [Q, L, C] query chars
    qr3: torch.Tensor          # int32 [Q, L, C] reversed
    qlens2: torch.Tensor       # int32 [Q, C]
    qcount: torch.Tensor       # int32 [C]
    qsorted2: torch.Tensor     # int32 [Q, C]
    fqc3: torch.Tensor         # int32 [FQ, L, C] fusion query chars
    fqr3: torch.Tensor         # int32 [FQ, L, C]
    fqlens2: torch.Tensor      # int32 [FQ, C]
    codes: torch.Tensor        # int32 [D, C] word codes, -1 padded
    tok_count: torch.Tensor    # int32 [C]
    offsets: torch.Tensor      # int32 [D, C]
    adj_ws: torch.Tensor       # bool [D, C]
    text_len: torch.Tensor     # int32 [C]
    chars_t: torch.Tensor      # int32 [L, D, C] doc word chars, 0 if invalid
    chars_rev_t: torch.Tensor  # int32 [L, D, C]
    lens: torch.Tensor         # int32 [D, C], 0 where invalid
    all_valid: torch.Tensor    # bool [D, C]: a word, and below tok_count
    first_char: torch.Tensor   # int32 [D, C], chars_t[0]


def gather_block(tables, queries, text_ids, qsel, L: int, D: int):
    """The coverage block's gather: the rows of the C candidates' queries
    (``qsel``, int64 [C]) and docs (``text_ids``, int64 [C]) from the
    per-query tables ``queries`` (as ``_coverage_block`` takes them) and
    the doc token ``tables``, each doc's first D tokens, the first L of
    each word's chars. Returns a ``GatheredBlock``. CUDA tensors launch the
    kernel (csrc/coverage_gather.cu); CPU tensors take the plain
    version."""
    if text_ids.device.type == "cpu":
        return gather_block_plain(tables, queries, text_ids, qsel, L, D)
    return GatheredBlock(*_kernels.coverage_gather(tables, queries, text_ids,
                                                   qsel, L, D))


def gather_block_plain(tables, queries, text_ids, qsel, L: int, D: int):
    """Plain PyTorch version of ``gather_block`` (same arguments, same
    result, bool for bool), on any device."""
    (word_chars, word_chars_rev, word_lens, doc_tokens, doc_tok_offsets,
     doc_tok_count, doc_adj_ws, doc_text_len) = tables
    (q_chars, q_chars_rev, q_lens, _, _, q_count, q_sorted, fq_chars,
     fq_chars_rev, fq_lens, _, _, _) = queries
    dev = doc_tokens.device

    # Per-candidate query views, C-minor, of what the pair and cascade
    # kernels read (the fusion kernel reads the [B, ...] tables via qsel).
    qc3 = q_chars[qsel].permute(1, 2, 0).contiguous()          # [Q,L,C]
    qr3 = q_chars_rev[qsel].permute(1, 2, 0).contiguous()
    qlens2 = q_lens[qsel].T.contiguous()                       # [Q,C]
    qcount = q_count[qsel]                                     # [C]
    qsorted2 = q_sorted[qsel].T.contiguous()                   # [Q,C]
    fqc3 = fq_chars[qsel].permute(1, 2, 0).contiguous()        # [FQ,L,C]
    fqr3 = fq_chars_rev[qsel].permute(1, 2, 0).contiguous()
    fqlens2 = fq_lens[qsel].T.contiguous()                     # [FQ,C]

    # ---------------- gather doc data ---------------------------------
    codes = doc_tokens[text_ids][:, :D].T.contiguous()          # [D,C]
    tok_count = doc_tok_count[text_ids]                         # [C]
    offsets = doc_tok_offsets[text_ids][:, :D].T.contiguous()   # [D,C]
    adj_ws = doc_adj_ws[text_ids][:, :D].T.contiguous()         # [D,C]
    text_len = doc_text_len[text_ids]                           # [C]
    safe_codes = torch.clamp_min(codes, 0).long()
    chars_t = word_chars[safe_codes][:, :, :L].permute(2, 0, 1)     # [L,D,C]
    chars_rev_t = word_chars_rev[safe_codes][:, :, :L].permute(2, 0, 1)
    lens = torch.where(codes >= 0, word_lens[safe_codes], 0)        # [D,C]

    d_iota = _iota(D, dev)
    all_valid = (codes >= 0) & (d_iota[:, None] < tok_count[None])  # [D,C]
    chars_t = torch.where(all_valid[None], chars_t, 0).contiguous()
    chars_rev_t = torch.where(all_valid[None], chars_rev_t, 0).contiguous()
    lens = torch.where(all_valid, lens, 0)
    first_char = chars_t[0]                          # [D,C]
    return GatheredBlock(qc3, qr3, qlens2, qcount, qsorted2, fqc3, fqr3,
                         fqlens2, codes, tok_count, offsets, adj_ws,
                         text_len, chars_t, chars_rev_t, lens, all_valid,
                         first_char)


def _coverage_block(tables, queries, lcs, text_ids, qsel, lcs_vals,
                    base_scores, *, config: CoverageConfig) -> torch.Tensor:
    (q_chars, _, q_lens, q_idf, q_word_idf, q_count, _, fq_chars,
     fq_chars_rev, fq_lens, fq_count, fq_last_is_alpha, query_len) = queries
    doc_tokens = tables[3]
    text_ids = text_ids.long()
    qsel = qsel.long()
    lcs_vals = lcs_vals.to(_F32)
    base_scores = base_scores.to(_F32)
    L = q_chars.shape[2]
    D = config.d_cap if config.d_cap else doc_tokens.shape[1]

    g = gather_block(tables, queries, text_ids, qsel, L, D)

    # One pair word per (query token, doc token): the six relations, the
    # common-prefix length and the five edit distances, and the relations
    # of the fusion (unfiltered) query tokens; then the matcher cascade
    # over them; then the fake-LCS and the scorer + fusion program. One
    # kernel launch each on the card.
    pairs, fq_pairs = coverage_pair_block(
        (g.qc3, g.qr3, g.qlens2), (g.fqc3, g.fqr3, g.fqlens2), g.chars_t,
        g.chars_rev_t, g.lens, g.all_valid)
    state = coverage_cascade(pairs, g.lens, g.offsets, g.codes, g.first_char,
                             g.tok_count, g.qlens2, g.qsorted2, g.qc3,
                             g.qcount, config)
    if lcs is not None:
        lcs_vals = coverage_lcs(*lcs, text_ids, qsel, g.text_len, lcs_vals)
    doc = (g.chars_t, g.chars_rev_t, g.lens, g.adj_ws, g.all_valid,
           g.tok_count, g.text_len)
    fusion_queries = (q_lens, q_idf, q_word_idf, q_count, fq_chars,
                      fq_chars_rev, fq_lens, fq_count, fq_last_is_alpha,
                      query_len)
    return coverage_fusion(state, pairs, fq_pairs, doc, fusion_queries, qsel,
                           lcs_vals, base_scores, config,
                           packed_lcs=lcs is not None)


# ======================================================================
# The device fake-LCS and the scorer + fusion program: two more
# hand-written kernels on the card (csrc/coverage_lcs.cu,
# csrc/coverage_fusion.cu), each with its plain PyTorch version here.


def coverage_lcs(text_chars, lcs_ok_dev, q_text, q_text_len, q_lcs_tol,
                 q_lcs_ok, text_ids, qsel, text_len, lcs_vals):
    """The device fake-LCS of StringMetrics.cs:12-36 over the FULL
    normalized text, per candidate: len(q) when the query text is contained
    in the doc text, else min(prefix + tol, min(|q|, |r|)) when they share
    a prefix, else 0. Candidates whose doc (``lcs_ok_dev``) or query
    (``q_lcs_ok``) is not eligible keep their host value ``lcs_vals``.

    ``text_chars`` int32 [N, T] (utf-16 code units), ``lcs_ok_dev`` bool
    [N]; ``q_text`` int32 [B, QT], ``q_text_len``, ``q_lcs_tol`` int32 and
    ``q_lcs_ok`` bool [B]; ``text_ids``, ``qsel`` int64, ``text_len`` int32
    and ``lcs_vals`` f32 [C]. Returns f32 [C]. CUDA tensors launch the
    kernel; CPU tensors take the plain version."""
    if text_ids.device.type == "cpu":
        return coverage_lcs_plain(text_chars, lcs_ok_dev, q_text, q_text_len,
                                  q_lcs_tol, q_lcs_ok, text_ids, qsel,
                                  text_len, lcs_vals)
    return _kernels.coverage_lcs(text_chars, lcs_ok_dev, q_text, q_text_len,
                                 q_lcs_tol, q_lcs_ok, text_ids, qsel,
                                 text_len, lcs_vals)


def coverage_lcs_plain(text_chars, lcs_ok_dev, q_text, q_text_len, q_lcs_tol,
                       q_lcs_ok, text_ids, qsel, text_len, lcs_vals):
    """Plain PyTorch version of ``coverage_lcs`` (same arguments, same
    result bit for bit), on any device."""
    dev = text_chars.device
    f32 = _F32
    text_ids = text_ids.long()
    qsel = qsel.long()
    C = text_ids.shape[0]
    txt = text_chars[text_ids].T.to(_I32)                   # [T,C]
    qt = q_text[qsel].T.contiguous()                        # [QT,C]
    qtl = q_text_len[qsel]                                  # [C]
    tol_c = q_lcs_tol[qsel]
    T_CAP = txt.shape[0]
    QT = qt.shape[0]
    qt_iota = _iota(QT, dev)[:, None]
    lim = torch.minimum(qtl, text_len)[None]                # [1,C]
    mism = (qt != txt[:QT]) & (qt_iota < lim)
    any_m = mism.any(dim=0)
    prefix = torch.where(any_m, _first(mism, 0),
                         torch.minimum(qtl, text_len))
    padded_txt = torch.cat(
        [txt, torch.zeros((QT, C), dtype=txt.dtype, device=dev)], dim=0)
    unused = qt_iota >= qtl[None]                           # [QT,C]
    contained = torch.zeros((C,), dtype=torch.bool, device=dev)
    for o in range(T_CAP):
        hit = ((padded_txt[o:o + QT] == qt) | unused).all(dim=0)
        contained = contained | (hit & (o + qtl <= text_len))
    pfx_val = torch.minimum(prefix + tol_c, torch.minimum(qtl, text_len))
    dev_lcs = torch.where(contained, qtl,
                          torch.where(prefix > 0, pfx_val, 0))
    dev_lcs = torch.where((qtl > 0) & (text_len > 0), dev_lcs, 0)
    use_dev = lcs_ok_dev[text_ids] & q_lcs_ok[qsel]
    lcs_vals = torch.where(use_dev, dev_lcs.to(f32), lcs_vals)
    return lcs_vals


def coverage_fusion(state, pairs, fq_pairs, doc, queries, qsel, lcs_vals,
                    base_scores, config, packed_lcs: bool):
    """CoverageScorer, FusionSignalComputer and FusionScorer over one block
    of candidates, and the pack of their result.

    ``state`` is ``coverage_cascade``'s result; ``pairs`` int32 [Q, D, C]
    its pair words (with distances), ``fq_pairs`` int32 [FQ, D, C] those of
    the fusion query tokens (relations only); ``doc`` is ``(chars_t,
    chars_rev_t`` int32 [L, D, C], ``lens`` int32, ``adj_ws``, ``all_valid``
    bool [D, C], ``tok_count``, ``text_len`` int32 [C]``)``; ``queries``
    the ten per-query tables of ``coverage_fusion_batch`` the program reads
    (``q_lens``, ``q_idf``, ``q_word_idf``, ``q_count``, ``fq_chars``,
    ``fq_chars_rev``, ``fq_lens``, ``fq_count``, ``fq_last_is_alpha``,
    ``query_len``; [B, ...]), read through ``qsel`` int64 [C];
    ``lcs_vals``, ``base_scores`` f32 [C].
    Returns f32 ``[2, C]`` (score, tie<<16 | word_hits<<8 | lcs) with
    ``packed_lcs``, else ``[3, C]`` (score, tie, word_hits). CUDA tensors
    launch the kernel; CPU tensors take the plain version."""
    if pairs.device.type == "cpu":
        return coverage_fusion_plain(state, pairs, fq_pairs, doc, queries,
                                     qsel, lcs_vals, base_scores, config,
                                     packed_lcs)
    return _kernels.coverage_fusion(state, pairs, fq_pairs, doc, queries,
                                    qsel, lcs_vals, base_scores, config,
                                    packed_lcs)


def coverage_fusion_plain(state, pairs, fq_pairs, doc, queries, qsel,
                          lcs_vals, base_scores, config, packed_lcs: bool):
    """Plain PyTorch version of ``coverage_fusion`` (same arguments, same
    result bit for bit), on any device."""
    (term_matched, term_has_whole, term_has_joined, term_has_prefix,
     term_first_pos, word_hits, cov_count) = state
    chars_t, chars_rev_t, lens, adj_ws, all_valid, tok_count, text_len = doc
    (q_lens, q_idf, q_word_idf, q_count, fq_chars, fq_chars_rev, fq_lens,
     fq_count, fq_last_is_alpha, query_len) = queries
    dev = pairs.device
    f32 = _F32
    qsel = qsel.long()
    L, D, C = chars_t.shape
    Q = q_lens.shape[1]
    FQ = fq_chars.shape[1]
    qlens2 = q_lens[qsel].T.contiguous()                       # [Q,C]
    qidf2 = q_idf[qsel].T.contiguous()
    qwidf2 = q_word_idf[qsel].T.contiguous()
    qcount = q_count[qsel]                                     # [C]
    fqc3 = fq_chars[qsel].permute(1, 2, 0).contiguous()        # [FQ,L,C]
    fqr3 = fq_chars_rev[qsel].permute(1, 2, 0).contiguous()
    fqlens2 = fq_lens[qsel].T.contiguous()                     # [FQ,C]
    fqcount = fq_count[qsel]                                   # [C]
    fq_alpha = fq_last_is_alpha[qsel]
    qlen_c = query_len[qsel]                                   # [C]
    q_iota = _iota(Q, dev)
    q_valid = q_iota[:, None] < qcount[None]         # [Q,C]
    dam2_q0 = (pairs[0] >> _kernels.PAIR_DIST_SHIFTS[1]) & 7     # [D,C]

    def at_q(arr, qi):
        """arr [Q,C] at per-candidate index qi [C] -> [C] (qi < Q)."""
        return arr.gather(0, qi.long()[None])[0]

    # ================== CoverageScorer =================================
    lcs_eff = lcs_vals if config.cover_whole_query else \
        torch.zeros_like(lcs_vals)
    qlen_f = torch.clamp_min(qlen_c, 1).to(f32)                 # [C]

    tmc = qlens2.to(f32)
    has_term = q_valid & (qlens2 > 0)
    ci = torch.where(has_term,
                     torch.clamp_max(term_matched / torch.clamp_min(tmc, 1.0),
                                     1.0), 0.0)
    sum_ci = _seq_sum(ci)
    terms_with_any = (has_term & (ci > 0)).sum(dim=0)
    idf_h = torch.where(has_term, qidf2, 0.0)
    total_idf = _seq_sum(idf_h)
    idf_weighted = _seq_sum(ci * idf_h)
    missing_idf = _seq_sum(torch.where(has_term & (ci < 1.0),
                                       (1.0 - ci) * qidf2, 0.0))
    last_idx = torch.clamp_min(qcount - 1, 0)                   # [C]
    last_idf = at_q(qidf2, torch.clamp_max(last_idx, Q - 1))

    fully_matched = has_term & (term_matched >= (tmc - 0.01))
    terms_fully = fully_matched.sum(dim=0)
    strict = (term_has_whole | term_has_joined) & fully_matched
    terms_strict = strict.sum(dim=0)
    terms_prefix = (term_has_prefix & has_term).sum(dim=0)

    pos_valid = (term_first_pos >= 0) & has_term
    big_pos = 2 ** 30
    min_pos = torch.where(pos_valid, term_first_pos, big_pos).amin(dim=0)
    has_any_pos = pos_valid.any(dim=0)
    first_match_index = torch.where(has_any_pos, min_pos, -1)

    idf_coverage = torch.where(total_idf > 0, idf_weighted / total_idf, 0.0)
    type_ahead = (qcount > 0) & (total_idf > 0) & \
        ((last_idf / torch.clamp_min(total_idf, 1e-30))
         <= _rdiv(1.0, (qcount + 1).to(f32)))

    single_lcs_ci = torch.clamp_max(lcs_eff / qlen_f, 1.0)
    sum_ci = torch.where((qcount == 1) & (qlen_c > 0) & (lcs_eff > 0)
                         & (single_lcs_ci > sum_ci), single_lcs_ci, sum_ci)

    prefix_hit = term_has_prefix & has_term & (term_matched > 0)

    run = torch.zeros((C,), dtype=_I32, device=dev)
    longest_run = torch.zeros((C,), dtype=_I32, device=dev)
    for i in range(Q):
        hit = prefix_hit[i] & (i < qcount)
        run = torch.where(hit, run + 1, 0)
        longest_run = torch.maximum(longest_run, run)

    suffix_run = torch.zeros((C,), dtype=_I32, device=dev)
    still = torch.ones((C,), dtype=torch.bool, device=dev)
    for k in range(Q):
        i = torch.clamp(qcount - 1 - k, 0, Q - 1)
        hit = at_q(prefix_hit, i)
        in_range = k < qcount
        cont = still & hit & in_range
        suffix_run = suffix_run + cont
        still = torch.where(in_range, cont, still)

    last_token_has_prefix = at_q(prefix_hit, torch.clamp_max(last_idx, Q - 1)) \
        & (qcount >= 1)
    preceding_strict = (strict & (q_iota[:, None] < (qcount - 1)[None, :])
                        ).sum(dim=0)
    preceding_strict = torch.where(qcount >= 2, preceding_strict, 0)

    # ================== FusionSignalComputer ===========================
    sig = _fusion_signals(
        fqc3, fqr3, fqlens2, fqcount, fq_alpha, fq_pairs,
        dam2_q0, chars_t, chars_rev_t, lens, adj_ws, all_valid,
        tok_count, C, D, L, FQ, config)
    sig["_fq_count"] = fqcount

    # ================== FusionScorer ===================================
    score, tiebreaker = _fusion_score_impl(
        C, qcount, qlen_c, text_len,
        terms_with_any, terms_fully, terms_strict, terms_prefix,
        first_match_index, sum_ci, word_hits, cov_count,
        longest_run, suffix_run, preceding_strict, last_token_has_prefix,
        type_ahead, idf_coverage, total_idf, missing_idf,
        qwidf2, ci, has_term, sig, base_scores)

    if packed_lcs:
        meta = (tiebreaker.to(_I32) * 65536
                + torch.clamp(word_hits, 0, 255).to(_I32) * 256
                + torch.clamp(lcs_vals, 0, 255).to(_I32))
        return torch.stack([score, meta.to(f32)])
    return torch.stack([score, tiebreaker.to(f32), word_hits.to(f32)])


def _fusion_signals(fq_chars, fq_chars_rev, fq_lens, fq_count,
                    fq_last_is_alpha, fq_pairs, dam2_q0, chars_t,
                    chars_rev_t, lens, adj_ws, all_valid, tok_count,
                    C, D, L, FQ, config):
    """FusionSignalComputer.ComputeSignals, batched over candidates.

    fq_chars/fq_chars_rev [FQ,L,C]; fq_lens [FQ,C]; fq_count [C];
    fq_last_is_alpha [C]; fq_pairs [FQ,D,C] the relations-only pair words
    of the fusion query tokens; dam2_q0 [D,C]; doc tensors C-minor.
    """
    dev = chars_t.device
    f32 = _F32
    fq_iota = _iota(FQ, dev)
    d_iota = _iota(D, dev)
    fq_valid_vec = fq_iota[:, None] < fq_count[None, :]         # [FQ,C]
    have = (fq_count > 0) & (tok_count > 0)

    (F_EQ, F_D_SW_Q, _F_D_EW_Q, _F_Q_EW_D, F_CONT, F_Q_SW_D,
     F_CP) = unpack_relations(fq_pairs)

    last_idx = torch.clamp_min(fq_count - 1, 0)                 # [C]
    last_oh2 = fq_iota[:, None] == last_idx[None, :]            # [FQ,C]
    last_oh3 = last_oh2[:, None, :]                             # [FQ,1,C]
    last_len = torch.where(last_oh2, fq_lens, 0).sum(dim=0)

    # --- 1. CheckPrefixLastMatch ---------------------------------------
    sw0 = F_D_SW_Q[0]                               # [D,C]
    any_sw0 = sw0.any(dim=0)
    j0 = _first(sw0, 0)
    exact0 = (F_EQ[0] & (d_iota[:, None] == j0[None, :])).any(dim=0)
    single_lpl = any_sw0
    single_ape = any_sw0 & exact0

    eq_any = F_EQ.any(dim=1)                        # [FQ,C]
    is_prec = fq_iota[:, None] < (fq_count - 1)[None, :]
    all_prec = (eq_any | ~is_prec).all(dim=0)
    last_sw = (F_D_SW_Q & last_oh3).any(dim=1).any(dim=0)
    multi_lpl = all_prec & last_sw
    lexical_prefix_last = torch.where(fq_count == 1, single_lpl,
                                      multi_lpl) & have
    all_preceding_exact = torch.where(
        fq_count == 1, single_ape, multi_lpl) & have

    # --- 2. PerfectDoc -------------------------------------------------
    explained = ((F_D_SW_Q | F_Q_SW_D) & fq_valid_vec[:, None, :]
                 ).any(dim=0)                       # [D,C]
    perfect = (explained | ~all_valid).all(dim=0) & have

    # --- 3. StemEvidence (fq_count >= 2) -------------------------------
    min_stem = config.min_word_size
    considered = fq_valid_vec & (fq_lens >= min_stem)
    word_match = (F_EQ | F_D_SW_Q).any(dim=1)       # [FQ,C]
    unmatched = considered & ~word_match
    ev_tok = all_valid[None] & (lens[None] >= min_stem) & \
        (F_Q_SW_D | (F_CP >= min_stem))
    evidence = ev_tok.any(dim=1)                    # [FQ,C]
    unmatched_cnt = unmatched.sum(dim=0)
    evidence_cnt = (unmatched & evidence).sum(dim=0)
    stem_evidence = (fq_count >= 2) & (unmatched_cnt > 0) & \
        (evidence_cnt == unmatched_cnt) & have

    # --- 4. AnchorStem -------------------------------------------------
    first_len = fq_lens[0]                          # [C]
    stem_ok = (fq_count > 0) & (first_len >= ANCHOR_STEM_LENGTH)
    stem_len = ANCHOR_STEM_LENGTH
    l3 = _iota(L, dev)[:, None, None]                             # [L,1,1]
    ch_eq = (chars_t == fq_chars[0][:, None, :]) | (l3 >= stem_len)
    d_sw_stem = all_valid & (lens >= stem_len) & ch_eq.all(dim=0)  # [D,C]
    first_tok_match = d_sw_stem[0] & (tok_count > 0)
    first_tok_long_enough = (tok_count > 0) & (lens[0] >= stem_len)
    rest_match = (d_sw_stem & (d_iota[:, None] >= 1)).any(dim=0)
    anchor = torch.where(
        first_tok_long_enough, first_tok_match | rest_match,
        ~(tok_count > 0) & d_sw_stem.any(dim=0))
    has_anchor_stem = stem_ok & anchor & have

    # --- 5. TrailingMatchDensity ---------------------------------------
    trail_on = (fq_count >= 2) & (last_len >= 1) & \
        (last_len <= MAX_TRAILING_LEN)
    d_sw_last = (F_D_SW_Q & last_oh3).any(dim=0)                # [D,C]
    cont_last = (F_CONT & last_oh3).any(dim=0)
    matchable = (d_sw_last |
                 ((lens > last_len[None, :]) & cont_last)) & all_valid
    m_count = matchable.sum(dim=0)
    density = m_count.to(f32) / torch.clamp_min(tok_count, 1).to(f32)
    trailing_density = torch.where(
        trail_on & (m_count > 0),
        torch.clamp(density * 255.0, 0.0, 255.0).to(_I32), 0)

    # --- 6. SingleTermLexicalSim ----------------------------------------
    # When fq_count == 1 (the only case this signal is used) the single
    # fusion token equals coverage token 0, so dam2[0] is its Damerau.
    sim = _single_term_lexical_sim(
        fq_chars[0], fq_chars_rev[0], fq_lens[0], dam2_q0,
        chars_t, chars_rev_t, lens, all_valid, C, D, L)
    single_sim = torch.where(
        (fq_count == 1) & have,
        torch.clamp(sim * 255.0, 0.0, 255.0).to(_I32), 0)

    # --- 7. SingleCharLastTokenBoost -----------------------------------
    boost = _single_char_last_boost(
        fq_lens, fq_count, fq_last_is_alpha, fq_chars,
        chars_t[0], lens, adj_ws, all_valid, F_CONT, C, D, FQ, d_iota)
    boost = torch.where((fq_count >= 2) & have, boost, 0)

    return dict(
        lexical_prefix_last=lexical_prefix_last,
        all_preceding_exact=all_preceding_exact,
        is_perfect_doc=perfect,
        has_stem_evidence=stem_evidence,
        has_anchor_stem=has_anchor_stem,
        trailing_density=trailing_density,
        single_sim=single_sim,
        single_char_boost=boost,
    )


def _single_term_lexical_sim(q_chars, q_rev, q_len, dam2_q0,
                             chars_t, chars_rev_t, lens, all_valid, C, D, L):
    """ComputeSingleTermLexicalSimilarity, batched (C-minor layout).

    Per-candidate query: q_chars/q_rev [L,C], q_len [C]; dam2_q0 [D,C].
    """
    dev = chars_t.device
    f32 = _F32
    qlen_f = torch.clamp_min(q_len, 1).to(f32)[None, :]        # [1,C]
    ok = q_len >= 3                                           # [C]
    tok_ok = all_valid & (lens >= 2)
    l3 = _iota(L, dev)[:, None, None]                         # [L,1,1]
    dl3 = lens[None]                                          # [1,D,C]

    # substring + prefix-suffix share ONE slide over window shifts of the
    # zero-padded [2L,C] query rows
    q_padded = torch.cat([q_chars, torch.zeros_like(q_chars)], dim=0)
    found_idx = torch.full((D, C), -1, dtype=_I32, device=dev)
    best_k = torch.zeros((D, C), dtype=_I32, device=dev)
    for sw in range(L):
        q_sh = q_padded[sw:sw + L][:, None, :]                # [L,1,C]
        aligned_eq = q_sh == chars_t                          # [L,D,C]
        hit = (aligned_eq | (l3 >= dl3)).all(dim=0) & \
            (sw + lens <= q_len[None, :])
        found_idx = torch.where((found_idx < 0) & hit, sw, found_idx)
        mism = ~aligned_eq
        run = torch.where(mism.any(dim=0), _first(mism, 0), L)
        k = q_len[None, :] - sw                               # [1,C]
        ps_match = (k >= 2) & (k <= torch.minimum(q_len[None, :], lens)) & \
            (run >= k)
        best_k = torch.maximum(best_k, torch.where(ps_match, k, 0))
    sub_hit = found_idx >= 0
    len_frac = lens.to(f32) / qlen_f
    pos_factor = 1.0 - found_idx.to(f32) / qlen_f
    sub_score = torch.where(sub_hit & tok_ok, len_frac * pos_factor, 0.0)
    ps_score = torch.where(tok_ok, best_k.to(f32) / qlen_f, 0.0)

    dist = dam2_q0
    fz_score = torch.where(tok_ok & (dist <= 2),
                           (q_len[None, :] - dist).to(f32) / qlen_f, 0.0)

    best = torch.where(sub_hit & tok_ok, sub_score,
                       torch.maximum(ps_score, fz_score)).amax(dim=0)
    best = torch.clamp_min(best, 0.0)

    # two-segment heuristic
    MIN_SEG = 3
    two_ok = q_len >= 2 * MIN_SEG                              # [C]
    seg_len = torch.clamp_max(q_len // 2, 2 * MIN_SEG)         # [C]
    seg3 = seg_len[None, None, :]                              # [1,1,C]
    tok3 = all_valid & (lens >= 3)
    pre_match = tok3 & (((q_chars[:, None, :] == chars_t) |
                         (l3 >= torch.minimum(seg3, dl3))).all(dim=0))
    m3 = torch.minimum(seg3, dl3)                              # [1,D,C]
    suf_match = tok3 & (((q_rev[:, None, :] == chars_rev_t) |
                         (l3 >= m3)).all(dim=0))

    any_pre = pre_match.any(dim=0)
    pre_i = _first(pre_match, 0)
    any_suf = suf_match.any(dim=0)
    suf_i = _first(suf_match, 0)
    two_seg_hit = two_ok & any_pre & any_suf & (pre_i != suf_i)
    two_seg_score = torch.clamp_max((2 * seg_len).to(f32) / qlen_f[0], 1.0)
    best = torch.where(two_seg_hit & (two_seg_score > best), two_seg_score,
                       best)
    return torch.where(ok, best, 0.0)


def _single_char_last_boost(fq_lens, fq_count, fq_last_is_alpha, fq_chars,
                            first_char, lens, adj_ws, all_valid,
                            F_CONT, C, D, FQ, d_iota):
    """ComputeSingleCharLastTokenMatch, batched sequential walk.

    fq_lens [FQ,C], fq_count [C], fq_chars [FQ,L,C]; doc tensors C-minor.
    """
    dev = first_char.device
    fq_iota = _iota(FQ, dev)
    last_idx = torch.clamp_min(fq_count - 1, 0)                # [C]
    last_oh = fq_iota[:, None] == last_idx[None, :]            # [FQ,C]
    last_len_is_1 = torch.where(last_oh, fq_lens, 0).sum(dim=0) == 1
    target = torch.where(last_oh, fq_chars[:, 0, :], 0).sum(dim=0)  # [C]
    enabled = last_len_is_1 & fq_last_is_alpha

    d_index = torch.zeros((C,), dtype=_I32, device=dev)
    first_match = torch.full((C,), -1, dtype=_I32, device=dev)
    alive = torch.ones((C,), dtype=torch.bool, device=dev)
    for i in range(max(FQ - 1, 0)):
        is_prec = i < fq_count - 1
        eligible = F_CONT[i] & (d_iota[:, None] >= d_index[None, :])
        found = eligible.any(dim=0)
        j = _first(eligible, 0)
        step_on = alive & is_prec
        first_match = torch.where(step_on & found & (first_match == -1),
                                  j, first_match)
        d_index = torch.where(step_on & found, j, d_index)
        alive = torch.where(step_on, alive & found, alive)

    nxt = d_index + 1
    nxt_oh = d_iota[:, None] == torch.clamp_max(nxt, D - 1)[None, :]  # [D,C]
    nxt_valid = (all_valid & nxt_oh).any(dim=0) & (nxt < D)
    nxt_first = torch.where(nxt_oh, first_char, 0).sum(dim=0)
    nxt_len = torch.where(nxt_oh, lens, 0).sum(dim=0)
    adj = (adj_ws & (d_iota[:, None] == d_index[None, :])).any(dim=0)

    hit = enabled & alive & nxt_valid & (nxt_first == target) & adj
    boost = 8 + torch.clamp_min(16 - first_match, 0)
    boost = boost + torch.where(nxt_len == 1, 4, 0)
    return torch.where(hit, boost, 0)


def _fusion_score_impl(C, q_count, query_len, text_len,
                       terms_with_any, terms_fully, terms_strict,
                       terms_prefix, first_match_index, sum_ci, word_hits,
                       doc_token_count, longest_run, suffix_run,
                       preceding_strict, last_token_has_prefix,
                       type_ahead, idf_coverage, total_idf, missing_idf,
                       q_word_idf, ci, has_term, sig, base_scores):
    # Per-candidate shapes: q_count/query_len/text_len [C],
    # q_word_idf/ci/has_term [Q,C] (gathered via qsel).
    f32 = _F32
    fq_count = sig["_fq_count"]
    n = torch.where(fq_count > 0, fq_count, q_count)
    is_single = n <= 1

    tc = q_count
    tc_f = torch.clamp_min(tc, 1).to(f32)
    is_complete = (tc > 0) & (terms_with_any == tc)
    is_clean = (tc > 0) & (terms_prefix == tc)
    is_exact = (tc > 0) & (terms_strict == tc)
    starts_at_beginning = first_match_index == 0
    lpl = sig["lexical_prefix_last"]
    preceding_terms = torch.clamp_min(tc - 1, 0)
    coverage_prefix_last = (tc >= 1) & \
        (preceding_strict == preceding_terms) & last_token_has_prefix
    prefix_last_strong = lpl & coverage_prefix_last
    perfect_doc = sig["is_perfect_doc"]

    precedence = torch.zeros((C,), dtype=torch.int64, device=tc.device)

    matched = terms_with_any
    coverage_tier = torch.where(
        matched >= tc, 3,
        torch.where(matched == tc - 1, 2,
                    torch.where(matched * 2 >= tc, 1, 0)))
    coverage_tier = torch.where(~is_single & (tc > 0), coverage_tier, 0)
    precedence = precedence | torch.where(
        ~is_single & (coverage_tier > 0), (coverage_tier & 0b11) << 16, 0)

    exact_prefix = ~is_single & is_clean & starts_at_beginning & lpl & \
        is_complete
    subset_match = ~is_single & (doc_token_count > 0) & \
        (word_hits == doc_token_count)
    precedence = precedence | torch.where(exact_prefix, 1 << 15, 0)
    precedence = precedence | torch.where(subset_match, 1 << 14, 0)

    avg_idf = torch.where((total_idf > 0) & (tc > 0), total_idf / tc_f, 0.0)
    power = q_word_idf * ci                                     # [Q,C]
    total_power = _seq_sum(torch.where(has_term, power, 0.0))
    cand_ok = has_term & (ci > 0.1) & (q_word_idf > 0.0) & \
        (q_word_idf >= avg_idf[None, :])
    others = total_power[None, :] - power
    dominance_on = ~is_single & (tc >= 2)
    dominant = (cand_ok & (power >= others)).any(dim=0) & dominance_on
    strong_anchor = sig["has_anchor_stem"] & \
        (q_word_idf[0] >= avg_idf) & dominance_on
    precedence = precedence | torch.where(dominant | strong_anchor,
                                          1 << 13, 0)
    unmatched_terms = tc - terms_with_any
    precedence = precedence | torch.where(
        dominant & (unmatched_terms == 1), 8, 0)

    st_tier = torch.where(
        is_complete,
        torch.where(starts_at_beginning,
                    torch.where(is_exact, 4, torch.where(is_clean, 3, 0)),
                    torch.where(is_exact, 2, torch.where(is_clean, 1, 0))),
        0)
    single_prec = torch.where(is_complete, 1 << 17, 0) | \
        torch.where(is_clean & (tc > 0), 1 << 16, 0) | (st_tier << 3)

    anchor_run = sig["has_anchor_stem"] & (longest_run >= 2)
    mt_tier = torch.where(
        prefix_last_strong, 3,
        torch.where(lpl, 2, torch.where(perfect_doc | anchor_run, 1, 0)))
    mt_prec = mt_tier + torch.where(fq_count > tc, sig["single_char_boost"],
                                    0)

    precedence = precedence | torch.where(is_single, single_prec, mt_prec)

    coverage_ratio = torch.where(tc > 0, terms_with_any.to(f32) / tc_f, 0.0)
    has_partial = (coverage_ratio > 0.0) & (coverage_ratio < 1.0)

    last_matched = last_token_has_prefix | ((tc > 0) & (terms_with_any == tc))
    can_boost = (last_matched | ~type_ahead) & (total_idf > 0)
    missing_ratio = missing_idf / torch.clamp_min(total_idf, 1e-30)
    term_gap = 1.0 - coverage_ratio
    info_boost = (unmatched_terms == 1) & can_boost & \
        (missing_ratio < term_gap)
    boost_bit = sig["has_stem_evidence"] | info_boost
    precedence = precedence | torch.where(
        has_partial & (n >= 2) & boost_bit, 8, 0)

    avg_ci = torch.where(tc > 0, sum_ci / tc_f, 0.0)
    lexical_sim = _div(sig["single_sim"].to(f32), 255.0)
    sem_single = (avg_ci + lexical_sim) / 2.0

    use_idf_cov = has_partial & (unmatched_terms == 1) & can_boost & \
        (idf_coverage > coverage_ratio)
    base_cov = torch.where(use_idf_cov, idf_coverage, avg_ci)
    density = word_hits.to(f32) / torch.clamp_min(doc_token_count, 1).to(f32)
    sem_multi = base_cov * density
    signals = (sig["has_anchor_stem"].to(_I32) + (suffix_run >= 2).to(_I32))
    sem_multi = torch.where(
        (tc >= 3) & (signals > 0),
        torch.clamp_max(sem_multi + INTENT_BONUS_PER_SIGNAL *
                        signals.to(f32), 1.0),
        sem_multi)
    t_density = _div(sig["trailing_density"].to(f32), 255.0)
    sem_multi = torch.where(
        (tc >= 2) & (t_density > 0.0),
        sem_multi + (1.0 - sem_multi) * t_density, sem_multi)

    semantic = torch.where(
        is_single, sem_single,
        torch.where(doc_token_count == 0, avg_ci, sem_multi))

    coverage_gap = 1.0 - coverage_ratio
    semantic = torch.where(
        has_partial & (base_scores >= coverage_gap),
        coverage_ratio * semantic + coverage_gap * base_scores, semantic)
    semantic = torch.clamp(semantic, 0.0, 0.999)

    focus = torch.clamp_max(
        query_len.to(f32) / torch.clamp_min(text_len, 1).to(f32), 1.0)
    tiebreaker = torch.where((n >= 2) & (text_len > 0),
                             (focus * 255.0).to(_I32), 0)

    return precedence.to(f32) + semantic, tiebreaker
