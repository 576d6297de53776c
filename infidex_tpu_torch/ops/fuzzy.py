"""Char-bigram signature matching for fuzzy (LD1) term expansion (PyTorch).

Port of ``infidex_tpu/ops/fuzzy.py``, which vocabularies of at least
``VectorModel.SIGNATURE_VOCAB_THRESHOLD`` terms use instead of the host
symmetric-delete dictionary. Each vocabulary term gets a 128-bit
character-bigram signature; an unknown query token is matched against the
whole vocabulary on the device, and the short list is verified exactly on
the host.

Correctness invariant (no false negatives): if damerau_lev(q, t) <= 1
then at most 3 distinct bigrams leave q's bigram set, and hashing can only
merge bits, so ``popcount(sig_q & sig_t) >= popcount(sig_q) - 3`` (and
symmetrically for t). Terms failing this bound, or with
``|len(q)-len(t)| > 1``, cannot be Damerau-LD1 matches and are dropped
before the exact verify.

Layout. The reference keeps the signatures as an int8 [128, V_pad] matrix
for its matrix-unit product; the port packs each signature into 4 int32
words (bit b is bit b % 32 of word b // 32), an int32 [V_pad, 4] tensor,
and counts common bits with popcounts. ``vpop``, ``vlen`` and ``elig`` are
the reference's, per vocabulary slot. The match itself (``match``) is the
hand-written CUDA kernel ``csrc/fuzzy_match.cu`` for CUDA tensors and
``match_plain`` for CPU tensors; both return the ``cap`` lowest passing
ids per token row, ascending, padded with V_pad.
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np
import torch

from .. import runtime
from . import _kernels
from .coverage_kernel import _upload

#: signature width in bits
SIG_BITS = 128
#: device short-list per token (lowest term ids among filter passers)
SHORTLIST = 8192
#: final cap after exact verification (FstIndex traversal cap)
MATCH_CAP = 1024
#: token rows per block of ``match_plain`` (bounds its [rows, V]
#: intermediates: ~8 int64 tensors of rows x V_pad)
PLAIN_ROWS = 8


def _bigram_bits(text: str) -> np.ndarray:
    """Indices of the set bits of a string's hashed-bigram signature."""
    if len(text) < 2:
        return np.zeros(0, dtype=np.int64)
    codes = np.frombuffer(text.encode("utf-32-le", "surrogatepass"),
                          dtype=np.uint32).astype(np.int64)
    h = (codes[:-1] * 131 + codes[1:]) % SIG_BITS
    return np.unique(h)


def _signature_row(text: str) -> np.ndarray:
    row = np.zeros(SIG_BITS, dtype=np.int8)
    row[_bigram_bits(text)] = 1
    return row


def pack_signatures(sig: np.ndarray) -> np.ndarray:
    """[n, 128] 0/1 signatures -> int32 [n, 4] words (bit b of a
    signature is bit b % 32 of word b // 32)."""
    bits = np.packbits(np.asarray(sig, np.uint8), axis=1, bitorder="little")
    return np.ascontiguousarray(bits).view("<u4").view(np.int32)


def _popcount32(x: torch.Tensor) -> torch.Tensor:
    """Set bits of each int64 element holding a 32-bit value."""
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return ((x * 0x01010101) & 0xFFFFFFFF) >> 24


def match_plain(sig, vpop, vlen, elig, qsig, qpop, qlen,
                cap: int) -> torch.Tensor:
    """Plain PyTorch version of ``match`` (same arguments and result):
    exact popcounts of the packed words, the reference's pass mask, and
    each row's first ``cap`` passers ranked by a running count, in blocks
    of PLAIN_ROWS token rows."""
    dev = sig.device
    v_pad, n_rows = sig.shape[0], qsig.shape[0]
    out = torch.full((n_rows, cap), v_pad, dtype=torch.int32, device=dev)
    words = sig.to(torch.int64) & 0xFFFFFFFF
    vpop, vlen = vpop.to(torch.int64), vlen.to(torch.int64)
    for lo in range(0, n_rows, PLAIN_ROWS):
        hi = min(lo + PLAIN_ROWS, n_rows)
        q = qsig[lo:hi].to(torch.int64) & 0xFFFFFFFF
        common = sum(_popcount32(q[:, w, None] & words[None, :, w])
                     for w in range(4))
        qp = qpop[lo:hi, None].to(torch.int64)
        ql = qlen[lo:hi, None].to(torch.int64)
        ok = ((common >= qp - 3) & (common >= vpop[None, :] - 3)
              & ((vlen[None, :] - ql).abs() <= 1) & elig[None, :])
        rank = torch.cumsum(ok, dim=1) - 1
        r, v = torch.nonzero(ok & (rank < cap), as_tuple=True)
        out[lo + r, rank[r, v]] = v.to(torch.int32)
    return out


def match(sig, vpop, vlen, elig, qsig, qpop, qlen, cap: int) -> torch.Tensor:
    """int32 [T, cap]: per token row, the ``cap`` lowest eligible term ids
    that pass the signature and length prefilters, ascending, padded with
    V_pad = ``sig.shape[0]``. CUDA tensors launch ``csrc/fuzzy_match.cu``;
    CPU tensors take ``match_plain``."""
    if sig.device.type == "cpu":
        return match_plain(sig, vpop, vlen, elig, qsig, qpop, qlen, cap)
    return _kernels.fuzzy_match(sig, vpop, vlen, elig, qsig, qpop, qlen, cap)


def _ext_bucket(n: int) -> int:
    for b in (16, 64, 256, 1024, 4096):
        if n <= b:
            return b
    return n


def _extend_update(sig, vpop, vlen, elig, new_sig, new_pop, new_len,
                   new_elig, off_ids, start: int, flip: bool) -> None:
    """In-place counterpart of the reference's donated update: the
    eligibility flips first (``off_ids`` may repeat an id), then the rows
    ``start..`` of every table. Blocking copies on the current stream; the
    caller holds the engine's write lock."""
    if flip:
        off = torch.from_numpy(off_ids.astype(np.int64)).to(elig.device)
        elig[off] = False
    for table, rows in ((sig, new_sig), (vpop, new_pop), (vlen, new_len),
                        (elig, new_elig)):
        table[start:start + rows.shape[0]].copy_(torch.from_numpy(rows))


class NGramSignatureIndex:
    """Device-resident packed signatures over the vocabulary.

    Built once per ``BuiltIndex`` image (invalidated together with the
    host LD1 dictionary, extended in place by append-only finalizes);
    ``match_batch`` resolves any number of unknown tokens with a single
    device round trip.
    """

    #: vocab-axis headroom beyond the next 128 multiple: append-only
    #: finalizes extend the tables in place
    APPEND_SLACK = 16384

    def __init__(self, terms: Sequence[str], df: np.ndarray, min_len: int = 3,
                 device=None):
        v = len(terms)
        self.v = v
        self.min_len = min_len
        v_pad = max(128, -(-(v + self.APPEND_SLACK) // 128) * 128)
        sig = np.zeros((v_pad, SIG_BITS), dtype=np.int8)
        lens = np.zeros(v_pad, dtype=np.int32)
        elig = np.zeros(v_pad, dtype=bool)
        for tid, term in enumerate(terms):
            if len(term) < min_len or df[tid] <= 0:
                continue
            elig[tid] = True
            lens[tid] = len(term)
            sig[tid, _bigram_bits(term)] = 1
        self._load(pack_signatures(sig), sig.sum(axis=1, dtype=np.int32),
                   lens, elig, terms, device)

    @classmethod
    def from_state(cls, sig, vpop, vlen, elig, v: int, terms,
                   min_len: int = 3, device=None) -> "NGramSignatureIndex":
        """An index over given state (numpy): packed int32 [V_pad, 4]
        signatures, ``vpop``/``vlen`` int32 and ``elig`` bool [V_pad], the
        logical vocabulary size ``v`` (see ``infidex_tpu_torch.convert``)."""
        self = cls.__new__(cls)
        self.v = int(v)
        self.min_len = min_len
        self._load(sig, vpop, vlen, elig, terms, device)
        return self

    def _load(self, sig, vpop, vlen, elig, terms, device) -> None:
        dev = torch.device(device) if device is not None else runtime.device()
        self._sig = _upload(np.asarray(sig, np.int32), dev)
        self._vpop = _upload(np.asarray(vpop, np.int32), dev)
        self._vlen = _upload(np.asarray(vlen, np.int32), dev)
        self._elig = _upload(np.asarray(elig, bool), dev)
        self._terms = terms

    @property
    def v_pad(self) -> int:
        """Vocabulary slots (live terms plus headroom): the pad id."""
        return int(self._sig.shape[0])

    def extend_append(self, terms: Sequence[str], df: np.ndarray,
                      new_start: int, off_tids=()) -> bool:
        """Extend in place after an append-only finalize: signature rows
        for terms ``new_start..`` plus eligibility flips for ``off_tids``
        (terms that became stop terms). Existing terms' signatures and
        lengths never change (the string is the key), and a growing df
        cannot flip an eligible term off — so this produces the state of a
        fresh build without its O(vocab) Python loop. Returns False on
        capacity overflow (the caller rebuilds)."""
        k = len(terms) - self.v
        if k < 0 or new_start != self.v:
            return False
        if k == 0 and not off_tids:
            self._terms = terms
            return True
        k_pad = _ext_bucket(max(k, 1))
        if self.v + k_pad > self.v_pad:
            return False
        sig = np.zeros((k_pad, SIG_BITS), dtype=np.int8)
        lens = np.zeros(k_pad, dtype=np.int32)
        elig = np.zeros(k_pad, dtype=bool)
        for i in range(k):
            term = terms[self.v + i]
            if len(term) < self.min_len or df[self.v + i] <= 0:
                continue
            elig[i] = True
            lens[i] = len(term)
            sig[i, _bigram_bits(term)] = 1
        off = np.asarray(list(off_tids) or [self.v], np.int32)
        off_pad = np.full(_ext_bucket(off.size), off[0], np.int32)
        off_pad[: off.size] = off
        # a padded off entry repeats a real one (idempotent flip); with
        # no flips nothing is flipped
        _extend_update(self._sig, self._vpop, self._vlen, self._elig,
                       pack_signatures(sig), sig.sum(axis=1, dtype=np.int32),
                       lens, elig, off_pad, self.v, bool(off_tids))
        self.v += k
        self._terms = terms
        return True

    def match_args(self, tokens: List[str]) -> tuple:
        """``match``'s arguments for ``tokens``: the vocabulary tables, the
        token rows (padded to a multiple of 8 with empty pad rows) and
        ``cap``."""
        t_pad = max(8, -(-len(tokens) // 8) * 8)
        qsig = np.zeros((t_pad, SIG_BITS), dtype=np.int8)
        qlen = np.zeros(t_pad, dtype=np.int32)
        for i, tok in enumerate(tokens):
            qsig[i] = _signature_row(tok)
            qlen[i] = len(tok)
        qpop = qsig.sum(axis=1, dtype=np.int32)
        dev = self._sig.device
        return (self._sig, self._vpop, self._vlen, self._elig,
                _upload(pack_signatures(qsig), dev), _upload(qpop, dev),
                _upload(qlen, dev), min(SHORTLIST, self.v_pad))

    def candidates_batch(self, tokens: List[str]) -> List[np.ndarray]:
        """Signature-filtered candidate term ids per token (unverified)."""
        if not tokens:
            return []
        out = match(*self.match_args(tokens)).cpu().numpy()
        # ids past the live vocabulary (headroom slots, the V_pad pad)
        # are dropped here, as in the reference
        return [out[i][out[i] < self.v].astype(np.int64)
                for i in range(len(tokens))]

    def match_batch(self, tokens: List[str],
                    verify) -> List[np.ndarray]:
        """Exact LD1 matches per token: device prefilter + host verify.

        ``verify(token, term) -> bool`` applies the exact edit-distance
        predicate (plain Levenshtein <= 1 in the reference semantics).
        """
        cand_lists = self.candidates_batch(tokens)
        results = []
        for tok, cands in zip(tokens, cand_lists):
            matched = [int(tid) for tid in cands
                       if verify(tok, self._terms[int(tid)])]
            results.append(np.asarray(sorted(matched)[:MATCH_CAP],
                                      dtype=np.int64))
        return results
