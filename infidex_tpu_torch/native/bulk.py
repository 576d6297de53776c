"""ctypes wrapper for the native bulk index builder (_lib.cpp).

One pass over UTF-32 document blobs produces: the term dictionary in
first-seen order, CSR postings with the exact increment_usage /
first_cycle_add accumulation semantics of index/builder.py, the
WordMatcher exact/LD1/affix maps, and the positional prefix index —
replacing ~15 Python dict operations per token (the reference builds its
inverted lists with Parallel.For over C# dictionaries,
VectorModel.cs:130-220).
"""

from __future__ import annotations

import ctypes
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from . import _lib, available

_BULK_BOUND = False


def _bind() -> bool:
    global _BULK_BOUND
    if _BULK_BOUND:
        return True
    if not available or _lib is None:
        return False
    c = ctypes
    u32p, i64p, i32p, u8p, f32p = (
        c.POINTER(c.c_uint32), c.POINTER(c.c_int64), c.POINTER(c.c_int32),
        c.POINTER(c.c_uint8), c.POINTER(c.c_float))
    try:
        sigs = {
            "infidex_cov_build": ([u32p, i64p, c.c_int64, u32p, c.c_int32,
                                   c.c_int32, c.c_int32], c.c_void_p),
            "infidex_cov_num_words": ([c.c_void_p], c.c_int64),
            "infidex_cov_copy": ([c.c_void_p, i32p, i32p, i32p, i32p, i32p,
                                  i32p, u8p, i32p, u8p, i32p], None),
            "infidex_cov_free": ([c.c_void_p], None),
            "infidex_wordstats_build": ([u32p, i64p, c.c_int64, u32p,
                                         c.c_int32, u8p], c.c_void_p),
            "infidex_wordstats_num": ([c.c_void_p], c.c_int64),
            "infidex_wordstats_blob_len": ([c.c_void_p], c.c_int64),
            "infidex_wordstats_copy": ([c.c_void_p, u32p, i64p, i64p], None),
            "infidex_wordstats_free": ([c.c_void_p], None),
            "infidex_bulk_create": ([i32p, c.c_int32, c.c_int32, c.c_int32,
                                     u32p, c.c_int32, c.c_int32, c.c_int64,
                                     f32p, c.c_int32,
                                     c.c_int32, c.c_int32, c.c_int32,
                                     c.c_int32, c.c_int32, c.c_int32,
                                     c.c_int32, c.c_int32, c.c_int32,
                                     c.c_int32], c.c_void_p),
            "infidex_bulk_free": ([c.c_void_p], None),
            "infidex_bulk_add": ([c.c_void_p, u32p, i64p, u32p, i64p, u32p,
                                  i64p, i32p, u8p, c.c_int32, i32p, i32p,
                                  i64p], None),
            "infidex_bulk_num_terms": ([c.c_void_p], c.c_int64),
            "infidex_bulk_terms_blob_len": ([c.c_void_p], c.c_int64),
            "infidex_bulk_copy_terms": ([c.c_void_p, u32p, i64p], None),
            "infidex_bulk_postings_len": ([c.c_void_p], c.c_int64),
            "infidex_bulk_copy_postings": ([c.c_void_p, i64p, i32p, u8p,
                                            i32p], None),
            "infidex_bulk_wm_num_keys": ([c.c_void_p, c.c_int32], c.c_int64),
            "infidex_bulk_wm_blob_len": ([c.c_void_p, c.c_int32], c.c_int64),
            "infidex_bulk_wm_docs_len": ([c.c_void_p, c.c_int32], c.c_int64),
            "infidex_bulk_copy_wm": ([c.c_void_p, c.c_int32, u32p, i64p,
                                      i64p, i32p], None),
            "infidex_bulk_sq_num_keys": ([c.c_void_p], c.c_int64),
            "infidex_bulk_sq_blob_len": ([c.c_void_p], c.c_int64),
            "infidex_bulk_sq_postings_len": ([c.c_void_p], c.c_int64),
            "infidex_bulk_copy_sq": ([c.c_void_p, u32p, i64p, i64p, i64p],
                                     None),
        }
        for name, (args, res) in sigs.items():
            fn = getattr(_lib, name)
            fn.argtypes = args
            fn.restype = res
    except AttributeError:
        return False
    _BULK_BOUND = True
    return True


def bulk_available() -> bool:
    return _bind()


def _i32p(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))


def _i64p(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))


def _u32p(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32))


def _u8p(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


def _blob(texts: List[str]) -> Tuple[np.ndarray, np.ndarray]:
    """Concatenate strings into a UTF-32 code-point blob + offsets."""
    offsets = np.zeros(len(texts) + 1, dtype=np.int64)
    for i, t in enumerate(texts):
        offsets[i + 1] = offsets[i] + len(t)
    raw = "".join(texts).encode("utf-32-le", "surrogatepass")
    blob = np.frombuffer(raw, dtype=np.uint32).copy() if raw else \
        np.zeros(1, np.uint32)
    return blob, offsets


def _decode_keys(blob: np.ndarray, offsets: np.ndarray) -> List[str]:
    raw = blob.tobytes()
    return [raw[offsets[i] * 4 : offsets[i + 1] * 4].decode(
        "utf-32-le", "surrogatepass") for i in range(offsets.size - 1)]


def build_coverage_arrays(doc_texts: List[str], delimiters,
                          d_max: int, l_max: int):
    """Native CoverageTables.build core: returns the numpy table bundle
    (word_chars, word_chars_rev, word_lens, doc_tokens, doc_offsets,
    doc_count, doc_adj, doc_text_len, overflow, max_wlen) or None."""
    if not _bind():
        return None
    blob, offsets = _blob(list(doc_texts))
    delims = np.asarray(sorted(ord(d) for d in delimiters), dtype=np.uint32)
    h = ctypes.c_void_p(_lib.infidex_cov_build(
        _u32p(blob), _i64p(offsets), len(doc_texts), _u32p(delims),
        len(delims), d_max, l_max))
    if not h:
        return None
    try:
        n = len(doc_texts)
        w = max(int(_lib.infidex_cov_num_words(h)), 1)
        word_chars = np.zeros((w, l_max), np.int32)
        word_chars_rev = np.zeros((w, l_max), np.int32)
        word_lens = np.zeros(w, np.int32)
        doc_tokens = np.zeros((n, d_max), np.int32)
        doc_offsets = np.zeros((n, d_max), np.int32)
        doc_count = np.zeros(n, np.int32)
        doc_adj = np.zeros((n, d_max), np.uint8)
        doc_text_len = np.zeros(n, np.int32)
        overflow = np.zeros(n, np.uint8)
        max_wlen = np.zeros(n, np.int32)
        if n:
            _lib.infidex_cov_copy(
                h, _i32p(word_chars), _i32p(word_chars_rev),
                _i32p(word_lens), _i32p(doc_tokens), _i32p(doc_offsets),
                _i32p(doc_count), _u8p(doc_adj), _i32p(doc_text_len),
                _u8p(overflow), _i32p(max_wlen))
        return (word_chars, word_chars_rev, word_lens, doc_tokens,
                doc_offsets, doc_count, doc_adj.astype(bool), doc_text_len,
                overflow.astype(bool), max_wlen)
    finally:
        _lib.infidex_cov_free(h)


def word_document_frequencies(doc_texts: List[str], delimiters,
                              skip=None):
    """Native word-df pass: {word: unique-doc count} over live docs."""
    if not _bind():
        return None
    blob, offsets = _blob(list(doc_texts))
    delims = np.asarray(sorted(ord(d) for d in delimiters), dtype=np.uint32)
    n = len(doc_texts)
    skip_arr = np.zeros(n, np.uint8) if skip is None else \
        np.asarray(skip, np.uint8)
    h = ctypes.c_void_p(_lib.infidex_wordstats_build(
        _u32p(blob), _i64p(offsets), n, _u32p(delims), len(delims),
        _u8p(skip_arr)))
    if not h:
        return None
    try:
        nk = int(_lib.infidex_wordstats_num(h))
        if nk == 0:
            return {}
        kblob = np.zeros(max(int(_lib.infidex_wordstats_blob_len(h)), 1),
                         np.uint32)
        key_off = np.zeros(nk + 1, np.int64)
        dfs = np.zeros(nk, np.int64)
        _lib.infidex_wordstats_copy(h, _u32p(kblob), _i64p(key_off),
                                    _i64p(dfs))
        keys = _decode_keys(kblob, key_off)
        return {k: int(d) for k, d in zip(keys, dfs)}
    finally:
        _lib.infidex_wordstats_free(h)


class BulkIndexer:
    """Streaming bulk builder; add_chunk repeatedly, then finalize once."""

    def __init__(self, index_sizes: Sequence[int], start_pad: int,
                 stop_pad: int, delimiters: Sequence[str],
                 remove_duplicate_tokens: bool, stop_term_limit: int,
                 field_weights: Sequence[float],
                 wm_setup=None, sq_minmax: Optional[Tuple[int, int]] = None):
        if not _bind():
            raise RuntimeError("native bulk indexer unavailable")
        sizes = np.asarray(list(index_sizes), dtype=np.int32)
        delims = np.asarray(sorted(ord(d) for d in delimiters),
                            dtype=np.uint32)
        fw = np.asarray(list(field_weights), dtype=np.float32)
        wm = wm_setup
        sq_min, sq_max = sq_minmax if sq_minmax else (0, 0)
        self._handle = ctypes.c_void_p(_lib.infidex_bulk_create(
            _i32p(sizes), len(sizes), start_pad, stop_pad,
            _u32p(delims), len(delims),
            1 if remove_duplicate_tokens else 0, stop_term_limit,
            fw.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), len(fw),
            1 if wm is not None else 0,
            wm.minimum_word_size_exact if wm else 0,
            wm.maximum_word_size_exact if wm else 0,
            wm.minimum_word_size_ld1 if wm else 0,
            wm.maximum_word_size_ld1 if wm else 0,
            1 if (wm and wm.support_ld1) else 0,
            1 if (wm and wm.support_affix) else 0,
            1 if sq_minmax else 0, sq_min, sq_max))
        if not self._handle:
            raise RuntimeError("bulk_create failed")

    def add_chunk(self, main_texts: List[str], sq_texts: List[str],
                  wm_texts: List[str], doc_ids: Sequence[int],
                  is_continuation: Sequence[bool],
                  boundaries: List[List[Tuple[int, int]]]) -> None:
        n = len(main_texts)
        blob, off = _blob(main_texts)
        sq_blob, sq_off = _blob(sq_texts)
        wm_blob, wm_off = _blob(wm_texts)
        ids = np.asarray(list(doc_ids), dtype=np.int32)
        cont = np.asarray([1 if c else 0 for c in is_continuation],
                          dtype=np.uint8)
        fw_off = np.zeros(n + 1, dtype=np.int64)
        for i, b in enumerate(boundaries):
            fw_off[i + 1] = fw_off[i] + len(b)
        total = int(fw_off[-1])
        fw_pos = np.zeros(max(total, 1), dtype=np.int32)
        fw_widx = np.zeros(max(total, 1), dtype=np.int32)
        k = 0
        for b in boundaries:
            for pos, widx in b:
                fw_pos[k] = pos
                fw_widx[k] = widx
                k += 1
        _lib.infidex_bulk_add(
            self._handle, _u32p(blob), _i64p(off), _u32p(sq_blob),
            _i64p(sq_off), _u32p(wm_blob), _i64p(wm_off), _i32p(ids),
            _u8p(cont), n, _i32p(fw_pos), _i32p(fw_widx), _i64p(fw_off))

    # ------------------------------------------------------------------
    def export_terms(self):
        t = int(_lib.infidex_bulk_num_terms(self._handle))
        blob = np.zeros(max(int(_lib.infidex_bulk_terms_blob_len(
            self._handle)), 1), np.uint32)
        offsets = np.zeros(t + 1, np.int64)
        _lib.infidex_bulk_copy_terms(self._handle, _u32p(blob),
                                     _i64p(offsets))
        terms = _decode_keys(blob, offsets)
        p = int(_lib.infidex_bulk_postings_len(self._handle))
        term_offsets = np.zeros(t + 1, np.int64)
        docs = np.zeros(max(p, 1), np.int32)
        weights = np.zeros(max(p, 1), np.uint8)
        dfs = np.zeros(max(t, 1), np.int32)
        _lib.infidex_bulk_copy_postings(
            self._handle, _i64p(term_offsets), _i32p(docs), _u8p(weights),
            _i32p(dfs))
        return terms, term_offsets, docs[:p], weights[:p], dfs[:t]

    def export_wm(self, which: int) -> Dict[str, np.ndarray]:
        nk = int(_lib.infidex_bulk_wm_num_keys(self._handle, which))
        if nk == 0:
            return {}
        blob = np.zeros(max(int(_lib.infidex_bulk_wm_blob_len(
            self._handle, which)), 1), np.uint32)
        key_off = np.zeros(nk + 1, np.int64)
        doc_off = np.zeros(nk + 1, np.int64)
        nd = int(_lib.infidex_bulk_wm_docs_len(self._handle, which))
        doc_ids = np.zeros(max(nd, 1), np.int32)
        _lib.infidex_bulk_copy_wm(self._handle, which, _u32p(blob),
                                  _i64p(key_off), _i64p(doc_off),
                                  _i32p(doc_ids))
        keys = _decode_keys(blob, key_off)
        return {k: doc_ids[doc_off[i]:doc_off[i + 1]]
                for i, k in enumerate(keys)}

    def export_sq(self) -> Dict[str, np.ndarray]:
        nk = int(_lib.infidex_bulk_sq_num_keys(self._handle))
        if nk == 0:
            return {}
        blob = np.zeros(max(int(_lib.infidex_bulk_sq_blob_len(
            self._handle)), 1), np.uint32)
        key_off = np.zeros(nk + 1, np.int64)
        post_off = np.zeros(nk + 1, np.int64)
        np_posts = int(_lib.infidex_bulk_sq_postings_len(self._handle))
        packed = np.zeros(max(np_posts, 1), np.int64)
        _lib.infidex_bulk_copy_sq(self._handle, _u32p(blob), _i64p(key_off),
                                  _i64p(post_off), _i64p(packed))
        keys = _decode_keys(blob, key_off)
        out = {}
        for i, k in enumerate(keys):
            seg = packed[post_off[i]:post_off[i + 1]]
            pairs = np.empty((seg.size, 2), np.int32)
            pairs[:, 0] = (seg >> 32).astype(np.int32)
            pairs[:, 1] = (seg & 0xFFFFFFFF).astype(np.int32)
            out[k] = pairs
        return out

    def close(self) -> None:
        if self._handle:
            _lib.infidex_bulk_free(self._handle)
            self._handle = None

    def __del__(self):  # pragma: no cover
        try:
            self.close()
        except Exception:
            pass
