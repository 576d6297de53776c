"""ctypes wrapper for the native bulk index builder (_lib.cpp).

One pass over UTF-32 document blobs produces: the term dictionary in
first-seen order, CSR postings with the exact increment_usage /
first_cycle_add accumulation semantics of index/builder.py, the
WordMatcher exact/LD1/affix maps, and the positional prefix index —
replacing ~15 Python dict operations per token (the reference builds its
inverted lists with Parallel.For over C# dictionaries,
VectorModel.cs:130-220).

With the products on (``BulkIndexer.enable_products``) the same pass
takes each document's raw text and also emits every per-document table
the later build phases read (``export_products``). It normalizes a
document itself when the fold table (``fold_tables``) covers every code
point of it; for any other document the caller's Python recipes give
its texts (``add_raw``).
"""

from __future__ import annotations

import ctypes
from itertools import chain
from typing import Callable, Dict, List, Optional, Sequence, Tuple

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
            "infidex_bulk_products": ([c.c_void_p, u8p, u32p, u32p,
                                       c.c_int32, c.c_int32, c.c_int32,
                                       c.c_int32, c.c_int64], None),
            "infidex_bulk_classify": ([c.c_void_p, u32p, i64p, c.c_int32,
                                       u8p], None),
            "infidex_bulk_add_raw": ([c.c_void_p, u32p, i64p, i32p, u8p, u8p,
                                      c.c_int32, i32p, i32p, i64p, i32p,
                                      c.c_int32, u32p, i64p], None),
            "infidex_bulk_num_docs": ([c.c_void_p], c.c_int64),
            "infidex_bulk_norm_len": ([c.c_void_p], c.c_int64),
            "infidex_bulk_copy_docs": ([c.c_void_p, u32p, i64p, u8p, i32p,
                                        i32p, u8p, i64p], None),
            "infidex_bulk_cov": ([c.c_void_p], c.c_void_p),
            "infidex_bulk_num_terms": ([c.c_void_p], c.c_int64),
            "infidex_bulk_terms_blob_len": ([c.c_void_p], c.c_int64),
            "infidex_bulk_copy_terms": ([c.c_void_p, u32p, i64p], None),
            "infidex_bulk_postings_len": ([c.c_void_p], c.c_int64),
            "infidex_bulk_copy_postings": ([c.c_void_p, i64p, i32p, u8p,
                                            i32p], None),
            "infidex_bulk_map_num_keys": ([c.c_void_p, c.c_int32],
                                          c.c_int64),
            "infidex_bulk_map_blob_len": ([c.c_void_p, c.c_int32],
                                          c.c_int64),
            "infidex_bulk_map_docs_len": ([c.c_void_p, c.c_int32],
                                          c.c_int64),
            "infidex_bulk_copy_map": ([c.c_void_p, c.c_int32, u32p, i64p,
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
    np.cumsum(np.fromiter(map(len, texts), np.int64, len(texts)),
              out=offsets[1:])
    raw = "".join(texts).encode("utf-32-le", "surrogatepass")
    blob = np.frombuffer(raw, dtype=np.uint32) if raw else \
        np.zeros(1, np.uint32)
    return blob, offsets


def _decode_keys(blob: np.ndarray, offsets: np.ndarray) -> List[str]:
    """The strings of a blob made by ``_blob`` (or the native exports):
    UTF-32 decodes a unit to a code point, so the offsets index the
    decoded text."""
    bounds = offsets.tolist()
    text = blob[:bounds[-1]].tobytes().decode("utf-32-le", "surrogatepass")
    return [text[a:b] for a, b in zip(bounds, bounds[1:])]


FOLD_LIMIT = 0x300  # ASCII, Latin-1 and Latin Extended, the default table's keys


def fold_tables(normalizer, limit: int = FOLD_LIMIT):
    """The code points whose texts the bulk pass derives itself.

    Returns (covered uint8, lower uint32, fold uint32, collapse) over code
    points 0..limit-1. A code point c is covered when every recipe of
    the build phases is, on any string of covered code points, one map
    per code point followed by the collapse of space runs: ``lower[c]``
    is ``chr(c).lower()`` and ``fold[c]`` is ``normalize`` then ``lower``
    of it, and the checks below make normalize-then-lower,
    lower-then-normalize and every longer chain of the two give that same
    fold. ``collapse`` is the normalizer's standard-whitespace mode. A
    normalizer with string replacements maps more than one code point at
    a time: nothing is covered then. Neither is U+03A3, whose lower case
    depends on its neighbours."""
    covered = np.zeros(limit, np.uint8)
    lower = np.zeros(limit, np.uint32)
    fold = np.zeros(limit, np.uint32)
    if normalizer is None:
        collapse, norm = False, (lambda s: s)
    elif normalizer._standard_ws or not normalizer.string_replacements:
        collapse, norm = normalizer._standard_ws, normalizer.normalize
    else:
        return covered[:0], lower[:0], fold[:0], False
    for c in range(limit):
        s = chr(c)
        lo, t = s.lower(), norm(s)
        if c == 0x3A3 or len(lo) != 1 or len(t) != 1:
            continue
        f = t.lower()
        if (f != norm(lo) or len(f) != 1 or max(ord(lo), ord(f)) >= limit
                or norm(f) != f or f.lower() != f
                or (lo == " ") != (s == " ") or (f == " ") != (t == " ")):
            continue
        covered[c], lower[c], fold[c] = 1, ord(lo), ord(f)
    return covered, lower, fold, collapse


def _cov_arrays(h, n: int, d_max: int, l_max: int):
    """The coverage table bundle of native tables ``h`` (n documents):
    (word_chars, word_chars_rev, word_lens, doc_tokens, doc_offsets,
    doc_count, doc_adj, doc_text_len, overflow, max_wlen)."""
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


def build_coverage_arrays(doc_texts: List[str], delimiters,
                          d_max: int, l_max: int):
    """Native CoverageTables.build core: the table bundle of
    ``_cov_arrays``, or None."""
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
        return _cov_arrays(h, len(doc_texts), d_max, l_max)
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
        return dict(zip(keys, dfs.tolist()))
    finally:
        _lib.infidex_wordstats_free(h)


def _boundary_arrays(boundaries: List[List[Tuple[int, int]]]):
    """(fw_pos, fw_widx, fw_off) of each document's field boundaries."""
    n = len(boundaries)
    fw_off = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(np.fromiter(map(len, boundaries), np.int64, n),
              out=fw_off[1:])
    total = int(fw_off[-1])
    flat = np.fromiter(chain.from_iterable(chain.from_iterable(boundaries)),
                       np.int32, 2 * total).reshape(total, 2)
    if not total:
        flat = np.zeros((1, 2), np.int32)
    return (np.ascontiguousarray(flat[:, 0]),
            np.ascontiguousarray(flat[:, 1]), fw_off)


# which map of the builder ``export_map`` reads
MAP_WM_EXACT, MAP_WM_LD1, MAP_WM_AFFIX = 0, 1, 2
MAP_FIRST_WORD, MAP_WORD_DF, MAP_SQ_ANY, MAP_SQ_FIRST, MAP_SQ_TITLE = \
    3, 4, 5, 6, 7


class BulkIndexer:
    """Streaming bulk builder; add_chunk (or, with the products on,
    add_raw) repeatedly, then export once."""

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
        self._d_max = self._l_max = 0
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
        cont = np.asarray(list(is_continuation), dtype=np.uint8)
        fw_pos, fw_widx, fw_off = _boundary_arrays(boundaries)
        _lib.infidex_bulk_add(
            self._handle, _u32p(blob), _i64p(off), _u32p(sq_blob),
            _i64p(sq_off), _u32p(wm_blob), _i64p(wm_off), _i32p(ids),
            _u8p(cont), n, _i32p(fw_pos), _i32p(fw_widx), _i64p(fw_off))

    # ------------------------------------------------------------------
    def enable_products(self, fold, d_max: int, l_max: int,
                        n_docs: int = 0) -> None:
        """Emit the per-document products from now on; ``fold`` is
        ``fold_tables``' result, d_max and l_max the coverage tables',
        ``n_docs`` the number of documents to come (room is kept)."""
        covered, lower, fold_map, collapse = fold
        covered = np.ascontiguousarray(covered, np.uint8)
        lower = np.ascontiguousarray(lower, np.uint32)
        fold_map = np.ascontiguousarray(fold_map, np.uint32)
        _lib.infidex_bulk_products(
            self._handle, _u8p(covered), _u32p(lower), _u32p(fold_map),
            covered.size, 1 if collapse else 0, d_max, l_max, n_docs)
        self._d_max, self._l_max = d_max, l_max

    def add_raw(self, raw_texts: List[str], doc_ids: Sequence[int],
                is_continuation: Sequence[bool],
                boundaries: List[List[Tuple[int, int]]],
                deleted: Sequence[bool],
                recipe: Callable[[str, bool], Sequence[str]]) -> int:
        """Index a chunk of documents by their raw texts, products on.
        A document with a code point the fold table does not cover gets
        its six texts from ``recipe(raw, deleted)``: main, short-query,
        WordMatcher, normalized, word-df and title, as the Python phases
        derive them. Returns the number of such documents."""
        n = len(raw_texts)
        blob, off = _blob(raw_texts)
        flags = np.zeros(max(n, 1), np.uint8)
        _lib.infidex_bulk_classify(self._handle, _u32p(blob), _i64p(off), n,
                                   _u8p(flags))
        fb = np.flatnonzero(flags[:n]).astype(np.int32)
        dels = np.asarray(list(deleted), dtype=np.uint8)
        fb_texts = [t for i in fb.tolist()
                    for t in recipe(raw_texts[i], bool(dels[i]))]
        fb_blob, fb_off = _blob(fb_texts)
        ids = np.asarray(list(doc_ids), dtype=np.int32)
        cont = np.asarray(list(is_continuation), dtype=np.uint8)
        fw_pos, fw_widx, fw_off = _boundary_arrays(boundaries)
        _lib.infidex_bulk_add_raw(
            self._handle, _u32p(blob), _i64p(off), _i32p(ids), _u8p(cont),
            _u8p(dels), n, _i32p(fw_pos), _i32p(fw_widx), _i64p(fw_off),
            _i32p(fb), fb.size, _u32p(fb_blob), _i64p(fb_off))
        return int(fb.size)

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

    def export_map(self, which: int):
        """(keys, doc_offsets, doc_ids int32) of one word -> docs map;
        key i's docs are doc_ids[doc_offsets[i]:doc_offsets[i + 1]]."""
        h = self._handle
        nk = int(_lib.infidex_bulk_map_num_keys(h, which))
        blob = np.zeros(max(int(_lib.infidex_bulk_map_blob_len(h, which)),
                            1), np.uint32)
        key_off = np.zeros(nk + 1, np.int64)
        doc_off = np.zeros(nk + 1, np.int64)
        doc_ids = np.zeros(max(int(_lib.infidex_bulk_map_docs_len(h, which)),
                               1), np.int32)
        _lib.infidex_bulk_copy_map(h, which, _u32p(blob), _i64p(key_off),
                                   _i64p(doc_off), _i32p(doc_ids))
        return _decode_keys(blob, key_off), doc_off, doc_ids

    def export_wm(self, which: int) -> Dict[str, np.ndarray]:
        keys, doc_off, doc_ids = self.export_map(which)
        bounds = doc_off.tolist()
        return {k: doc_ids[a:b] for k, a, b in zip(keys, bounds, bounds[1:])}

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

    def export_products(self) -> dict:
        """The per-document products, by the name of what reads them:
        ``norm_texts`` (list of str), ``norm`` (blob, offsets, lcs_slow:
        the same texts as UTF-32, and where their UTF-16 is not their
        code points), ``coverage`` (the ``_cov_arrays`` bundle),
        ``first_id``/``n_words`` (a document's first word as an index
        into ``first_words``, -1 for none, and its word count),
        ``first_words`` ({word: int64 docs}), ``word_df`` ({word: live
        docs}), and ``short_title``, ``text_prefix``, ``any_map``,
        ``first_map`` and ``title_map`` of the short-query doc tables
        (``ShortQueryResolver._build_doc_tables``)."""
        h = self._handle
        n = int(_lib.infidex_bulk_num_docs(h))
        norm = np.zeros(max(int(_lib.infidex_bulk_norm_len(h)), 1),
                        np.uint32)
        norm_off = np.zeros(n + 1, np.int64)
        lcs_slow = np.zeros(max(n, 1), np.uint8)
        first_id = np.zeros(max(n, 1), np.int32)
        n_words = np.zeros(max(n, 1), np.int32)
        short_title = np.zeros(max(n, 1), np.uint8)
        text_prefix = np.zeros(max(n, 1), np.int64)
        _lib.infidex_bulk_copy_docs(
            h, _u32p(norm), _i64p(norm_off), _u8p(lcs_slow),
            _i32p(first_id), _i32p(n_words), _u8p(short_title),
            _i64p(text_prefix))

        def doc_lists(which):
            keys, doc_off, doc_ids = self.export_map(which)
            ids, bounds = doc_ids.astype(np.int64), doc_off.tolist()
            return {k: ids[a:b] for k, a, b in zip(keys, bounds, bounds[1:])}

        df_keys, df_off, _ = self.export_map(MAP_WORD_DF)
        first_words = doc_lists(MAP_FIRST_WORD)
        return dict(
            norm_texts=_decode_keys(norm, norm_off),
            norm=(norm, norm_off, lcs_slow[:n].astype(bool)),
            coverage=_cov_arrays(ctypes.c_void_p(_lib.infidex_bulk_cov(h)),
                                 n, self._d_max, self._l_max),
            first_id=first_id[:n], n_words=n_words[:n],
            first_words=first_words,
            word_df=dict(zip(df_keys, np.diff(df_off).tolist())),
            short_title=short_title[:n].astype(bool),
            text_prefix=text_prefix[:n],
            any_map=doc_lists(MAP_SQ_ANY), first_map=doc_lists(MAP_SQ_FIRST),
            title_map=doc_lists(MAP_SQ_TITLE))

    def close(self) -> None:
        if self._handle:
            _lib.infidex_bulk_free(self._handle)
            self._handle = None

    def __del__(self):  # pragma: no cover
        try:
            self.close()
        except Exception:
            pass
