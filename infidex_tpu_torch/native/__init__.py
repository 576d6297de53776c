"""Native (C++) data-plane kernels with transparent Python fallback.

The reference implements its hot host-side loops in C# with SIMD
intrinsics (Metrics/LevenshteinDistance.cs, Compression/GroupVarInt.cs);
here the equivalents live in ``_lib.cpp``, compiled on first import with
``g++ -O3`` and bound through ctypes (no pybind11 in this environment).

Public surface (all return None-able module-level callables; ``available``
tells you whether the native library loaded):

* ``levenshtein(a, b, max_errors)`` -> int
* ``damerau(a, b, max_distance)`` -> int
* ``prefix_distance(prefix, word, max_errors)`` -> int
* ``lcs(q, r, tolerance)`` -> int
* ``lcs_batch(q, docs, tolerance)`` -> np.ndarray[int32]
* ``gvi_encode/gvi_decode`` (+ ``_delta`` variants) — GroupVarInt codec

Set ``INFIDEX_TPU_NO_NATIVE=1`` to force the pure-Python paths.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import tempfile
import threading
from typing import List, Optional

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_HERE, "_lib.cpp")


def _isa_tag() -> str:
    """Short hash of this host's CPU ISA feature set. The library is
    compiled with ``-march=native``, so a cached .so copied to a host
    with a different microarchitecture (docker layer, NFS) would SIGILL
    at the first call — mtime alone can't see that. Keying the filename
    by the ISA tag forces a rebuild on a foreign host instead."""
    import hashlib
    import platform

    flags = ""
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.startswith(("flags", "Features")):
                    flags = line
                    break
    except OSError:
        pass
    raw = platform.machine() + ":" + " ".join(sorted(flags.split()))
    return hashlib.sha1(raw.encode()).hexdigest()[:10]


_SO = os.path.join(_HERE, f"_infidex_native.{_isa_tag()}.so")

_lib = None
_lock = threading.Lock()
available = False


def _compile() -> bool:
    """Build the shared library next to the source (atomic rename)."""
    try:
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=_HERE)
        os.close(fd)
        # -march=native: the bitset gathers / merge loops in the tier and
        # conjunctive kernels want popcount + wide loads. -ffp-contract=off
        # keeps f32 BM25 bit-identical to the numpy path (FMA contraction
        # would change the rounding; parity is pinned by
        # tests/test_lim_class.py and test_conjunctive.py). Falls back to
        # the portable build if the host compiler rejects -march=native.
        base = ["g++", "-O3", "-std=c++17", "-ffp-contract=off",
                "-shared", "-fPIC", "-o", tmp, _SRC]
        res = subprocess.run(base[:1] + ["-march=native"] + base[1:],
                             capture_output=True, timeout=120)
        if res.returncode != 0:
            res = subprocess.run(base, capture_output=True, timeout=120)
        if res.returncode != 0:
            os.unlink(tmp)
            return False
        os.replace(tmp, _SO)
        return True
    except Exception:
        return False


def _load() -> Optional[ctypes.CDLL]:
    global available
    if os.environ.get("INFIDEX_TPU_NO_NATIVE"):
        return None
    try:
        need_build = (not os.path.exists(_SO)
                      or os.path.getmtime(_SO) < os.path.getmtime(_SRC))
        if need_build and not _compile():
            return None
        lib = ctypes.CDLL(_SO)
        c_u32p = ctypes.POINTER(ctypes.c_uint32)
        c_f32p = ctypes.POINTER(ctypes.c_float)
        c_i64p = ctypes.POINTER(ctypes.c_int64)
        c_u8p = ctypes.POINTER(ctypes.c_uint8)
        c_i32p = ctypes.POINTER(ctypes.c_int32)
        for name, args, res in (
            ("infidex_levenshtein",
             [c_u32p, ctypes.c_int, c_u32p, ctypes.c_int, ctypes.c_int],
             ctypes.c_int),
            ("infidex_damerau",
             [c_u32p, ctypes.c_int, c_u32p, ctypes.c_int, ctypes.c_int],
             ctypes.c_int),
            ("infidex_prefix_distance",
             [c_u32p, ctypes.c_int, c_u32p, ctypes.c_int, ctypes.c_int],
             ctypes.c_int),
            ("infidex_lcs",
             [c_u32p, ctypes.c_int, c_u32p, ctypes.c_int, ctypes.c_int],
             ctypes.c_int),
            ("infidex_lcs_batch",
             [c_u32p, ctypes.c_int, c_u32p, c_i64p, ctypes.c_int,
              ctypes.c_int, c_i32p],
             None),
            ("infidex_gvi_encode", [c_u32p, ctypes.c_int64, c_u8p],
             ctypes.c_int64),
            ("infidex_gvi_decode", [c_u8p, ctypes.c_int64, c_u32p],
             ctypes.c_int64),
            ("infidex_gvi_encode_delta", [c_u32p, ctypes.c_int64, c_u8p],
             ctypes.c_int64),
            ("infidex_gvi_decode_delta", [c_u8p, ctypes.c_int64, c_u32p],
             ctypes.c_int64),
            ("infidex_score_pool",
             [c_i64p, c_i32p, c_u8p, c_f32p, ctypes.c_int64,
              ctypes.c_float, c_i64p, c_f32p, ctypes.c_int32,
              c_i64p, ctypes.c_int32, c_f32p],
             None),
            ("infidex_member_any",
             [c_i32p, ctypes.c_int64, c_i64p, ctypes.c_int64, c_u8p],
             None),
            ("infidex_tier_phase_stats",
             [ctypes.POINTER(ctypes.c_double), ctypes.c_int32],
             None),
            ("infidex_tier_select",
             [c_i64p, c_i32p, c_u8p, c_i64p, ctypes.c_int32,
              c_i64p, ctypes.c_int32, ctypes.c_int32, ctypes.c_uint64,
              c_i64p, ctypes.POINTER(ctypes.c_int32)],
             ctypes.c_int64),
            ("infidex_tier_batch",
             [c_i64p, c_i32p, c_u8p, c_f32p, ctypes.c_int64,
              ctypes.c_float, c_i32p, c_i64p, c_i64p, c_f32p,
              ctypes.c_int32, ctypes.c_int32, ctypes.c_uint64,
              c_u8p, ctypes.c_int64, c_f32p, c_i32p, c_i32p],
             ctypes.c_int64),
            ("infidex_conj_pool",
             [c_i64p, c_i32p, c_u8p, c_f32p, ctypes.c_int64,
              ctypes.c_float, c_i32p, c_i64p, c_u8p, c_u8p, c_u8p,
              ctypes.c_int64, ctypes.c_int32, c_i64p, c_f32p,
              ctypes.c_int32, c_i32p, ctypes.c_int64, ctypes.c_int32,
              ctypes.c_int32, c_i64p],
             ctypes.c_int64),
        ):
            fn = getattr(lib, name)
            fn.argtypes = args
            fn.restype = res
        available = True
        return lib
    except Exception:
        return None


with _lock:
    _lib = _load()

_MAX_CLAMP = 1 << 20  # keep max_dist + 1 arithmetic safely in int range


def _u32(s: str) -> np.ndarray:
    return np.frombuffer(s.encode("utf-32-le"), dtype=np.uint32)


def _ptr(arr: np.ndarray):
    return arr.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32))


def levenshtein(a: str, b: str, max_errors: int = _MAX_CLAMP) -> int:
    ab, bb = _u32(a), _u32(b)
    return _lib.infidex_levenshtein(
        _ptr(ab), len(ab), _ptr(bb), len(bb), min(max_errors, _MAX_CLAMP))


def damerau(a: str, b: str, max_distance: int) -> int:
    ab, bb = _u32(a), _u32(b)
    return _lib.infidex_damerau(
        _ptr(ab), len(ab), _ptr(bb), len(bb), min(max_distance, _MAX_CLAMP))


def prefix_distance(prefix: str, word: str, max_errors: int) -> int:
    ab, bb = _u32(prefix), _u32(word)
    return _lib.infidex_prefix_distance(
        _ptr(ab), len(ab), _ptr(bb), len(bb), min(max_errors, _MAX_CLAMP))


def lcs(q: str, r: str, tolerance: int) -> int:
    qb, rb = _u32(q), _u32(r)
    return _lib.infidex_lcs(_ptr(qb), len(qb), _ptr(rb), len(rb), tolerance)


def lcs_batch(q: str, docs: List[str], tolerance: int) -> np.ndarray:
    """LCS of one query against many docs in a single native call."""
    qb = _u32(q)
    joined = "".join(docs)
    db = _u32(joined) if joined else np.zeros(0, np.uint32)
    offsets = np.zeros(len(docs) + 1, np.int64)
    pos = 0
    for i, d in enumerate(docs):
        pos += len(d)
        offsets[i + 1] = pos
    out = np.zeros(len(docs), np.int32)
    _lib.infidex_lcs_batch(
        _ptr(qb), len(qb), _ptr(db),
        offsets.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        len(docs), tolerance,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
    return out


def gvi_encode(values: np.ndarray, delta: bool = False) -> bytes:
    vals = np.ascontiguousarray(values, dtype=np.uint32)
    out = np.zeros(len(vals) * 5 + 8, np.uint8)
    fn = (_lib.infidex_gvi_encode_delta if delta
          else _lib.infidex_gvi_encode)
    n = fn(_ptr(vals), len(vals),
           out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)))
    return out[:n].tobytes()


def gvi_decode(data: bytes, count: int, delta: bool = False):
    """Returns (values uint32[count], bytes_consumed)."""
    buf = np.frombuffer(data, dtype=np.uint8)
    out = np.zeros(count, np.uint32)
    fn = (_lib.infidex_gvi_decode_delta if delta
          else _lib.infidex_gvi_decode)
    consumed = fn(buf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
                  count, _ptr(out))
    return out, int(consumed)

def score_pool_native(term_offsets, postings_docs, postings_weights,
                      doc_lengths, avgdl, term_ids, idfs, pool):
    """BM25+ of ascending ``pool`` docs over query terms — C twin of
    candidates.score_pool (bit-identical f32 results; parity pinned by
    tests/test_lim_class.py)."""
    def p(arr, dt, ct):
        a = np.ascontiguousarray(arr, dt)
        return a, a.ctypes.data_as(ctypes.POINTER(ct))

    to, to_p = p(term_offsets, np.int64, ctypes.c_int64)
    pd, pd_p = p(postings_docs, np.int32, ctypes.c_int32)
    pw, pw_p = p(postings_weights, np.uint8, ctypes.c_uint8)
    dl, dl_p = p(doc_lengths, np.float32, ctypes.c_float)
    ti, ti_p = p(np.asarray(term_ids), np.int64, ctypes.c_int64)
    fi, fi_p = p(np.asarray(idfs), np.float32, ctypes.c_float)
    pl, pl_p = p(pool, np.int64, ctypes.c_int64)
    out = np.empty(pl.size, np.float32)
    _lib.infidex_score_pool(
        to_p, pd_p, pw_p, dl_p, ctypes.c_int64(int(dl.size)),
        ctypes.c_float(float(avgdl)), ti_p, fi_p,
        ctypes.c_int32(int(ti.size)), pl_p, ctypes.c_int32(int(pl.size)),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
    return out


_TIER_LABELS = {1: "all", 2: "all-minus-one", 3: "selective"}


def tier_phase_stats(reset=False):
    """Cumulative wall seconds per phase inside infidex_tier_select:
    dict with isect, champ0, isect2, sel_champ, merge, calls —
    measurement tooling (scripts/tier_profile.py), not a serving API."""
    out = np.zeros(8, np.float64)
    _lib.infidex_tier_phase_stats(
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        ctypes.c_int32(1 if reset else 0))
    return {"isect": out[0], "champ0": out[1], "isect2": out[2],
            "sel_champ": out[3], "merge": out[4], "calls": int(out[5])}


def tier_select(term_offsets, postings_docs, postings_weights,
                ordered_tids, sel_tids, top_k, generation=0):
    """Tiered candidate pool (candidates.TieredCandidateSelector.select
    non-union twin): returns (pool int64 ascending-unique, tier label).
    ``ordered_tids`` = live term ids sorted (df asc, stable);
    ``sel_tids`` = the <=2 selective high-IDF ids, df-sorted;
    ``generation`` keys the in-library champion memo (pass the
    BuiltIndex.gen token so a re-finalize invalidates it)."""
    def p(arr, dt, ct):
        a = np.ascontiguousarray(arr, dt)
        return a, a.ctypes.data_as(ctypes.POINTER(ct))

    to, to_p = p(term_offsets, np.int64, ctypes.c_int64)
    pd, pd_p = p(postings_docs, np.int32, ctypes.c_int32)
    pw, pw_p = p(postings_weights, np.uint8, ctypes.c_uint8)
    ot, ot_p = p(ordered_tids, np.int64, ctypes.c_int64)
    st, st_p = p(sel_tids, np.int64, ctypes.c_int64)
    out = np.empty(5 * top_k * 10 + 16, np.int64)
    label = ctypes.c_int32(0)
    n = _lib.infidex_tier_select(
        to_p, pd_p, pw_p, ot_p, ctypes.c_int32(int(ot.size)),
        st_p, ctypes.c_int32(int(st.size)), ctypes.c_int32(int(top_k)),
        ctypes.c_uint64(int(generation)),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        ctypes.byref(label))
    return out[:n].copy(), _TIER_LABELS[label.value]


def tier_batch(built, queries, top_k, deleted_arr=None):
    """Whole-batch tier Stage-1 in ONE GIL-released native call
    (candidates.TieredStage1.run twin per query, minus LIM ids):
    select + deleted-filter + exact BM25 + top-k.

    ``queries`` = [(term_ids, idfs), ...] in ORIGINAL query order (the
    C side derives the df ordering, selectivity and union routing from
    BuiltIndex.df exactly as TieredCandidateSelector.select does).
    Returns (scores f32[Q, top_k], ids i32[Q, top_k], labels i32[Q]);
    labels use the tier_select convention, 0 = union/empty pool (the
    caller routes those queries to the device path)."""
    def p(arr, dt, ct):
        a = np.ascontiguousarray(arr, dt)
        return a, a.ctypes.data_as(ctypes.POINTER(ct))

    nq = len(queries)
    q_off = np.zeros(nq + 1, np.int64)
    for i, (tids, _) in enumerate(queries):
        q_off[i + 1] = q_off[i] + len(tids)
    flat_t = np.empty(int(q_off[-1]), np.int64)
    flat_i = np.empty(int(q_off[-1]), np.float32)
    for i, (tids, idfs) in enumerate(queries):
        s, e = int(q_off[i]), int(q_off[i + 1])
        flat_t[s:e] = tids
        flat_i[s:e] = idfs

    to, to_p = p(built.term_offsets, np.int64, ctypes.c_int64)
    pd, pd_p = p(built.postings_docs, np.int32, ctypes.c_int32)
    pw, pw_p = p(built.postings_weights, np.uint8, ctypes.c_uint8)
    dl, dl_p = p(built.doc_lengths, np.float32, ctypes.c_float)
    dfar, df_p = p(built.df, np.int32, ctypes.c_int32)
    qo, qo_p = p(q_off, np.int64, ctypes.c_int64)
    ft, ft_p = p(flat_t, np.int64, ctypes.c_int64)
    fi, fi_p = p(flat_i, np.float32, ctypes.c_float)
    if deleted_arr is not None and deleted_arr.size:
        da, da_p = p(deleted_arr, np.uint8, ctypes.c_uint8)
        n_del = int(da.size)
    else:
        da = np.zeros(1, np.uint8)
        da_p = da.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))
        n_del = 0
    out_scores = np.zeros((nq, top_k), np.float32)
    out_ids = np.zeros((nq, top_k), np.int32)
    out_label = np.zeros(nq, np.int32)
    _lib.infidex_tier_batch(
        to_p, pd_p, pw_p, dl_p,
        ctypes.c_int64(int(built.doc_lengths.size)),
        ctypes.c_float(float(max(built.avgdl, 1e-9))),
        df_p, qo_p, ft_p, fi_p,
        ctypes.c_int32(nq), ctypes.c_int32(int(top_k)),
        ctypes.c_uint64(int(getattr(built, "gen", 0))),
        da_p, ctypes.c_int64(n_del),
        out_scores.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        out_ids.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        out_label.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
    return out_scores, out_ids, out_label


def member_any_into(postings, cand, mask) -> None:
    """``mask[i] |= (cand[i] in postings)`` with already-set entries
    SKIPPED (the conjunctive filter's unresolved set shrinks with every
    evidence list, so probe work drops monotonically — numpy's
    searchsorted re-probes everything). ``postings`` sorted int32
    ascending, ``cand`` sorted int64 ascending, ``mask`` uint8 INOUT.

    Falls back to one vectorized searchsorted when the native library
    is unavailable (identical results)."""
    n = int(cand.size)
    if n == 0 or postings.size == 0:
        return
    if available:
        p = np.ascontiguousarray(postings, np.int32)
        c = np.ascontiguousarray(cand, np.int64)
        _lib.infidex_member_any(
            p.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            ctypes.c_int64(int(p.size)),
            c.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            ctypes.c_int64(n),
            mask.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)))
        return
    j = np.searchsorted(postings, cand)
    jc = np.minimum(j, postings.size - 1)
    np.bitwise_or(mask, ((j < postings.size)
                         & (postings[jc] == cand)).view(np.uint8),
                  out=mask)


def conj_pool_native(built, anchor_unions, ev_bits, an_bits, has_ev,
                     score_tids, score_idfs, tok_count,
                     anchor_clip, conj_cap) -> np.ndarray:
    """One-call twin of conjunctive.conjunctive_pool's probe/rank core:
    per-pivot anchor-union filtering against every other token's evidence
    BITSET, pool merge, and the (strong desc, tok_n asc, BM25 desc,
    id asc) ranking — byte-identical to the numpy path
    (tests/test_conjunctive.py::test_native_pool_parity).

    ``anchor_unions``: per token sorted-unique int32 doc arrays (pivot
    candidate sources); ``ev_bits``/``an_bits``: [n_tok, nbytes] packed
    little-bitorder bitsets (evidence = anchors|grams; anchors only);
    ``has_ev``: uint8 [n_tok]; ``score_tids/idfs`` empty => unranked
    clip; ``tok_count`` None => zeros (BM25/id ordering only)."""
    n_tok = len(anchor_unions)
    af = (np.concatenate([np.ascontiguousarray(a, np.int32)
                          for a in anchor_unions])
          if any(a.size for a in anchor_unions) else np.zeros(0, np.int32))
    ao = np.zeros(n_tok + 1, np.int64)
    np.cumsum([a.size for a in anchor_unions], out=ao[1:])

    def p(arr, dt, ct):
        a = np.ascontiguousarray(arr, dt)
        return a, a.ctypes.data_as(ctypes.POINTER(ct))

    to, to_p = p(built.term_offsets, np.int64, ctypes.c_int64)
    pd, pd_p = p(built.postings_docs, np.int32, ctypes.c_int32)
    pw, pw_p = p(built.postings_weights, np.uint8, ctypes.c_uint8)
    dl, dl_p = p(built.doc_lengths, np.float32, ctypes.c_float)
    af, af_p = p(af, np.int32, ctypes.c_int32)
    ao, ao_p = p(ao, np.int64, ctypes.c_int64)
    ev, ev_p = p(ev_bits, np.uint8, ctypes.c_uint8)
    an, an_p = p(an_bits, np.uint8, ctypes.c_uint8)
    he, he_p = p(has_ev, np.uint8, ctypes.c_uint8)
    nbytes = int(ev.shape[1]) if ev.ndim == 2 else 0
    st, st_p = p(np.asarray(score_tids), np.int64, ctypes.c_int64)
    si, si_p = p(np.asarray(score_idfs), np.float32, ctypes.c_float)
    if tok_count is None:
        tc_p, tc_len = None, 0
    else:
        tc, tc_p = p(tok_count, np.int32, ctypes.c_int32)
        tc_len = int(tc.size)
    out = np.empty(int(conj_cap), np.int64)
    n = _lib.infidex_conj_pool(
        to_p, pd_p, pw_p, dl_p, ctypes.c_int64(int(dl.size)),
        ctypes.c_float(float(built.avgdl)), af_p, ao_p, ev_p, an_p, he_p,
        ctypes.c_int64(nbytes),
        ctypes.c_int32(n_tok), st_p, si_p, ctypes.c_int32(int(st.size)),
        tc_p, ctypes.c_int64(tc_len), ctypes.c_int32(int(anchor_clip)),
        ctypes.c_int32(int(conj_cap)),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)))
    return out[:n].copy()
