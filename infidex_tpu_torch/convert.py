"""Carry index state from the reference package into the port.

The reference keeps its index state in device arrays of its own; every
function here reads that state as numpy arrays (``np.asarray`` on each
field — no import of the reference's array library) and builds the port's
object with the same contents on a chosen device. The parity tests use it
to feed both packages identical state, whichever builder produced it (the
C++ bulk indexer or hand-made CSR inputs). No reference instance is
passed through: the port's classes are its own.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from . import runtime
from .index.builder import BuiltIndex
from .index.device import DeviceIndex
from .ops.coverage_kernel import CoverageTables, _upload
from .ops.fuzzy import NGramSignatureIndex, pack_signatures


def built_index_from_reference(ref_built) -> BuiltIndex:
    """The port's BuiltIndex with the fields of a reference ``BuiltIndex``:
    arrays copied as numpy arrays, the term list and map copied, the
    champion extension carried as it is (built or not); the build
    generation is the port's own."""
    out = {}
    for f in dataclasses.fields(BuiltIndex):
        if f.name == "gen":
            continue
        v = getattr(ref_built, f.name)
        if isinstance(v, (list, dict)):
            v = type(v)(v)
        elif v is not None and not isinstance(v, (int, float, np.integer,
                                                  np.floating)):
            v = np.array(v)
        out[f.name] = v
    return BuiltIndex(**out)


def device_index_from_reference(ref_index, built: BuiltIndex = None,
                                device=None) -> DeviceIndex:
    """The port's DeviceIndex over a reference ``DeviceIndex``'s state:
    ``postings_docs``, ``postings_weights``, ``doc_lengths``,
    ``live_mask`` and ``avgdl`` (``built`` defaults to the port's copy of
    the reference's host image, whose champion layout the postings
    follow)."""
    if built is None:
        built = built_index_from_reference(ref_index.built)
    return DeviceIndex.from_state(
        built,
        np.asarray(ref_index.postings_docs),
        np.asarray(ref_index.postings_weights),
        np.asarray(ref_index.doc_lengths),
        np.asarray(ref_index.live_mask),
        float(np.asarray(ref_index.avgdl)), device=device)


def coverage_tables_from_reference(ref_tables, device=None) -> CoverageTables:
    """The port's CoverageTables with every field of a reference
    ``CoverageTables``: device arrays uploaded to ``device`` (uint16
    ``text_chars`` widened to the port's int32), host mirrors copied, and
    the append headroom state (``n_docs``, ``n_words``) carried, so that
    both packages append to the same rows."""
    dev = torch.device(device) if device is not None else runtime.device()
    out = {}
    for f in dataclasses.fields(CoverageTables):
        v = getattr(ref_tables, f.name)
        if v is None or isinstance(v, (int, np.integer)):
            out[f.name] = v
            continue
        if isinstance(v, np.ndarray):
            out[f.name] = v.copy()
            continue
        a = np.asarray(v)
        if a.dtype == np.uint16:
            a = a.astype(np.int32)
        out[f.name] = _upload(a, dev)
    return CoverageTables(**out)


def signature_index_from_reference(ref_sig,
                                   device=None) -> NGramSignatureIndex:
    """The port's NGramSignatureIndex over a reference
    ``NGramSignatureIndex``'s state: its int8 [128, V_pad] signature
    matrix packed into the port's int32 [V_pad, 4] words, ``vpop``,
    ``vlen``, ``elig``, the logical size ``v``, ``min_len`` and the
    terms (headroom slots included)."""
    sig_t = np.asarray(ref_sig._sig_t)
    return NGramSignatureIndex.from_state(
        pack_signatures(sig_t.T), np.asarray(ref_sig._vpop),
        np.asarray(ref_sig._vlen), np.asarray(ref_sig._elig), ref_sig.v,
        ref_sig._terms, min_len=ref_sig.min_len, device=device)
