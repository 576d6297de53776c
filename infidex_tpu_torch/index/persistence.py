"""Binary persistence: full-index snapshot with checksum validation.

Behavioral reference: Infidex ``Indexing/IndexPersistence.cs`` (format
"INFDX2" v2: magic + version + flags + counts + checksum, length-prefixed
data block, WordMatcher trailer appended by the facade) and
``SearchEngine.Load`` (SearchEngine.cs:399-442): derived statistics
(doc lengths, avgdl, word-level idf, metadata cache) are deliberately
RECOMPUTED on load so saved+loaded engines rank identically to in-memory
ones.

Format here: magic ``IFDXTPU2`` + version + CRC32-checksummed payload in
the safe tagged binary codec (``utils/safe_codec.py`` — a pure data
format; decoding constructs only primitives/containers/ndarrays, so a
tampered index file cannot execute code, matching the reference's
INFDX2 safety posture). The payload stores the raw postings (CSR image +
term texts), documents, word-matcher tables and short-query index;
device tensors are re-uploaded on load.
"""

from __future__ import annotations

import dataclasses
import struct
import zlib
from typing import Optional

import numpy as np

from ..utils.safe_codec import CodecError, decode as _codec_decode, encode as _codec_encode

MAGIC = b"IFDXTPU2"
VERSION = 5          # written; version 3/4 files remain readable
_READABLE = (3, 4, 5)

# Field flag bitmask for the columnar document payload (v4).
_FF_INDEXABLE, _FF_FILTERABLE, _FF_SORTABLE, _FF_FACETABLE = 1, 2, 4, 8
_FF_WORD_INDEXING, _FF_OPTIONAL, _FF_IS_ARRAY, _FF_PRELOAD = 16, 32, 64, 128


class IndexFormatError(Exception):
    pass


def _doc_state(doc) -> tuple:
    fields_state = []
    for f in doc.fields:
        fields_state.append(dict(
            name=f.name, value=f.value, weight=int(f.weight),
            indexable=f.indexable, filterable=f.filterable, sortable=f.sortable,
            facetable=f.facetable, word_indexing=f.word_indexing,
            optional=f.optional, is_array=f.is_array,
            weight_as_float=f.weight_as_float,
            preload_filters=f.preload_filters,
        ))
    return (doc.document_key, doc.segment_number, doc.indexed_text,
            doc.document_client_information, doc.deleted, fields_state,
            doc.fields.name_of_document_key_field)


def _restore_doc(state) -> "Document":
    from ..api.fields import DocumentFields, Field, Weight
    from ..core.documents import Document

    (key, segment, indexed_text, client_info, deleted, fields_state,
     key_field_name) = state
    fields = DocumentFields()
    fields.name_of_document_key_field = key_field_name
    for fs in fields_state:
        fields.add_field(Field(
            fs["name"], fs["value"], Weight(fs["weight"]),
            indexable=fs["indexable"], filterable=fs["filterable"],
            sortable=fs["sortable"], facetable=fs["facetable"],
            word_indexing=fs["word_indexing"], optional=fs["optional"],
            is_array=fs["is_array"], weight_as_float=fs["weight_as_float"],
            preload_filters=fs["preload_filters"]))
    doc = Document(key, fields, segment_number=segment,
                   document_client_information=client_info)
    doc.indexed_text = indexed_text
    doc.deleted = deleted
    return doc


def _doc_columns(documents) -> dict:
    """Columnar image of the document collection (v4).

    One array per scalar attribute plus flattened field records — decoding
    per-document tuples/dicts cost ~25s at 1M docs (3.5M codec dispatches);
    the columnar image decodes in a handful of array reads.
    """
    n = len(documents)
    keys = np.empty(n, np.int64)
    segments = np.empty(n, np.int32)
    deleted = np.zeros(n, np.uint8)
    texts: list = [None] * n
    client_info: list = [None] * n
    key_field_names: list = [None] * n
    field_counts = np.zeros(n, np.int32)

    name_table: list = []
    name_ids_of: dict = {}
    f_name_ids: list = []
    f_weights: list = []
    f_flags: list = []
    f_wfloats: list = []
    f_vkinds: list = []
    f_vstrs: list = []
    f_vints: list = []
    f_vfloats: list = []
    f_vother: list = []

    any_client_info = False
    for i in range(n):
        doc = documents.get_document(i)
        keys[i] = doc.document_key
        segments[i] = doc.segment_number
        deleted[i] = bool(doc.deleted)
        texts[i] = doc.indexed_text or ""
        ci = doc.document_client_information
        if ci is not None:
            any_client_info = True
        client_info[i] = ci
        key_field_names[i] = doc.fields.name_of_document_key_field or ""
        flist = doc.fields.get_field_list()
        field_counts[i] = len(flist)
        for f in flist:
            nid = name_ids_of.get(f.name)
            if nid is None:
                nid = name_ids_of[f.name] = len(name_table)
                name_table.append(f.name)
            f_name_ids.append(nid)
            f_weights.append(int(f.weight))
            flags = ((_FF_INDEXABLE if f.indexable else 0)
                     | (_FF_FILTERABLE if f.filterable else 0)
                     | (_FF_SORTABLE if f.sortable else 0)
                     | (_FF_FACETABLE if f.facetable else 0)
                     | (_FF_WORD_INDEXING if f.word_indexing else 0)
                     | (_FF_OPTIONAL if f.optional else 0)
                     | (_FF_IS_ARRAY if f.is_array else 0)
                     | (_FF_PRELOAD if f.preload_filters else 0))
            f_flags.append(flags)
            f_wfloats.append(np.nan if f.weight_as_float is None
                             else float(f.weight_as_float))
            v = f.value
            if v is None:
                f_vkinds.append(0)
            elif v is True:
                f_vkinds.append(4)
            elif v is False:
                f_vkinds.append(5)
            elif type(v) is str:
                if v == doc.indexed_text:
                    # single-content-field case: the value IS the indexed
                    # text already stored in the texts column
                    f_vkinds.append(7)
                else:
                    f_vkinds.append(1)
                    f_vstrs.append(v)
            elif isinstance(v, int):
                f_vkinds.append(2)
                f_vints.append(v)
            elif isinstance(v, float):
                f_vkinds.append(3)
                f_vfloats.append(v)
            else:
                f_vkinds.append(6)
                f_vother.append(v)

    uniform_kfn = key_field_names and all(
        k == key_field_names[0] for k in key_field_names)
    return {
        "keys": keys, "segments": segments, "deleted": deleted,
        "texts": texts,
        "client_info": client_info if any_client_info else None,
        "key_field_names": (key_field_names[0] if uniform_kfn
                            else key_field_names),
        "field_counts": field_counts,
        "field_name_table": name_table,
        "field_name_ids": np.asarray(f_name_ids, np.int32),
        "field_weights": np.asarray(f_weights, np.int8),
        "field_flags": np.asarray(f_flags, np.uint8),
        "field_weight_floats": np.asarray(f_wfloats, np.float64),
        "field_value_kinds": np.asarray(f_vkinds, np.uint8),
        "field_value_strs": f_vstrs,
        "field_value_ints": np.asarray(f_vints, np.int64),
        "field_value_floats": np.asarray(f_vfloats, np.float64),
        "field_value_other": f_vother,
    }


def _restore_doc_columns(model, cols) -> None:
    """Rebuild the document collection from the columnar image."""
    from ..api.fields import DocumentFields, Field, JsonKind, Weight
    from ..core.documents import Document

    keys = cols["keys"].tolist()
    segments = cols["segments"].tolist()
    deleted = cols["deleted"].tolist()
    texts = cols["texts"]
    n = len(keys)
    client_info = cols["client_info"] or ([None] * n)
    kfn = cols["key_field_names"]
    uniform_kfn = isinstance(kfn, str)
    field_counts = cols["field_counts"].tolist()
    name_table = cols["field_name_table"]
    f_name_ids = cols["field_name_ids"].tolist()
    f_weights = cols["field_weights"].tolist()
    f_flags = cols["field_flags"].tolist()
    f_wfloats = cols["field_weight_floats"]
    # NaN != NaN would defeat the prototype cache: key on the bit pattern
    f_wf_bits = f_wfloats.view(np.int64).tolist()
    f_vkinds = cols["field_value_kinds"].tolist()
    it_strs = iter(cols["field_value_strs"])
    it_ints = iter(cols["field_value_ints"].tolist())
    it_floats = iter(cols["field_value_floats"].tolist())
    it_other = iter(cols["field_value_other"])

    weight_of = {int(w): Weight(int(w)) for w in (0, 1, 2)}
    kind_of = {0: JsonKind.NULL, 1: JsonKind.STRING, 2: JsonKind.NUMBER,
               3: JsonKind.NUMBER, 4: JsonKind.TRUE, 5: JsonKind.FALSE,
               7: JsonKind.STRING}
    # Field-attribute prototypes: most fields share (name, weight, flags,
    # wfloat, kind); one dict copy per field beats rebuilding 13 kwargs.
    proto_of: dict = {}

    collection = model.documents
    docs_list = collection._documents
    key_to_ids = collection._key_to_ids
    base = len(docs_list)
    fpos = 0
    from ..api.fields import _infer_kind

    for i in range(n):
        doc = Document.__new__(Document)
        doc.id = base + i
        doc.document_key = keys[i]
        doc.segment_number = segments[i]
        doc.indexed_text = texts[i]
        doc.document_client_information = client_info[i]
        doc.reserved = ""
        doc.json_index = 0
        doc.deleted = bool(deleted[i])
        doc._norm_cache = None
        fields = DocumentFields.__new__(DocumentFields)
        fields.name_of_document_key_field = kfn if uniform_kfn else kfn[i]
        fdict = {}
        for _ in range(field_counts[i]):
            kind = f_vkinds[fpos]
            if kind == 0:
                value = None
            elif kind == 1:
                value = next(it_strs)
            elif kind == 2:
                value = next(it_ints)
            elif kind == 3:
                value = next(it_floats)
            elif kind == 4:
                value = True
            elif kind == 5:
                value = False
            elif kind == 7:
                value = texts[i]
            else:
                value = next(it_other)
            pkey = (f_name_ids[fpos], f_weights[fpos], f_flags[fpos],
                    f_wf_bits[fpos], kind)
            proto = proto_of.get(pkey)
            if proto is None:
                flags = f_flags[fpos]
                wf = float(f_wfloats[fpos])
                proto = proto_of[pkey] = dict(
                    name=name_table[f_name_ids[fpos]],
                    value=None,
                    weight=weight_of[f_weights[fpos]],
                    indexable=bool(flags & _FF_INDEXABLE),
                    filterable=bool(flags & _FF_FILTERABLE),
                    sortable=bool(flags & _FF_SORTABLE),
                    facetable=bool(flags & _FF_FACETABLE),
                    word_indexing=bool(flags & _FF_WORD_INDEXING),
                    optional=bool(flags & _FF_OPTIONAL),
                    is_array=bool(flags & _FF_IS_ARRAY),
                    weight_as_float=None if wf != wf else wf,
                    preload_filters=bool(flags & _FF_PRELOAD),
                    type=(kind_of.get(kind)
                          if kind != 6 else None),
                )
            fld = Field.__new__(Field)
            d = dict(proto)
            d["value"] = value
            if d["type"] is None:
                d["type"] = _infer_kind(value)
            fld.__dict__ = d
            fdict[d["name"]] = fld
            fpos += 1
        fields._fields = fdict
        doc.fields = fields

        docs_list.append(doc)
        if not doc.deleted:
            collection.count += 1
        ids = key_to_ids.setdefault(doc.document_key, None)
        if ids is None:
            key_to_ids[doc.document_key] = [doc.id]
            if doc.segment_number > 0:
                collection.multi_segment = True
        else:
            ids.append(doc.id)
            collection.multi_segment = True


def _encode_postings_gvi(docs: np.ndarray, offsets) -> "Optional[bytes]":
    """Per-term delta transform + GroupVarInt bytes, or None if the
    native codec is unavailable. Within each term the first doc id is
    absolute and the rest are (sorted, non-negative) gaps, so one global
    cumsum with per-term base subtraction inverts it exactly."""
    try:
        from .. import native as _nat
        if not _nat.available:
            return None
    except Exception:
        return None
    if docs.size == 0:
        return b""
    vals = docs.astype(np.int64)
    vals[1:] = vals[1:] - docs[:-1].astype(np.int64)
    starts = np.asarray(offsets[:-1], np.int64)
    lens = np.asarray(offsets, np.int64)
    lens = lens[1:] - lens[:-1]
    starts = starts[lens > 0]
    vals[starts] = docs[starts]          # restart: absolute at term start
    if vals.min() < 0:                   # unsorted postings: bail out
        return None
    from ..native import gvi_encode

    return gvi_encode(vals.astype(np.uint32))


def _decode_postings_gvi(blob: bytes, count: int, offsets) -> np.ndarray:
    from ..native import gvi_decode

    vals = gvi_decode(blob, count)[0].astype(np.int64)
    if count == 0:
        return np.zeros(0, np.int32)
    c = np.cumsum(vals)
    starts = np.asarray(offsets[:-1], np.int64)
    lens = np.asarray(offsets, np.int64)
    lens = lens[1:] - lens[:-1]
    live = lens > 0
    starts, lens = starts[live], lens[live]
    # base for term t = cumsum just before its first element, minus the
    # absolute restart value already present in c
    base = np.where(starts > 0, c[starts - 1], 0)
    docs = c - np.repeat(base, lens)
    return docs.astype(np.int32)


def _word_table_columns(table: dict) -> dict:
    """word -> doc-id array dict, flattened columnar: at 40k docs the
    LD1 table holds ~10^5 tiny arrays whose per-entry codec headers
    cost more than the ids; one STRLIST + one concat array does not."""
    words = list(table.keys())
    counts = np.asarray([len(table[w]) for w in words], np.int32)
    ids = (np.concatenate([np.asarray(table[w], np.int64) for w in words])
           if words else np.zeros(0, np.int64)).astype(np.int32)
    return {"__cols__": True, "words": words, "counts": counts, "ids": ids}


def _word_table_restore(cols) -> dict:
    if not (isinstance(cols, dict) and cols.get("__cols__")):
        return cols  # legacy plain dict
    out = {}
    ids = cols["ids"]
    pos = 0
    for w, c in zip(cols["words"], cols["counts"].tolist()):
        out[w] = ids[pos:pos + c]
        pos += c
    return out


def _wm_state_encodable(state: dict) -> dict:
    """WordMatcher state with the setup dataclass flattened to a dict
    and the word->ids tables columnarized."""
    state = dict(state)
    setup = state.get("setup")
    if setup is not None and dataclasses.is_dataclass(setup):
        state["setup"] = dataclasses.asdict(setup)
    for key in ("exact", "ld1", "affix"):
        if isinstance(state.get(key), dict) and "__cols__" not in state[key]:
            state[key] = _word_table_columns(state[key])
    return state


def _wm_state_decoded(state: dict) -> dict:
    state = dict(state)
    for key in ("exact", "ld1", "affix"):
        if key in state:
            state[key] = _word_table_restore(state[key])
    return state


def save_engine(engine, file_path: str) -> None:
    model = engine.vector_model
    model.materialize_segments()   # snapshots persist the unified image
    if model.built is None:
        model.build_inverted_lists()

    # Persist the UNIFIED vocabulary (memory + any flushed segments): a
    # loaded engine is a consolidated in-memory index, mirroring the
    # reference's save of the memory image.
    term_state = list(model.built.terms)
    term_dfs = np.asarray(model.built.df, np.int64)

    payload = {
        "version": VERSION,
        "engine_config": engine._engine_config,
        "doc_cols": _doc_columns(model.documents),
        "terms": term_state,
        "term_dfs": term_dfs,
        "term_offsets": model.built.term_offsets,
        "postings_weights": model.built.postings_weights,
        # v5: the WordMatcher exact/LD1/affix tables and the positional
        # prefix index are NOT persisted — they are pure functions of the
        # document texts and are re-derived on load (the reference likewise
        # derives its WordMatcher lookups from the FST image at load,
        # WordMatcher/WordMatcher.cs:124-164, and champion lists at freeze,
        # ShortQueryResolver.cs:113-204). This is what gets the 40k-title
        # snapshot under the reference's <5MB headline (README.md:497).
        "derived_tables": True,
        "short_query_index": (
            {"min": model.short_query_index.min_prefix_length,
             "max": model.short_query_index.max_prefix_length}
            if model.short_query_index is not None else None),
        "word_matcher": (
            {"setup": dataclasses.asdict(engine.word_matcher._setup)}
            if engine.word_matcher is not None else None),
        "schema": (_doc_state_schema(engine.document_field_schema)
                   if engine.document_field_schema is not None else None),
        "synonyms": (engine.synonym_map.state_dict()
                     if engine.synonym_map is not None else None),
    }

    # Posting doc ids: per-term delta + GroupVarInt via the native codec
    # (reference stores block-compressed postings too — README.md:497's
    # "<5MB for 40k titles" depends on it). Falls back to the raw array
    # when the native library is unavailable.
    docs_arr = np.ascontiguousarray(model.built.postings_docs, np.int32)
    gvi = _encode_postings_gvi(docs_arr, model.built.term_offsets)
    if gvi is not None:
        payload["postings_docs_gvi"] = gvi
        payload["postings_count"] = int(docs_arr.size)
    else:
        payload["postings_docs"] = docs_arr

    # v5: deflate the payload (level 1: ~2.8x smaller at >50MB/s on one
    # core — 40k snapshot 5.45MB -> 1.9MB, under the reference's <5MB
    # headline; README.md:497). CRC covers the compressed stream.
    blob = zlib.compress(_codec_encode(payload), 1)
    checksum = zlib.crc32(blob) & 0xFFFFFFFF
    with open(file_path, "wb") as fh:
        fh.write(MAGIC)
        fh.write(struct.pack("<II", VERSION, checksum))
        fh.write(struct.pack("<Q", len(blob)))
        fh.write(blob)


def _doc_state_schema(schema):
    dummy = type("D", (), {})()
    dummy.fields = schema
    dummy.document_key = 0
    dummy.segment_number = 0
    dummy.indexed_text = ""
    dummy.document_client_information = None
    dummy.deleted = False
    return _doc_state(dummy)


def _derive_query_tables(engine, model) -> None:
    """Rebuild the WordMatcher exact/LD1/affix maps and the positional
    prefix index from document texts (v5 snapshots omit them).

    Uses the native bulk builder's WM/SQ passes with empty main texts (no
    term/posting work) when available; the Python per-doc path otherwise.
    Output is identical to index-time construction — both are the same
    code paths the live indexer uses (parity: test_bulk_build_parity.py,
    test_persistence_parity.py)."""
    wm = engine.word_matcher
    sq = model.short_query_index
    if wm is None and sq is None:
        return
    docs = model.documents
    n = docs.total_slots()

    native_ok = False
    try:
        from ..native.bulk import BulkIndexer, bulk_available

        native_ok = bulk_available()
    except Exception:
        native_ok = False

    if native_ok:
        setup = model.tokenizer.tokenizer_setup
        delims = setup.delimiters if setup else (" ",)
        remove_dups = setup.remove_duplicate_tokens if setup else True
        indexer = BulkIndexer(
            model.tokenizer.index_sizes, model.tokenizer.start_pad_size,
            model.tokenizer.stop_pad_size, delims, remove_dups,
            model.stop_term_limit, model.field_weights,
            wm_setup=wm._setup if wm is not None else None,
            sq_minmax=((sq.min_prefix_length, sq.max_prefix_length)
                       if sq is not None else None))
        try:
            chunk = 8192
            for lo in range(0, n, chunk):
                ids, sqs, wms = [], [], []
                for i in range(lo, min(lo + chunk, n)):
                    doc = docs.get_document(i)
                    if doc is None:
                        continue
                    text = doc.indexed_text or ""
                    sqs.append(model.normalize_doc_text(text)
                               if sq is not None else "")
                    wms.append(wm._normalize(text) if wm is not None else "")
                    ids.append(doc.id)
                if not ids:
                    continue
                indexer.add_chunk([""] * len(ids), sqs, wms, ids,
                                  [False] * len(ids), [[] for _ in ids])
            if wm is not None:
                wm.load_bulk(indexer.export_wm(0), indexer.export_wm(1),
                             indexer.export_wm(2))
                wm.finalize_index()
            if sq is not None:
                sq.load_bulk(indexer.export_sq())
        finally:
            indexer.close()
        return

    for i in range(n):
        doc = docs.get_document(i)
        if doc is None:
            continue
        text = doc.indexed_text or ""
        if wm is not None:
            wm.load(text, doc.id)
        if sq is not None:
            sq.index_document(model.normalize_doc_text(text), doc.id)
    if wm is not None:
        wm.finalize_index()
    if sq is not None:
        sq.freeze()


def load_engine(file_path: str, **engine_kwargs):
    from ..engine import SearchEngine, SearchEngineStatus

    with open(file_path, "rb") as fh:
        magic = fh.read(len(MAGIC))
        if magic != MAGIC:
            raise IndexFormatError(f"bad magic: {magic!r}")
        version, checksum = struct.unpack("<II", fh.read(8))
        if version not in _READABLE:
            raise IndexFormatError(f"unsupported version {version}")
        (length,) = struct.unpack("<Q", fh.read(8))
        blob = fh.read(length)
        if (zlib.crc32(blob) & 0xFFFFFFFF) != checksum:
            raise IndexFormatError("checksum mismatch: index file is corrupt")
        try:
            if version >= 5:
                blob = zlib.decompress(blob)
            payload = _codec_decode(blob)
        except CodecError as exc:
            raise IndexFormatError(f"malformed index payload: {exc}") from exc
        except zlib.error as exc:
            raise IndexFormatError(f"malformed index payload: {exc}") from exc

    cfg = dict(payload["engine_config"])
    cfg.update(engine_kwargs)

    from ..core.config import WordMatcherSetup

    has_wm = payload["word_matcher"] is not None
    wm_setup = cfg.pop("word_matcher_setup", None)
    if has_wm and wm_setup is None:
        stored = payload["word_matcher"]["setup"]
        if isinstance(stored, dict):
            stored = WordMatcherSetup(**stored)
        wm_setup = stored
    if not has_wm and wm_setup is not None:
        raise IndexFormatError("index file is missing required WordMatcher data")

    engine = SearchEngine(word_matcher_setup=wm_setup, **cfg)
    engine.status = SearchEngineStatus.LOADING
    model = engine.vector_model

    # Restore documents
    if "doc_cols" in payload:
        _restore_doc_columns(model, payload["doc_cols"])
    else:  # version 3
        for state in payload["documents"]:
            model.documents.add_document(_restore_doc(state))

    # Restore terms + raw postings from the CSR image. Postings stay as
    # array views over the CSR buffers (zero copies); the incremental
    # write path converts a term's views to mutable lists on first append
    # (builder.Posting.add).
    offsets = payload["term_offsets"]
    if "postings_docs_gvi" in payload:
        docs = _decode_postings_gvi(payload["postings_docs_gvi"],
                                    int(payload["postings_count"]), offsets)
    else:
        docs = np.ascontiguousarray(payload["postings_docs"])
    weights = np.ascontiguousarray(payload["postings_weights"])
    if "term_dfs" in payload:
        terms = payload["terms"]
        dfs = payload["term_dfs"].tolist()
    else:  # version 3: list of (term, df) tuples
        terms = [t for t, _ in payload["terms"]]
        dfs = [df for _, df in payload["terms"]]
    model.term_dict.load_csr_image(terms, dfs, offsets, docs, weights)

    derive_tables = bool(payload.get("derived_tables"))
    sq_state = payload["short_query_index"]
    if sq_state is not None and model.short_query_index is not None:
        if derive_tables:
            model.short_query_index.min_prefix_length = sq_state["min"]
            model.short_query_index.max_prefix_length = sq_state["max"]
        else:
            model.short_query_index.load_state_dict(sq_state)

    if has_wm and engine.word_matcher is None:
        raise IndexFormatError(
            "index contains WordMatcher data but engine is configured without it")
    if has_wm and not derive_tables:
        engine.word_matcher.load_state_dict(
            _wm_state_decoded(payload["word_matcher"]))

    if payload.get("schema") is not None:
        engine._document_field_schema = _restore_doc(payload["schema"]).fields

    if payload.get("synonyms") is not None:
        from ..synonyms import SynonymMap

        sm = SynonymMap()
        sm.load_state_dict(payload["synonyms"])
        engine._synonym_map = sm
        model.synonym_map = sm

    if derive_tables:
        _derive_query_tables(engine, model)

    # Rebuild ALL derived statistics, exactly like SearchEngine.Load
    # (doc lengths, avgdl, idf caches, device tensors, metadata cache).
    model.calculate_weights()
    model.build_optimized_indexes()
    engine._rebuild_short_query_resolver()
    engine._mark_indexed()
    engine.status = SearchEngineStatus.READY
    return engine
