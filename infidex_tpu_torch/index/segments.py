"""On-disk index segments: block postings, memory-mapped read, k-way merge.

Behavioral reference: Infidex ``Indexing/Segments/*`` —
``BlockPostingsWriter.cs:26-116``: variable blocks of 64-256 docs with a
density-adaptive flush (a block is closed early when its doc-id spread
exceeds 8x its count), each block GroupVarInt-delta encoded with raw byte
weights, followed by a skip table of per-block
(min_doc, max_doc, count, max_weight, offset) entries — the per-block
max-weight is the max-score pruning metadata (Bm25Scorer.cs:512-533).
``SegmentReader.cs`` memory-maps the file and serves postings by term
ordinal; ``SegmentMerger.cs`` k-way merges sorted term streams with
doc-base remapping; ``MMapBlockPostingsEnum.cs`` iterates blocks through
the skip table with Advance/NextDoc instrumentation counters.

TPU-native format "IFTS2":

  header   magic 'IFTS2\\0' | version u16 | term_count u32 | doc_count u32 |
           doc_base u32 | body len u64 + crc32
  terms    length-prefixed UTF-8 term strings (sorted), plus df i32[T]
  offsets  per-term byte offsets i64[T+1] into the postings section
  postings per term: n_blocks u16, skip table (min u32, max u32, count u16,
           max_weight u8, pad u8, offset-in-term u32) x n_blocks, then the
           blocks: GroupVarInt(delta doc ids, first delta from 0) + raw
           weight bytes per block

Doc ids inside a segment are segment-relative; readers add ``doc_base``.
Blocks decode independently (each starts its delta chain at zero), so a
reader can jump via the skip table without touching earlier blocks.
"""

from __future__ import annotations

import mmap
import os
import struct
import zlib
from bisect import bisect_left, bisect_right
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np

from ..utils.compression import (delta_decode, delta_encode,
                                 group_varint_decode, group_varint_encode)
from .postings_enum import NO_MORE_DOCS, PostingsEnum

MAGIC = b"IFTS2\x00"
VERSION = 2

# BlockPostingsWriter.cs:53-71 block shaping
BLOCK_MIN = 64
BLOCK_MAX = 256
BLOCK_SPREAD_FACTOR = 8

_SKIP_ENTRY = struct.Struct("<IIHBBI")  # min, max, count, max_w, pad, offset


def _encode_term_postings(doc_ids: List[int], weights: List[int]) -> bytes:
    """One term's block-encoded postings + skip table."""
    n = len(doc_ids)
    blocks: List[Tuple[int, int]] = []  # (start, end) into doc_ids
    start = 0
    while start < n:
        end = start + 1
        block_min = doc_ids[start]
        while end < n and (end - start) < BLOCK_MAX:
            count = end - start
            spread = doc_ids[end] - block_min
            # density-adaptive flush: close sparse blocks early once they
            # reach the minimum size (BlockPostingsWriter.cs:53-71)
            if count >= BLOCK_MIN and spread > BLOCK_SPREAD_FACTOR * count:
                break
            end += 1
        blocks.append((start, end))
        start = end

    skip_entries = []
    chunks: List[bytes] = []
    pos = 2 + _SKIP_ENTRY.size * len(blocks)
    for s, e in blocks:
        block_docs = np.asarray(doc_ids[s:e], dtype=np.int64)
        enc = group_varint_encode(delta_encode(block_docs).tolist())
        w = bytes(int(x) & 0xFF for x in weights[s:e])
        chunk = struct.pack("<i", len(enc)) + enc + w
        skip_entries.append(_SKIP_ENTRY.pack(
            int(block_docs[0]), int(block_docs[-1]), e - s,
            max(int(x) & 0xFF for x in weights[s:e]) if e > s else 0,
            0, pos))
        chunks.append(chunk)
        pos += len(chunk)
    return (struct.pack("<H", len(blocks)) + b"".join(skip_entries)
            + b"".join(chunks))


class SegmentWriter:
    """Writes a sorted-term block-postings segment file."""

    def write_segment(self, terms_postings: Dict[str, Tuple[List[int], List[int]]],
                      doc_count: int, doc_base: int, path: str) -> None:
        """terms_postings: term -> (doc_ids ascending, byte weights)."""
        terms = sorted(terms_postings.keys())
        T = len(terms)

        term_chunks = []
        for t in terms:
            raw = t.encode("utf-8", "surrogatepass")
            term_chunks.append(struct.pack("<i", len(raw)) + raw)
        term_blob = b"".join(term_chunks)

        dfs = np.zeros(T, dtype=np.int32)
        offsets = np.zeros(T + 1, dtype=np.int64)
        postings_chunks: List[bytes] = []
        pos = 0
        for i, t in enumerate(terms):
            doc_ids, weights = terms_postings[t]
            dfs[i] = len(doc_ids)
            rel = [int(d) - doc_base for d in doc_ids]
            chunk = _encode_term_postings(rel, list(weights))
            postings_chunks.append(chunk)
            pos += len(chunk)
            offsets[i + 1] = pos

        postings_blob = b"".join(postings_chunks)
        body = (
            struct.pack("<q", len(term_blob)) + term_blob +
            dfs.tobytes() + offsets.tobytes() + postings_blob
        )
        crc = zlib.crc32(body) & 0xFFFFFFFF
        header = MAGIC + struct.pack(
            "<HIIIQI", VERSION, T, doc_count, doc_base, len(body), crc)
        with open(path, "wb") as fh:
            fh.write(header)
            fh.write(body)


class SegmentReader:
    """Memory-mapped segment with sorted-term binary search."""

    def __init__(self, path: str):
        self.path = path
        self._file = open(path, "rb")
        self._mm = mmap.mmap(self._file.fileno(), 0, access=mmap.ACCESS_READ)
        if self._mm[: len(MAGIC)] != MAGIC:
            raise ValueError(f"bad segment magic in {path}")
        (version, term_count, doc_count, doc_base, body_len, crc) = \
            struct.unpack_from("<HIIIQI", self._mm, len(MAGIC))
        if version != VERSION:
            raise ValueError(f"unsupported segment version {version}")
        self.term_count = term_count
        self.doc_count = doc_count
        self.doc_base = doc_base
        header_len = len(MAGIC) + struct.calcsize("<HIIIQI")
        body = bytes(self._mm[header_len : header_len + body_len])
        if (zlib.crc32(body) & 0xFFFFFFFF) != crc:
            raise ValueError(f"segment checksum mismatch in {path}")

        off = header_len
        (term_blob_len,) = struct.unpack_from("<q", self._mm, off)
        off += 8
        terms: List[str] = []
        end = off + term_blob_len
        while off < end:
            (n,) = struct.unpack_from("<i", self._mm, off)
            off += 4
            terms.append(bytes(self._mm[off : off + n]).decode(
                "utf-8", "surrogatepass"))
            off += n
        self.terms = terms
        if len(self.terms) != term_count:
            raise ValueError(
                f"segment vocabulary misaligned in {path}: "
                f"{len(self.terms)} terms decoded, header says {term_count}")
        self.dfs = np.frombuffer(self._mm, np.int32, term_count, off).copy()
        off += term_count * 4
        self.offsets = np.frombuffer(
            self._mm, np.int64, term_count + 1, off).copy()
        off += (term_count + 1) * 8
        self._postings_base = off

    # ------------------------------------------------------------------
    def term_index(self, term: str) -> int:
        i = bisect_left(self.terms, term)
        if i < len(self.terms) and self.terms[i] == term:
            return i
        return -1

    def get_df(self, term: str) -> int:
        i = self.term_index(term)
        return int(self.dfs[i]) if i >= 0 else 0

    def block_table(self, ordinal: int):
        """The term's skip table: arrays (min_doc, max_doc, count,
        max_weight, offset) — segment-relative doc ids. The per-block
        max_weight is the max-score pruning bound (Bm25Scorer.cs:512-533,
        BlockPostingsWriter.cs:53-71)."""
        base = self._postings_base + int(self.offsets[ordinal])
        (n_blocks,) = struct.unpack_from("<H", self._mm, base)
        mins = np.zeros(n_blocks, np.int64)
        maxs = np.zeros(n_blocks, np.int64)
        counts = np.zeros(n_blocks, np.int32)
        max_w = np.zeros(n_blocks, np.uint8)
        offs = np.zeros(n_blocks, np.int64)
        pos = base + 2
        for b in range(n_blocks):
            mn, mx, cnt, mw, _pad, rel = _SKIP_ENTRY.unpack_from(self._mm, pos)
            mins[b], maxs[b], counts[b], max_w[b] = mn, mx, cnt, mw
            offs[b] = base + rel
            pos += _SKIP_ENTRY.size
        return mins, maxs, counts, max_w, offs

    def decode_block(self, block_offset: int, count: int,
                     absolute: bool = True) -> Tuple[np.ndarray, np.ndarray]:
        """Decode one block at its absolute file offset."""
        (enc_len,) = struct.unpack_from("<i", self._mm, block_offset)
        enc = bytes(self._mm[block_offset + 4 : block_offset + 4 + enc_len])
        deltas, _ = group_varint_decode(enc, count)
        doc_ids = delta_decode(deltas)
        if absolute:
            doc_ids = doc_ids + self.doc_base
        w_start = block_offset + 4 + enc_len
        weights = np.frombuffer(self._mm, np.uint8, count, w_start).copy()
        return doc_ids.astype(np.int64), weights

    def get_postings(self, term: str,
                     absolute: bool = True) -> Optional[Tuple[np.ndarray, np.ndarray]]:
        i = self.term_index(term)
        if i < 0:
            return None
        return self.get_postings_by_ordinal(i, absolute)

    def get_postings_by_ordinal(self, ordinal: int,
                                absolute: bool = True) -> Tuple[np.ndarray, np.ndarray]:
        mins, maxs, counts, max_w, offs = self.block_table(ordinal)
        if mins.size == 0:
            return np.zeros(0, np.int64), np.zeros(0, np.uint8)
        parts = [self.decode_block(int(offs[b]), int(counts[b]), absolute)
                 for b in range(mins.size)]
        return (np.concatenate([p[0] for p in parts]),
                np.concatenate([p[1] for p in parts]))

    def postings_enum(self, term: str) -> Optional["BlockPostingsEnum"]:
        """Skip-table iterator over one term (MMapBlockPostingsEnum.cs)."""
        i = self.term_index(term)
        if i < 0:
            return None
        return BlockPostingsEnum(self, i)

    def terms_with_prefix(self, prefix: str, limit: int = 4096) -> List[int]:
        lo = bisect_left(self.terms, prefix)
        hi = bisect_right(self.terms, prefix + "￿")
        return list(range(lo, min(hi, lo + limit)))

    def iter_terms(self) -> Iterator[Tuple[str, int]]:
        for i, t in enumerate(self.terms):
            yield t, i

    def close(self) -> None:
        self._mm.close()
        self._file.close()


class BlockPostingsEnum(PostingsEnum):
    """Block-at-a-time iterator with skip-table Advance and the reference's
    instrumentation counters (MMapBlockPostingsEnum.cs:34-35).

    advance(target) binary-searches the skip table's max_doc column and
    decodes only the destination block; blocks whose max_doc < target are
    never touched."""

    def __init__(self, reader: SegmentReader, ordinal: int):
        self._reader = reader
        mins, maxs, counts, max_w, offs = reader.block_table(ordinal)
        self._mins = mins + reader.doc_base
        self._maxs = maxs + reader.doc_base
        self._counts = counts
        self._max_w = max_w
        self._offs = offs
        self._n_blocks = int(mins.size)
        self._block = -1
        self._docs: Optional[np.ndarray] = None
        self._weights: Optional[np.ndarray] = None
        self._i = -1
        self._cost = int(counts.sum())
        self.next_doc_calls = 0
        self.advance_calls = 0

    def max_weight(self, block: Optional[int] = None) -> int:
        """Per-block max posting weight (max-score bound metadata)."""
        if block is None:
            return int(self._max_w.max()) if self._n_blocks else 0
        return int(self._max_w[block])

    def _load_block(self, b: int) -> None:
        self._block = b
        self._docs, self._weights = self._reader.decode_block(
            int(self._offs[b]), int(self._counts[b]), absolute=True)
        self._i = -1

    def doc(self) -> int:
        if self._block < 0:
            return -1
        if self._block >= self._n_blocks:
            return NO_MORE_DOCS
        if self._i < 0:
            return -1
        if self._i >= self._docs.size:
            return NO_MORE_DOCS
        return int(self._docs[self._i])

    def next_doc(self) -> int:
        self.next_doc_calls += 1
        if self._block < 0:
            if self._n_blocks == 0:
                self._block = 0
                return NO_MORE_DOCS
            self._load_block(0)
        self._i += 1
        while self._i >= self._docs.size:
            if self._block + 1 >= self._n_blocks:
                self._block = self._n_blocks
                return NO_MORE_DOCS
            self._load_block(self._block + 1)
            self._i = 0
        return int(self._docs[self._i])

    def advance(self, target: int) -> int:
        self.advance_calls += 1
        if self._n_blocks == 0 or self._block >= self._n_blocks:
            self._block = max(self._block, self._n_blocks)
            return NO_MORE_DOCS
        b = int(np.searchsorted(self._maxs, target, side="left"))
        if b >= self._n_blocks:
            self._block = self._n_blocks
            return NO_MORE_DOCS
        if b != self._block or self._docs is None:
            self._load_block(b)
        j = int(np.searchsorted(self._docs, target, side="left"))
        self._i = max(j, 0)
        if self._i >= self._docs.size:  # target inside a gap past block end
            return self.next_doc()
        return int(self._docs[self._i])

    def freq(self) -> float:
        if self._weights is None or self._i < 0 or self._i >= self._docs.size:
            return 1.0
        return float(self._weights[self._i])

    def cost(self) -> int:
        return self._cost


def merge_segments(readers: List[SegmentReader], out_path: str,
                   doc_base: int = 0) -> None:
    """K-way merge of sorted term streams with doc-base remapping
    (SegmentMerger.cs semantics)."""
    merged: Dict[str, Tuple[List[int], List[int]]] = {}
    total_docs = sum(r.doc_count for r in readers)
    for reader in readers:
        for term, ordinal in reader.iter_terms():
            doc_ids, weights = reader.get_postings_by_ordinal(ordinal, True)
            entry = merged.setdefault(term, ([], []))
            entry[0].extend(int(d) for d in doc_ids)
            entry[1].extend(int(w) for w in weights)
    # doc ids across segments are disjoint and segment order is doc order,
    # but sort defensively to keep the postings invariant.
    for term, (ids, ws) in merged.items():
        order = np.argsort(np.asarray(ids), kind="stable")
        merged[term] = ([ids[i] for i in order], [ws[i] for i in order])
    SegmentWriter().write_segment(merged, total_docs, doc_base, out_path)
