"""Incremental indexing: delta buffer, tombstones, merge-into-main.

Behavioral reference: Infidex ``Indexing/Incremental/*`` — ``DeltaIndex``
(an in-memory delta with its own term/doc collections + tombstone set),
``TombstoneTracker`` (deleted document keys), and ``IndexMerger`` (merges
the delta into the main index, auto-merge threshold 1000). The reference's
live incremental path re-runs BuildInvertedLists over accumulated postings
(SearchEngine.cs:165-185); these classes provide the structured delta the
inventory calls for, wired through ``SearchEngine.index_document`` +
``calculate_weights`` and usable standalone.

TPU note: a delta merge is a repack — the unified CSR is rebuilt and
re-uploaded; tombstones become zero rows in the device live-mask without
any repack at all.
"""

from __future__ import annotations

import threading
from typing import Dict, List, Optional, Set

from ..core.documents import Document

AUTO_MERGE_THRESHOLD = 1000


class TombstoneTracker:
    """Deleted document keys (Incremental/TombstoneTracker.cs)."""

    def __init__(self) -> None:
        self._deleted_keys: Set[int] = set()
        self._lock = threading.Lock()

    def add(self, document_key: int) -> None:
        with self._lock:
            self._deleted_keys.add(document_key)

    def remove(self, document_key: int) -> None:
        with self._lock:
            self._deleted_keys.discard(document_key)

    def is_deleted(self, document_key: int) -> bool:
        with self._lock:
            return document_key in self._deleted_keys

    @property
    def count(self) -> int:
        with self._lock:
            return len(self._deleted_keys)

    def keys(self) -> Set[int]:
        with self._lock:
            return set(self._deleted_keys)

    def clear(self) -> None:
        with self._lock:
            self._deleted_keys.clear()


class DeltaIndex:
    """In-memory accumulation of not-yet-merged documents + tombstones."""

    def __init__(self, auto_merge_threshold: int = AUTO_MERGE_THRESHOLD):
        self._documents: List[Document] = []
        self._tombstones = TombstoneTracker()
        self._lock = threading.Lock()
        self.auto_merge_threshold = auto_merge_threshold

    def add_document(self, document: Document) -> None:
        # A pending tombstone for the same key stays: it deletes the MAIN
        # index copy at merge time; the new delta doc supersedes it.
        with self._lock:
            self._documents.append(document)

    def delete_document(self, document_key: int) -> None:
        with self._lock:
            self._documents = [d for d in self._documents
                               if d.document_key != document_key]
        self._tombstones.add(document_key)

    @property
    def pending_count(self) -> int:
        with self._lock:
            return len(self._documents)

    @property
    def tombstones(self) -> TombstoneTracker:
        return self._tombstones

    def needs_merge(self) -> bool:
        return self.pending_count >= self.auto_merge_threshold

    def drain(self) -> List[Document]:
        with self._lock:
            docs = self._documents
            self._documents = []
            return docs


class IndexMerger:
    """Merges a DeltaIndex into a SearchEngine (Incremental/IndexMerger.cs).

    Tombstoned keys are soft-deleted (device live-mask update, no repack);
    pending documents are indexed and derived stats rebuilt once.
    """

    def __init__(self, engine, delta: Optional[DeltaIndex] = None):
        self._engine = engine
        self.delta = delta or DeltaIndex()

    def add(self, document: Document) -> None:
        self.delta.add_document(document)
        if self.delta.needs_merge():
            self.merge()

    def delete(self, document_key: int) -> None:
        self.delta.delete_document(document_key)

    def merge(self) -> int:
        """Apply tombstones + pending docs; returns number merged."""
        docs = self.delta.drain()
        for key in self.delta.tombstones.keys():
            self._engine.delete_documents(key)
        self.delta.tombstones.clear()
        if docs:
            for doc in docs:
                self._engine.index_document(doc)
            self._engine.calculate_weights()
        return len(docs)
