"""Document model and collection.

Behavioral reference: Infidex ``Core/Document.cs`` and
``Core/DocumentCollection.cs``: a document has a dense internal int ``id``,
a public 64-bit ``document_key`` (aliases allowed: one key -> many docs /
segments), a ``segment_number`` for long texts split into parts, soft
deletion, and a ``DocumentFields`` bag.
"""

from __future__ import annotations

from typing import Dict, List, Optional

from ..api.fields import DocumentFields


class Document:
    __slots__ = (
        "id", "document_key", "segment_number", "fields", "indexed_text",
        "document_client_information", "reserved", "json_index", "deleted",
        "_norm_cache",
    )

    def __init__(
        self,
        document_key: int,
        text_or_fields=None,
        segment_number: int = 0,
        document_client_information: Optional[str] = None,
    ):
        self.id: int = -1
        self.document_key = int(document_key)
        self.segment_number = int(segment_number)
        self.indexed_text: str = ""
        self.document_client_information = document_client_information
        self.reserved: str = ""
        self.json_index: int = 0
        self.deleted: bool = False
        # (normalizer id, normalized indexed_text) — hot-path memo; the
        # indexed text is immutable once set, so per-candidate search-time
        # normalization would be pure rework.
        self._norm_cache = None

        if isinstance(text_or_fields, DocumentFields):
            self.fields = text_or_fields
        else:
            self.fields = DocumentFields()
            if text_or_fields is not None:
                self.fields.add_field("content", str(text_or_fields))

    def __repr__(self) -> str:
        preview = (self.indexed_text or "")[:50]
        return f"Doc {self.document_key}:{self.segment_number} - {preview}"


class DocumentCollection:
    """Dense-id document store with key->ids alias map."""

    def __init__(self) -> None:
        self._documents: List[Document] = []
        self._key_to_ids: Dict[int, List[int]] = {}
        self.count: int = 0  # non-deleted count
        # True once any key maps to >1 internal doc (long-doc segmentation)
        # — the vectorized pipeline fast path requires the 1:1 id<->key case.
        self.multi_segment: bool = False
        # Bumped on every deletion/compaction: the append-only fast
        # finalize (index/append.py) extends its deleted-flag mirror
        # instead of re-scanning 10^6 Document objects, which is only
        # sound while no existing row's flag changed underneath it.
        self.mutation_epoch: int = 0

    def add_document(self, document: Document) -> Document:
        doc_id = len(self._documents)
        document.id = doc_id
        self._documents.append(document)
        if not document.deleted:
            self.count += 1
        ids = self._key_to_ids.setdefault(document.document_key, [])
        ids.append(doc_id)
        if len(ids) > 1 or document.segment_number > 0:
            self.multi_segment = True
        return document

    def get_document(self, doc_id: int) -> Optional[Document]:
        if 0 <= doc_id < len(self._documents):
            return self._documents[doc_id]
        return None

    def get_documents_by_key(self, document_key: int) -> List[Document]:
        ids = self._key_to_ids.get(document_key, [])
        return [d for d in (self._documents[i] for i in ids) if not d.deleted]

    def get_document_by_public_key(self, document_key: int) -> Optional[Document]:
        docs = self.get_documents_by_key(document_key)
        return docs[0] if docs else None

    def first_live_id(self, document_key: int) -> Optional[int]:
        """Internal id of the first non-deleted doc for ``document_key``
        — the row ``get_document_by_public_key`` resolves to. Columnar
        facet/filter paths use this to map result entries onto
        ColumnStore rows without materializing Document objects."""
        for i in self._key_to_ids.get(document_key, ()):
            if not self._documents[i].deleted:
                return i
        return None

    def get_documents_for_public_key(self, document_key: int) -> List[Document]:
        """All docs for key, including deleted (segment consolidation path)."""
        ids = self._key_to_ids.get(document_key, [])
        return [self._documents[i] for i in ids]

    def get_document_of_segment(self, document_key: int, segment_number: int) -> Optional[Document]:
        for i in self._key_to_ids.get(document_key, []):
            d = self._documents[i]
            if d.segment_number == segment_number:
                return d
        return None

    def delete_documents_by_key(self, document_key: int) -> None:
        for d in self.get_documents_by_key(document_key):
            if not d.deleted:
                d.deleted = True
                self.count -= 1
                self.mutation_epoch += 1

    def remove_deleted_documents(self) -> None:
        if not any(d.deleted for d in self._documents):
            return
        compacted: List[Document] = []
        new_map: Dict[int, List[int]] = {}
        for d in self._documents:
            if d.deleted:
                continue
            d.id = len(compacted)
            compacted.append(d)
            new_map.setdefault(d.document_key, []).append(d.id)
        self._documents = compacted
        self._key_to_ids = new_map
        self.count = len(compacted)
        self.mutation_epoch += 1

    def all_documents(self) -> List[Document]:
        return [d for d in self._documents if not d.deleted]

    def __len__(self) -> int:
        return len(self._documents)

    def total_slots(self) -> int:
        """Number of internal id slots including deleted docs."""
        return len(self._documents)

    def clear(self) -> None:
        self._documents.clear()
        self._key_to_ids.clear()
        self.count = 0
        self.mutation_epoch += 1
