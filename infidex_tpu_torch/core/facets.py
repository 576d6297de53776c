"""Facet aggregation over result sets.

Behavioral reference: Infidex ``Core/FacetBuilder.cs`` — counts field values
(including array fields) over the result set; sorted by count desc then
value asc; top 100 values per field. The columnar device path (facet counts
as segment-sums over dictionary-encoded attribute tensors) lives in
filtering/columnar.py and is used for large result sets.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

from ..api.fields import DocumentFields
from .documents import DocumentCollection


def _count_field(field_name: str, docs) -> Dict[str, int]:
    counts: Dict[str, int] = {}
    for doc in docs:
        f = doc.fields.get_field(field_name)
        if f is None or f.value is None:
            continue
        if f.is_array and isinstance(f.value, (list, tuple)):
            values = [str(v) for v in f.value if v is not None]
        else:
            values = [str(f.value)]
        for v in values:
            if v:
                counts[v] = counts.get(v, 0) + 1
    return counts


def _sorted_top(counts: Dict[str, int], max_per_field: int) -> List[Tuple[str, int]]:
    return sorted(counts.items(), key=lambda kv: (-kv[1], kv[0]))[:max_per_field]


def build_facets(results, documents: DocumentCollection,
                 field_schema: Optional[DocumentFields],
                 max_facets_per_field: int = 100) -> Dict[str, List[Tuple[str, int]]]:
    facets: Dict[str, List[Tuple[str, int]]] = {}
    if field_schema is None or not results:
        return facets
    facetable = field_schema.get_facetable_field_list()
    if not facetable:
        return facets
    docs = []
    for r in results:
        doc = documents.get_document_by_public_key(r.document_id)
        if doc is not None:
            docs.append(doc)
    for field in facetable:
        counts = _count_field(field.name, docs)
        if counts:
            facets[field.name] = _sorted_top(counts, max_facets_per_field)
    return facets


def build_facets_from_all_documents(documents: DocumentCollection,
                                    field_schema: Optional[DocumentFields],
                                    max_facets_per_field: int = 100
                                    ) -> Dict[str, List[Tuple[str, int]]]:
    facets: Dict[str, List[Tuple[str, int]]] = {}
    if field_schema is None or documents.count == 0:
        return facets
    facetable = field_schema.get_facetable_field_list()
    if not facetable:
        return facets
    docs = documents.all_documents()
    for field in facetable:
        counts = _count_field(field.name, docs)
        if counts:
            facets[field.name] = _sorted_top(counts, max_facets_per_field)
    return facets
