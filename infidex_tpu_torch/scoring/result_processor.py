"""Post-processing: filter -> boost -> sort on the result list.

Behavioral reference: Infidex ``Scoring/ResultProcessor.cs`` — filters run
the bytecode VM per result document (filtering happens AFTER ranking, on the
result list), boosts add their integer strength then resort by score,
sorting is type-aware on arbitrary fields.
"""

from __future__ import annotations

from typing import Dict, List, Optional

from ..api.fields import Field
from ..api.query import Boost
from ..core.documents import DocumentCollection
from ..index.vector_model import ScoreEntry


class _AstFallback:
    """Executes a non-compilable filter through the AST (DerivedFilter)."""

    def __init__(self, flt):
        self._filter = flt


class ResultProcessor:
    def __init__(self, documents: DocumentCollection, compiled_filter_cache: Dict,
                 column_store=None):
        self._documents = documents
        self._cache = compiled_filter_cache
        # Columnar fast path (SURVEY §7.5): when the facade supplies a
        # ColumnStore, non-derived filters evaluate as one dense mask over
        # all docs instead of a per-document VM run.
        self._column_store = column_store

    def _columnar_mask(self, flt):
        """Dense bool mask for *flt*, or None if the VM path must be used.

        Cached per filter identity on the ColumnStore (the same cache the
        facade's pre-filter uses; the store is replaced wholesale on
        reindex, taking the cache with it): evaluating the mask costs two
        full-corpus gathers per condition (~16ms/query at 1M docs — it
        was the whole config-4 host bottleneck, 1.1s per 64-batch), while
        serving streams repeat a handful of filter objects
        (Filtering/FilterCache.cs is the reference's same trade)."""
        if self._column_store is None or flt is None:
            return None
        from ..filtering.columnar import contains_derived

        if contains_derived(flt):
            return None
        store = self._column_store
        cache = getattr(store, "_prefilter_masks", None)
        if cache is None:
            cache = store._prefilter_masks = {}
        hit = cache.get(id(flt))
        if hit is not None and hit[0] is flt:
            return hit[1]
        mask = store.evaluate(flt)
        if len(cache) >= 64:
            cache.clear()
        cache[id(flt)] = (flt, mask)
        return mask

    def _compile(self, flt):
        compiled = self._cache.get(flt)
        if compiled is None:
            from ..filtering.compiler import FilterCompiler

            try:
                compiled = FilterCompiler().compile(flt)
            except NotImplementedError:
                # DerivedFilter: arbitrary predicate, evaluated via the AST
                # (the reference cannot compile these either,
                # FilterCompiler.cs:77).
                compiled = _AstFallback(flt)
            self._cache[flt] = compiled
        return compiled

    def apply_filter(self, results: List[ScoreEntry], flt,
                     precompiled=None) -> List[ScoreEntry]:
        from ..filtering.vm import FilterVM

        mask = self._columnar_mask(flt)
        if mask is not None:
            if getattr(flt, "number_of_documents_in_filter", None) == 0:
                live = self._column_store.live_doc_ids
                flt.number_of_documents_in_filter = int(mask[live].sum())
            filtered = []
            for entry in results:
                doc = self._documents.get_document_by_public_key(entry.document_id)
                if doc is not None and mask[doc.id]:
                    filtered.append(entry)
            return filtered

        compiled = precompiled if precompiled is not None else self._compile(flt)
        vm = FilterVM()

        if flt is not None and getattr(flt, "number_of_documents_in_filter", None) == 0:
            match_count = 0
            for doc in self._documents.all_documents():
                if _exec(vm, compiled, doc.fields):
                    match_count += 1
            flt.number_of_documents_in_filter = match_count

        filtered = []
        for entry in results:
            doc = self._documents.get_document_by_public_key(entry.document_id)
            if doc is None:
                continue
            if _exec(vm, compiled, doc.fields):
                filtered.append(entry)
        return filtered

    def apply_boosts(self, results: List[ScoreEntry], boosts: List[Boost]) -> List[ScoreEntry]:
        from ..filtering.vm import FilterVM

        if not boosts:
            return results

        # Columnar path: each boost filter becomes one dense mask; the loop
        # over results is O(1) lookups instead of VM executions.
        masked_boosts = []
        if self._column_store is not None:
            for boost in boosts:
                if boost.filter is None:
                    continue
                mask = self._columnar_mask(boost.filter)
                if mask is None:
                    masked_boosts = None
                    break
                masked_boosts.append((mask, int(boost.boost_strength)))
        else:
            masked_boosts = None
        if masked_boosts:
            out = []
            for entry in results:
                doc = self._documents.get_document_by_public_key(entry.document_id)
                if doc is None:
                    out.append(entry)
                    continue
                total = sum(strength for mask, strength in masked_boosts
                            if mask[doc.id])
                if total > 0:
                    entry = ScoreEntry(entry.score + total, entry.document_id,
                                       entry.tiebreaker, entry.segment_number)
                out.append(entry)
            out.sort(key=lambda e: -e.score)
            return out

        compiled_boosts = []
        for boost in boosts:
            if boost.filter is None:
                continue
            compiled_boosts.append((self._compile(boost.filter), int(boost.boost_strength)))
        if not compiled_boosts:
            return results
        vm = FilterVM()
        out = []
        for entry in results:
            doc = self._documents.get_document_by_public_key(entry.document_id)
            if doc is None:
                out.append(entry)
                continue
            total = sum(strength for compiled, strength in compiled_boosts
                        if _exec(vm, compiled, doc.fields))
            if total > 0:
                entry = ScoreEntry(entry.score + total, entry.document_id,
                                   entry.tiebreaker, entry.segment_number)
            out.append(entry)
        out.sort(key=lambda e: -e.score)
        return out

    def apply_sort(self, results: List[ScoreEntry], sort_by: Field,
                   ascending: bool) -> List[ScoreEntry]:
        def sort_value(entry: ScoreEntry):
            doc = self._documents.get_document_by_public_key(entry.document_id)
            f = doc.fields.get_field(sort_by.name) if doc is not None else None
            return f.value if f is not None else None

        keyed = [(entry, sort_value(entry)) for entry in results]

        import functools

        def cmp(a, b):
            va, vb = a[1], b[1]
            r = _compare_values(va, vb)
            return r if ascending else -r

        keyed.sort(key=functools.cmp_to_key(cmp))
        return [e for e, _ in keyed]


def _exec(vm, compiled, fields) -> bool:
    if isinstance(compiled, _AstFallback):
        from ..api.filters import CompositeFilter

        flt = compiled._filter
        if isinstance(flt, CompositeFilter):
            return flt.matches_document(fields)
        field = fields.get_field(flt.field_name)
        return flt.matches(field.value if field is not None else None)
    return vm.execute(compiled, fields)


def _compare_values(a, b) -> int:
    if a is None and b is None:
        return 0
    if a is None:
        return -1
    if b is None:
        return 1
    if type(a) is type(b):
        try:
            if a < b:
                return -1
            if a > b:
                return 1
            return 0
        except TypeError:
            pass
    # Numeric cross-type comparison (int vs float)
    if isinstance(a, (int, float)) and isinstance(b, (int, float)) \
            and not isinstance(a, bool) and not isinstance(b, bool):
        return -1 if a < b else (1 if a > b else 0)
    sa, sb = str(a), str(b)
    return -1 if sa < sb else (1 if sa > sb else 0)
