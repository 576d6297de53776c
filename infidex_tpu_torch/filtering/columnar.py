"""Vectorized predicate masks over columnar document attributes.

TPU-native filtering path (SURVEY.md §7.5): instead of running the stack VM
per document, filterable fields are stored as columns — numeric f64 +
dictionary-encoded string codes — and each filter AST node evaluates to a
dense bool mask over all N documents. String predicates (EQ / CONTAINS /
LIKE / MATCHES / IN / ranges) are evaluated once per UNIQUE value and
gathered through the code column, so a regex over 1M rows costs
|vocabulary| regex calls + one gather.

Semantics mirror ``filtering/vm.py`` exactly (case-insensitive EQ, numeric-
first comparisons, empty-string-is-null); property-tested against the VM.
"""

from __future__ import annotations

import re
from typing import Any, Dict, List, Optional

import numpy as np

from ..api.filters import (BooleanOperator, CompositeFilter, DerivedFilter,
                           Filter, InFilter, LiteralFilter, NullFilter,
                           RangeFilter, RegexFilter, StringFilter,
                           StringOperation, TernaryFilter, ValueFilter,
                           like_to_regex)


def _vm_str(v: Any) -> str:
    if isinstance(v, float) and v.is_integer():
        return str(int(v))
    if isinstance(v, bool):
        return "True" if v else "False"
    return str(v)


class Column:
    """One field's values over all internal doc ids, dictionary-encoded."""

    def __init__(self, n_docs: int):
        self.codes = np.full(n_docs, -1, dtype=np.int32)  # -1 = missing field
        self.values: List[Any] = []          # raw unique values by code
        self._value_index: Dict[Any, int] = {}
        # caches derived per unique value
        self._str_lower: Optional[List[str]] = None
        self._numeric: Optional[np.ndarray] = None

    def set(self, doc_id: int, value: Any) -> None:
        try:
            code = self._value_index.get(value)
            hashable = True
        except TypeError:
            code, hashable = None, False
        if code is None:
            code = len(self.values)
            self.values.append(value)
            if hashable:
                self._value_index[value] = code
        self.codes[doc_id] = code
        self._str_lower = None
        self._numeric = None

    # -- per-unique-value derived arrays ---------------------------------
    def str_lower(self) -> List[Optional[str]]:
        if self._str_lower is None:
            self._str_lower = [
                None if v is None else _vm_str(v).lower() for v in self.values
            ]
        return self._str_lower

    def numeric(self) -> np.ndarray:
        if self._numeric is None:
            out = np.full(len(self.values), np.nan)
            for i, v in enumerate(self.values):
                if v is None:
                    continue
                try:
                    out[i] = float(_vm_str(v))
                except (TypeError, ValueError):
                    pass
            self._numeric = out
        return self._numeric

    def gather(self, per_value: np.ndarray, missing: Any) -> np.ndarray:
        """Map a per-unique-value array through the code column."""
        table = np.concatenate([per_value, np.asarray([missing])])
        codes = np.where(self.codes < 0, len(per_value), self.codes)
        return table[codes]


class ColumnStore:
    """Columnar image of document attributes for vectorized filtering/facets."""

    def __init__(self, documents) -> None:
        self.n_docs = documents.total_slots()
        self.columns: Dict[str, Column] = {}
        self._documents = documents
        live = []
        for doc_id in range(self.n_docs):
            doc = documents.get_document(doc_id)
            if doc is None:
                continue
            if not doc.deleted:
                live.append(doc_id)
            for field in doc.fields:
                col = self.columns.get(field.name)
                if col is None:
                    col = Column(self.n_docs)
                    self.columns[field.name] = col
                col.set(doc_id, field.value)
        #: internal ids of live (non-deleted) documents, in id order
        self.live_doc_ids = np.asarray(live, dtype=np.int64)

    def column(self, name: str) -> Optional[Column]:
        return self.columns.get(name)

    # ------------------------------------------------------------------
    def evaluate(self, f: Filter) -> np.ndarray:
        """Dense bool mask over all internal doc ids for this filter."""
        return self._eval(f)

    def _truthy(self, f: Filter) -> np.ndarray:
        return self._eval(f)

    def _eval(self, f: Filter) -> np.ndarray:
        n = self.n_docs
        if isinstance(f, CompositeFilter):
            left = self._eval(f.left_filter)
            if f.operator == BooleanOperator.NOT:
                return ~left
            right = self._eval(f.right_filter)
            return left & right if f.operator == BooleanOperator.AND else left | right

        if isinstance(f, TernaryFilter):
            cond = self._eval(f.condition)
            t = self._eval(f.true_value)
            fl = self._eval(f.false_value)
            return np.where(cond, t, fl)

        if isinstance(f, LiteralFilter):
            return np.full(n, f.matches(None), dtype=bool)

        if isinstance(f, DerivedFilter):
            col = self.column(f.field_name)
            if col is None:
                return np.zeros(n, dtype=bool)
            per_value = np.array(
                [bool(f.predicate(v)) for v in col.values], dtype=bool)
            return col.gather(per_value, False).astype(bool)

        col = self.column(f.field_name)
        if col is None:
            # Field absent everywhere: PUSH_FIELD yields null.
            return np.full(n, self._null_field_result(f), dtype=bool)

        per_value = self._per_value_mask(f, col)
        missing = self._null_field_result(f)
        return col.gather(per_value.astype(np.int8),
                          np.int8(missing)).astype(bool)

    @staticmethod
    def _null_field_result(f: Filter) -> bool:
        """Result of the predicate when the field value is null."""
        if isinstance(f, NullFilter):
            return f.is_null
        if isinstance(f, ValueFilter):
            return False
        # VM semantics: null coerces to "" for string ops, and compares as
        # smallest for ranges (CompareTo: null < everything).
        if isinstance(f, StringFilter):
            pattern = f.pattern.lower()
            if f.operation == StringOperation.CONTAINS:
                return pattern in ""
            if f.operation == StringOperation.STARTS_WITH:
                return "".startswith(pattern)
            if f.operation == StringOperation.ENDS_WITH:
                return "".endswith(pattern)
            return re.match(like_to_regex(pattern), "") is not None
        if isinstance(f, RegexFilter):
            try:
                return re.search(f.pattern, "", re.IGNORECASE) is not None
            except re.error:
                return False
        if isinstance(f, RangeFilter):
            # VM: null compares below everything, so any min bound fails and
            # any max bound holds (FilterVM.CompareTo: null -> -1).
            if f.min_value is not None:
                return False
            return f.max_value is not None
        if isinstance(f, InFilter):
            return False
        return False

    def _per_value_mask(self, f: Filter, col: Column) -> np.ndarray:
        values = col.values
        k = len(values)
        lowers = col.str_lower()

        if isinstance(f, ValueFilter):
            target = "" if f.value is None else _vm_str(f.value).lower()
            return np.array([lv == target for lv in lowers], dtype=bool)

        if isinstance(f, NullFilter):
            nulls = np.array(
                [v is None or (isinstance(v, str) and v == "") for v in values],
                dtype=bool)
            return nulls if f.is_null else ~nulls

        if isinstance(f, InFilter):
            targets = {_vm_str(v).lower() for v in f.values}
            return np.array([lv in targets for lv in lowers], dtype=bool)

        if isinstance(f, StringFilter):
            pattern = f.pattern.lower()
            if f.operation == StringOperation.CONTAINS:
                return np.array([pattern in (lv or "") for lv in lowers], bool)
            if f.operation == StringOperation.STARTS_WITH:
                return np.array([(lv or "").startswith(pattern) for lv in lowers], bool)
            if f.operation == StringOperation.ENDS_WITH:
                return np.array([(lv or "").endswith(pattern) for lv in lowers], bool)
            regex = re.compile(like_to_regex(pattern), re.IGNORECASE)
            return np.array(
                [regex.match(lv or "") is not None for lv in lowers], bool)

        if isinstance(f, RegexFilter):
            try:
                regex = re.compile(f.pattern, re.IGNORECASE)
            except re.error:
                return np.zeros(k, dtype=bool)
            return np.array(
                [regex.search("" if v is None else _vm_str(v)) is not None
                 for v in values], bool)

        if isinstance(f, RangeFilter):
            if f.min_value is None and f.max_value is None:
                # Matches the compiled VM: no instructions emitted -> False.
                return np.zeros(k, dtype=bool)
            nums = col.numeric()
            out = np.ones(k, dtype=bool)
            for bound, include, is_min in (
                (f.min_value, f.include_min, True),
                (f.max_value, f.include_max, False),
            ):
                if bound is None:
                    continue
                bound_num = _try_float(bound)
                cmp = np.zeros(k)
                for i, v in enumerate(values):
                    if bound_num is not None and not np.isnan(nums[i]):
                        c = nums[i] - bound_num
                        cmp[i] = -1 if c < 0 else (1 if c > 0 else 0)
                    else:
                        ls = "" if v is None else _vm_str(v).lower()
                        bs = _vm_str(bound).lower()
                        cmp[i] = -1 if ls < bs else (1 if ls > bs else 0)
                if is_min:
                    out &= (cmp >= 0) if include else (cmp > 0)
                else:
                    out &= (cmp <= 0) if include else (cmp < 0)
            return out

        raise TypeError(f"Unsupported filter type for columnar eval: {type(f)}")

    # ------------------------------------------------------------------
    def facet_counts(self, field_name: str, doc_ids: np.ndarray,
                     max_per_field: int = 100, is_array: bool = False):
        """Facet aggregation as a bincount over dictionary codes.

        Array-valued fields (FacetBuilder.cs counts each element) expand the
        per-unique-code counts into per-element counts — O(unique values),
        not O(result docs)."""
        col = self.column(field_name)
        if col is None or doc_ids.size == 0:
            return []
        codes = col.codes[doc_ids]
        codes = codes[codes >= 0]
        if codes.size == 0:
            return []
        counts = np.bincount(codes, minlength=len(col.values))
        return _counts_to_pairs(counts, col.values, is_array, max_per_field)

    # ------------------------------------------------------------------
    def facet_pairs_batch(self, field_name: str,
                          id_lists: List[np.ndarray],
                          max_per_field: int = 100,
                          is_array: bool = False,
                          device_counter=None) -> List[list]:
        """Per-query facet pairs for a whole serving batch at once.

        Counts are a [B, n_values] matrix — one device segment-sum when a
        ``DeviceFacetCounter`` is supplied and the batch amortizes the
        dispatch (ops/facets.py), per-row host bincounts otherwise. Only
        the tiny top-``max_per_field`` formatting runs per query.
        Reference semantics: Core/FacetBuilder.cs:19-56.
        """
        col = self.column(field_name)
        if col is None:
            return [[] for _ in id_lists]
        n_values = len(col.values)
        if n_values == 0:
            return [[] for _ in id_lists]
        from ..ops.facets import facet_counts_batch_host

        total = sum(len(a) for a in id_lists)
        if device_counter is not None and device_counter.worth_it(
                n_values, total, len(id_lists)):
            mat = device_counter.counts(field_name, col.codes, n_values,
                                        id_lists)
        else:
            mat = facet_counts_batch_host(col.codes, n_values, id_lists)
        return [_counts_to_pairs(row, col.values, is_array, max_per_field)
                for row in mat]


def _counts_to_pairs(counts: np.ndarray, values: List[Any], is_array: bool,
                     max_per_field: int) -> list:
    """Format a per-unique-value count vector as sorted (value, count)
    pairs — count desc, value asc, top ``max_per_field``
    (Core/FacetBuilder.cs:19-56). Array values expand element-wise."""
    agg: Dict[str, int] = {}
    for i in np.nonzero(counts)[0]:
        value = values[i]
        if value is None:
            continue
        c = int(counts[i])
        if is_array and isinstance(value, (list, tuple)):
            elements = [str(v) for v in value if v is not None]
        else:
            elements = [str(value)]
        for s in elements:
            if s:
                agg[s] = agg.get(s, 0) + c
    pairs = sorted(agg.items(), key=lambda kv: (-kv[1], kv[0]))
    return pairs[:max_per_field]


def contains_derived(f: Optional[Filter]) -> bool:
    """True if any node in the filter AST is a DerivedFilter.

    Derived predicates are arbitrary callables and stay on the per-document
    VM path, matching the reference (FilterCompiler.cs:77 cannot compile
    them to bytecode either)."""
    if f is None:
        return False
    if isinstance(f, DerivedFilter):
        return True
    if isinstance(f, CompositeFilter):
        return contains_derived(f.left_filter) or contains_derived(f.right_filter)
    if isinstance(f, TernaryFilter):
        return (contains_derived(f.condition) or contains_derived(f.true_value)
                or contains_derived(f.false_value))
    return False


def _try_float(v: Any) -> Optional[float]:
    try:
        return float(str(v))
    except (TypeError, ValueError):
        return None
