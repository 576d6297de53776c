"""Document fields, weights and the multi-field concatenation contract.

Behavioral reference: Infidex ``Api/DocumentFields.cs``, ``Api/Field.cs``,
``Api/Weight.cs``. Fields carry a Weight (High/Med/Low -> field-weight
multipliers [1.5, 1.25, 1.0], Core/ConfigurationParameters.cs:16), plus
indexing/filter/facet/sort flags. ``get_searchable_texts`` concatenates
indexable fields High-first with a '§' delimiter, recording
(position, weight_index) boundaries (DocumentFields.cs:124-170).
"""

from __future__ import annotations

import enum
from typing import Any, Dict, List, Optional, Tuple


class Weight(enum.IntEnum):
    """Field importance; numeric value doubles as the field-weight index."""

    HIGH = 0
    MED = 1
    LOW = 2


class JsonKind(enum.Enum):
    UNDEFINED = "undefined"
    STRING = "string"
    NUMBER = "number"
    TRUE = "true"
    FALSE = "false"
    NULL = "null"
    OBJECT = "object"
    ARRAY = "array"


def _infer_kind(value: Any) -> JsonKind:
    if value is None:
        return JsonKind.NULL
    if isinstance(value, bool):
        return JsonKind.TRUE if value else JsonKind.FALSE
    if isinstance(value, (int, float)):
        return JsonKind.NUMBER
    if isinstance(value, str):
        return JsonKind.STRING
    if isinstance(value, (list, tuple)):
        return JsonKind.ARRAY
    return JsonKind.OBJECT


class Field:
    """A named document field (Api/Field.cs:14-69)."""

    def __init__(
        self,
        name: str,
        value: Any = None,
        weight: Weight = Weight.MED,
        indexable: bool = True,
        filterable: bool = False,
        sortable: bool = False,
        facetable: bool = False,
        word_indexing: bool = False,
        optional: bool = False,
        is_array: bool = False,
        weight_as_float: Optional[float] = None,
        preload_filters: bool = False,
    ):
        self.name = name
        self.value = value
        self.weight = Weight(weight)
        self.indexable = indexable
        self.filterable = filterable
        self.sortable = sortable
        self.facetable = facetable
        self.word_indexing = word_indexing
        self.optional = optional
        self.is_array = is_array or isinstance(value, (list, tuple))
        self.weight_as_float = weight_as_float
        self.preload_filters = preload_filters
        self.type = _infer_kind(value)

    def __repr__(self) -> str:
        return f"Field({self.name!r}, weight={self.weight.name}, value={self.value!r})"


class DocumentFields:
    """Ordered collection of named fields (Api/DocumentFields.cs)."""

    def __init__(self) -> None:
        self._fields: Dict[str, Field] = {}
        self.name_of_document_key_field: str = ""

    def add_field(self, field_or_name, value: Any = None, weight: Weight = Weight.MED,
                  indexable: bool = True, **kwargs) -> None:
        if isinstance(field_or_name, Field):
            f = field_or_name
        else:
            f = Field(str(field_or_name), value, weight, indexable=indexable, **kwargs)
        if not f.name:
            return
        self._fields[f.name] = f

    def get_field(self, name: str) -> Optional[Field]:
        return self._fields.get(name)

    def get_field_list(self) -> List[Field]:
        return list(self._fields.values())

    def get_searchable_field_list(self) -> List[Field]:
        fields = [f for f in self._fields.values() if f.indexable]
        fields.sort(key=lambda f: int(f.weight))  # HIGH=0 first
        return fields

    def get_filterable_field_list(self) -> List[Field]:
        return [f for f in self._fields.values() if f.filterable]

    def get_facetable_field_list(self) -> List[Field]:
        return [f for f in self._fields.values() if f.facetable]

    def get_exact_word_match_fields(self) -> List[Field]:
        return [f for f in self._fields.values() if f.word_indexing]

    def get_searchable_texts(self, delimiter: str = "§") -> Tuple[List[Tuple[int, int]], str]:
        """Concatenate indexable fields; returns (boundaries, text).

        ``boundaries`` is a list of (position, weight_index) marking where
        each field (or array element) starts in the concatenated text
        (DocumentFields.cs:124-170).
        """
        boundaries: List[Tuple[int, int]] = []
        parts: List[str] = []
        pos = 0
        searchable = self.get_searchable_field_list()
        for i, f in enumerate(searchable):
            if f.is_array and isinstance(f.value, (list, tuple)):
                for item in f.value:
                    boundaries.append((pos, int(f.weight)))
                    s = "" if item is None else str(item)
                    parts.append(s)
                    parts.append(delimiter)
                    pos += len(s) + len(delimiter)
            else:
                boundaries.append((pos, int(f.weight)))
                s = "" if f.value is None else str(f.value)
                parts.append(s)
                pos += len(s)
                if i < len(searchable) - 1:
                    parts.append(delimiter)
                    pos += len(delimiter)
        boundaries.sort(key=lambda b: b[0])
        return boundaries, "".join(parts)

    def has_key(self) -> bool:
        if not self.name_of_document_key_field:
            return False
        f = self.get_field(self.name_of_document_key_field)
        return f is not None and f.type in (JsonKind.NUMBER, JsonKind.STRING)

    def clear(self) -> None:
        self._fields.clear()

    def __iter__(self):
        return iter(self._fields.values())

    def __len__(self) -> int:
        return len(self._fields)
