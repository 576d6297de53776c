"""Filter AST: the Infiscript object model.

Behavioral reference: Infidex ``Api/Filter.cs`` hierarchy — Composite
(And/Or/Not), Value (equality), Range (min/max with inclusivity), In,
String (Contains/StartsWith/EndsWith/Like), Regex, Null, Ternary, Literal,
and Derived (arbitrary predicate — cannot compile to bytecode,
FilterCompiler.cs:77). Plus the fluent FilterBuilder.
"""

from __future__ import annotations

import enum
import re
from typing import Any, Callable, List, Optional, Sequence


class FilterParseException(ValueError):
    """Rich parse error with char position + suggestion (FilterParseException.cs)."""

    def __init__(self, message: str, expression: str, position: int,
                 suggestion: Optional[str] = None):
        self.expression = expression
        self.position = position
        self.suggestion = suggestion
        lines = [message, ""]
        if expression:
            lines.append("Expression:")
            lines.append(f"  {expression}")
            if 0 <= position < len(expression) + 10:
                lines.append("  " + " " * min(position, len(expression)) + "^")
        if suggestion:
            lines.append("")
            lines.append(f"Suggestion: {suggestion}")
        super().__init__("\n".join(lines))


class Filter:
    """Base filter. Identity-hashed (compiled-filter cache key semantics)."""

    def __init__(self, field_name: str):
        self.field_name = field_name
        self.number_of_documents_in_filter = 0

    def matches(self, field_value: Any) -> bool:
        raise NotImplementedError

    def compile(self):
        from ..filtering.compiler import FilterCompiler

        return FilterCompiler().compile(self)

    def compile_to_bytes(self) -> bytes:
        from ..filtering.serializer import serialize

        return serialize(self.compile())

    @staticmethod
    def from_bytecode(bytecode: bytes):
        from ..filtering.serializer import deserialize

        return deserialize(bytecode)

    @staticmethod
    def parse(filter_expression: str) -> "Filter":
        from .filter_parser import parse

        return parse(filter_expression)


class BooleanOperator(enum.Enum):
    AND = "And"
    OR = "Or"
    NOT = "Not"


class CompositeFilter(Filter):
    def __init__(self, op: BooleanOperator, left: Filter, right: Optional[Filter] = None):
        super().__init__(f"composite_{op.value}")
        if op == BooleanOperator.NOT and right is not None:
            raise ValueError("NOT operator should only have left filter")
        if op in (BooleanOperator.AND, BooleanOperator.OR) and right is None:
            raise ValueError(f"{op.value} operator requires both left and right filters")
        self.operator = op
        self.left_filter = left
        self.right_filter = right

    @staticmethod
    def and_(left: Filter, right: Filter) -> "CompositeFilter":
        return CompositeFilter(BooleanOperator.AND, left, right)

    @staticmethod
    def or_(left: Filter, right: Filter) -> "CompositeFilter":
        return CompositeFilter(BooleanOperator.OR, left, right)

    @staticmethod
    def not_(f: Filter) -> "CompositeFilter":
        return CompositeFilter(BooleanOperator.NOT, f)

    def matches(self, field_value: Any) -> bool:
        raise NotImplementedError(
            "CompositeFilter requires document-level evaluation")

    def matches_document(self, fields) -> bool:
        left = _evaluate(self.left_filter, fields)
        if self.operator == BooleanOperator.NOT:
            return not left
        if self.operator == BooleanOperator.AND:
            return left and (self.right_filter is None
                             or _evaluate(self.right_filter, fields))
        if self.operator == BooleanOperator.OR:
            return left or (self.right_filter is not None
                            and _evaluate(self.right_filter, fields))
        return False

    def __str__(self) -> str:
        if self.operator == BooleanOperator.NOT:
            return f"NOT ({self.left_filter})"
        return f"({self.left_filter} {self.operator.value.upper()} {self.right_filter})"


def _evaluate(f: Filter, fields) -> bool:
    if isinstance(f, CompositeFilter):
        return f.matches_document(fields)
    field = fields.get_field(f.field_name)
    if field is None:
        return False
    return f.matches(field.value)


class ValueFilter(Filter):
    def __init__(self, field_name: str, value: Any):
        super().__init__(field_name)
        self.value = value

    def matches(self, field_value: Any) -> bool:
        if field_value is None and self.value is None:
            return True
        if field_value is None or self.value is None:
            return False
        return field_value == self.value

    def __str__(self) -> str:
        return f"{self.field_name} == {self.value}"


class RangeFilter(Filter):
    def __init__(self, field_name: str, min_value: Any = None, max_value: Any = None,
                 include_min: bool = True, include_max: bool = True):
        super().__init__(field_name)
        self.min_value = min_value
        self.max_value = max_value
        self.include_min = include_min
        self.include_max = include_max

    def matches(self, field_value: Any) -> bool:
        if field_value is None:
            return False
        try:
            if self.min_value is not None:
                c = _compare_same_kind(field_value, self.min_value)
                if (c < 0) if self.include_min else (c <= 0):
                    return False
            if self.max_value is not None:
                c = _compare_same_kind(field_value, self.max_value)
                if (c > 0) if self.include_max else (c >= 0):
                    return False
        except TypeError:
            return False
        return True

    def __str__(self) -> str:
        return f"{self.field_name} in [{self.min_value}, {self.max_value}]"


def _compare_same_kind(a: Any, b: Any) -> int:
    """IComparable.CompareTo analogue (same-type compare, numeric coercion)."""
    if isinstance(a, (int, float)) and not isinstance(a, bool):
        bf = float(b) if isinstance(b, (int, float)) else float(str(b))
        af = float(a)
        return -1 if af < bf else (1 if af > bf else 0)
    sa, sb = str(a), str(b)
    return -1 if sa < sb else (1 if sa > sb else 0)


class InFilter(Filter):
    def __init__(self, field_name: str, values: Sequence[Any]):
        super().__init__(field_name)
        self.values = list(values)

    def matches(self, field_value: Any) -> bool:
        if field_value is None:
            return False
        return any(field_value == v for v in self.values)

    def __str__(self) -> str:
        return f"{self.field_name} IN ({', '.join(map(str, self.values))})"


class StringOperation(enum.Enum):
    CONTAINS = "Contains"
    STARTS_WITH = "StartsWith"
    ENDS_WITH = "EndsWith"
    LIKE = "Like"


def like_to_regex(pattern: str) -> str:
    return "^" + re.escape(pattern).replace("%", ".*").replace("_", ".") + "$"


class StringFilter(Filter):
    def __init__(self, field_name: str, operation: StringOperation, pattern: str,
                 case_insensitive: bool = True):
        super().__init__(field_name)
        self.operation = operation
        self.pattern = pattern
        self.case_insensitive = case_insensitive

    def matches(self, field_value: Any) -> bool:
        if field_value is None:
            return False
        text = str(field_value)
        pattern = self.pattern
        if self.case_insensitive:
            text = text.lower()
            pattern = pattern.lower()
        if self.operation == StringOperation.CONTAINS:
            return pattern in text
        if self.operation == StringOperation.STARTS_WITH:
            return text.startswith(pattern)
        if self.operation == StringOperation.ENDS_WITH:
            return text.endswith(pattern)
        if self.operation == StringOperation.LIKE:
            return re.match(like_to_regex(pattern), text) is not None
        return False

    def __str__(self) -> str:
        op = {StringOperation.CONTAINS: "CONTAINS",
              StringOperation.STARTS_WITH: "STARTS WITH",
              StringOperation.ENDS_WITH: "ENDS WITH",
              StringOperation.LIKE: "LIKE"}[self.operation]
        return f"{self.field_name} {op} '{self.pattern}'"


class RegexFilter(Filter):
    def __init__(self, field_name: str, pattern: str, case_insensitive: bool = True):
        super().__init__(field_name)
        self.pattern = pattern
        try:
            self._regex = re.compile(pattern, re.IGNORECASE if case_insensitive else 0)
        except re.error as e:
            raise ValueError(f"Invalid regex pattern: {pattern}") from e

    def matches(self, field_value: Any) -> bool:
        if field_value is None:
            return False
        return self._regex.search(str(field_value)) is not None

    def __str__(self) -> str:
        return f"{self.field_name} MATCHES '{self.pattern}'"


class NullFilter(Filter):
    def __init__(self, field_name: str, is_null: bool = True):
        super().__init__(field_name)
        self.is_null = is_null

    def matches(self, field_value: Any) -> bool:
        null = field_value is None or (isinstance(field_value, str) and field_value == "")
        return null if self.is_null else not null

    def __str__(self) -> str:
        return f"{self.field_name} IS {'NULL' if self.is_null else 'NOT NULL'}"


class TernaryFilter(Filter):
    def __init__(self, condition: Filter, true_value: Filter, false_value: Filter):
        super().__init__("ternary")
        if condition is None or true_value is None or false_value is None:
            raise ValueError("ternary requires condition, true and false values")
        self.condition = condition
        self.true_value = true_value
        self.false_value = false_value

    def matches(self, field_value: Any) -> bool:
        if self.condition.matches(field_value):
            return self.true_value.matches(field_value)
        return self.false_value.matches(field_value)

    def __str__(self) -> str:
        return f"({self.condition} ? {self.true_value} : {self.false_value})"


class LiteralFilter(Filter):
    def __init__(self, value: Any):
        super().__init__("literal")
        self.value = value

    def matches(self, field_value: Any) -> bool:
        v = self.value
        if isinstance(v, bool):
            return v
        if isinstance(v, str):
            return bool(v)
        if isinstance(v, (int, float)):
            return float(v) != 0.0
        return v is not None

    def __str__(self) -> str:
        if isinstance(self.value, str):
            return f"'{self.value}'"
        return str(self.value) if self.value is not None else "null"


class DerivedFilter(Filter):
    """Arbitrary predicate; cannot compile to bytecode (FilterCompiler.cs:77)."""

    def __init__(self, field_name: str, predicate: Callable[[Any], bool]):
        super().__init__(field_name)
        self.predicate = predicate

    def matches(self, field_value: Any) -> bool:
        return self.predicate(field_value)

    def __str__(self) -> str:
        return f"{self.field_name} (custom)"


class FilterBuilder:
    """Fluent builder (Api/FilterBuilder.cs)."""

    def __init__(self, initial: Optional[Filter] = None):
        self._filter = initial

    @staticmethod
    def where(filter_or_field, value: Any = None) -> "FilterBuilder":
        if isinstance(filter_or_field, Filter):
            return FilterBuilder(filter_or_field)
        return FilterBuilder(ValueFilter(str(filter_or_field), value))

    @staticmethod
    def where_range(field_name: str, min_value: Any = None,
                    max_value: Any = None) -> "FilterBuilder":
        return FilterBuilder(RangeFilter(field_name, min_value, max_value))

    def and_(self, filter_or_field, value: Any = None) -> "FilterBuilder":
        other = (filter_or_field if isinstance(filter_or_field, Filter)
                 else ValueFilter(str(filter_or_field), value))
        self._filter = CompositeFilter.and_(self._filter, other) \
            if self._filter is not None else other
        return self

    def and_range(self, field_name: str, min_value: Any = None,
                  max_value: Any = None) -> "FilterBuilder":
        return self.and_(RangeFilter(field_name, min_value, max_value))

    def or_(self, filter_or_field, value: Any = None) -> "FilterBuilder":
        other = (filter_or_field if isinstance(filter_or_field, Filter)
                 else ValueFilter(str(filter_or_field), value))
        self._filter = CompositeFilter.or_(self._filter, other) \
            if self._filter is not None else other
        return self

    def or_range(self, field_name: str, min_value: Any = None,
                 max_value: Any = None) -> "FilterBuilder":
        return self.or_(RangeFilter(field_name, min_value, max_value))

    def not_(self) -> "FilterBuilder":
        if self._filter is not None:
            self._filter = CompositeFilter.not_(self._filter)
        return self

    def build(self) -> Optional[Filter]:
        return self._filter
