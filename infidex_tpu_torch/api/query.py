"""Query / Result / Boost API objects.

Behavioral reference: Infidex ``Api/Query.cs`` (defaults: max_records 10,
enable_coverage True, coverage_depth 500, timeout clamped 0-10000ms,
remove_duplicates True), ``Api/Result.cs``, ``Api/Boost.cs`` and
``Api/BoostStrength.cs`` (Low=1 / Med=2 / High=3 — the code enum, which
wins over the README's prose).
"""

from __future__ import annotations

import enum
from dataclasses import dataclass, field as dc_field
from typing import Any, Dict, List, Optional, Tuple

from ..coverage.setup import CoverageSetup
from ..index.vector_model import ScoreEntry
from .fields import Field

INT_MAX = 2**31 - 1


class BoostStrength(enum.IntEnum):
    LOW = 1
    MED = 2
    HIGH = 3


@dataclass
class Boost:
    """A (filter, strength) pair; matching docs get `strength` added to score."""

    filter: Any = None
    boost_strength: BoostStrength = BoostStrength.LOW

    @property
    def documents_boosted(self) -> int:
        return getattr(self.filter, "number_of_documents_in_filter", 0) or 0


class Query:
    def __init__(self, text: str = "", max_number_of_records_to_return: int = 10):
        self.text = text
        self.max_number_of_records_to_return = max_number_of_records_to_return
        self.enable_coverage = True
        self.enable_facets = False
        self.enable_boost = False
        self.coverage_depth = 500
        self.coverage_setup: Optional[CoverageSetup] = None
        self.filter = None
        self.boosts: Optional[List[Boost]] = None
        self.sort_by: Optional[Field] = None
        self.sort_ascending = False
        self.remove_duplicates = True
        # Timeout default mirrors Api/Query.cs:75 (1000ms). The reference
        # never enforces it (SearchEngine.cs:290 only clamps); we DO
        # enforce deadlines, but only when the caller explicitly set one —
        # enforcing the implicit default would change rankings under slow
        # cold-compile conditions where the reference would not.
        self._timeout_ms = 1000
        self._timeout_explicit = False
        self.log_prefix = ""
        self.compiled_filter_bytecode: Optional[bytes] = None

    @property
    def time_out_limit_milliseconds(self) -> int:
        return self._timeout_ms

    @time_out_limit_milliseconds.setter
    def time_out_limit_milliseconds(self, value: int) -> None:
        self._timeout_ms = value
        self._timeout_explicit = True

    @property
    def timeout_enforced(self) -> bool:
        """True when the caller explicitly set a timeout (deadline active)."""
        return self._timeout_explicit and self._timeout_ms > 0

    def copy(self) -> "Query":
        q = Query(self.text, self.max_number_of_records_to_return)
        q.enable_coverage = self.enable_coverage
        q.enable_facets = self.enable_facets
        q.enable_boost = self.enable_boost
        q.coverage_depth = self.coverage_depth
        q.coverage_setup = self.coverage_setup.copy() if self.coverage_setup else None
        q.filter = self.filter
        q.boosts = self.boosts
        q.sort_by = self.sort_by
        q.sort_ascending = self.sort_ascending
        q.remove_duplicates = self.remove_duplicates
        q._timeout_ms = self._timeout_ms
        q._timeout_explicit = self._timeout_explicit
        q.log_prefix = self.log_prefix
        q.compiled_filter_bytecode = self.compiled_filter_bytecode
        return q

    @property
    def max_boost(self) -> int:
        if not self.enable_boost or not self.boosts:
            return 0
        return sum(int(b.boost_strength) for b in self.boosts)


@dataclass
class Result:
    records: List[ScoreEntry] = dc_field(default_factory=list)
    facets: Optional[Dict[str, List[Tuple[str, int]]]] = None
    truncation_index: int = 0
    truncation_score: float = 0.0
    did_time_out: bool = False
    total_candidates: int = 0
    execution_time_ms: int = 0

    @staticmethod
    def make_empty(timed_out: bool = False) -> "Result":
        return Result(did_time_out=timed_out)
