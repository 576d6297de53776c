"""Token DTOs for the list-based tokenize APIs.

Behavioral reference: Infidex ``Core/Shingle.cs`` (46 LoC) — the
(text, count, position) record returned by the list-returning tokenizer
entry points, and ``Api/SystemStatus.cs`` (24 LoC) — the status DTO.
The hot paths use (token, position) tuples instead; these classes are the
structured public API over the same data.
"""

from __future__ import annotations

from dataclasses import dataclass, field


@dataclass
class Shingle:
    """(text, count, position) token record (Core/Shingle.cs)."""

    text: str
    count: int = 1
    position: int = 0

    def __str__(self) -> str:  # matches the reference's debug format
        return f"{self.text} x{self.count} @{self.position}"


@dataclass
class SystemStatus:
    """Engine status DTO (Api/SystemStatus.cs)."""

    is_indexed: bool = False
    document_count: int = 0
    term_count: int = 0
    status_message: str = ""
    extra: dict = field(default_factory=dict)
