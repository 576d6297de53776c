"""Coverage (Stage-2) configuration knobs.

Behavioral reference: Infidex ``Coverage/CoverageSetup.cs`` — defaults:
MinWordSize 2, NumTypos 2, MinLengthOneTypo 3, MinLengthTwoTypos 7,
LevenshteinMaxWordSize 20, LCS tolerance 0.2*len(q) for len(q) >= 5,
TruncationScore 254, CoverageDepth 500, all matchers on, prescreen off.
"""

from __future__ import annotations

from dataclasses import dataclass, replace


@dataclass
class CoverageSetup:
    min_word_size: int = 2
    levenshtein_max_word_size: int = 20
    num_typos: int = 2
    min_length_one_typo: int = 3
    min_length_two_typos: int = 7
    coverage_min_word_hits_abs: int = 1
    coverage_min_word_hits_relative: int = 0
    coverage_q_limit_for_error_tolerance: int = 5
    coverage_lcs_error_tolerance_relative_q: float = 0.2
    cover_whole_query: bool = True
    cover_whole_words: bool = True
    cover_fuzzy_words: bool = True
    cover_joined_words: bool = True
    cover_prefix_suffix: bool = True
    truncate: bool = True
    enable_lexical_prescreen: bool = False
    truncation_score: int = 254
    coverage_depth: int = 500

    def copy(self) -> "CoverageSetup":
        return replace(self)

    @staticmethod
    def create_default() -> "CoverageSetup":
        return CoverageSetup()

    @staticmethod
    def create_minimal() -> "CoverageSetup":
        return CoverageSetup(
            cover_whole_words=True,
            cover_fuzzy_words=False,
            cover_joined_words=False,
            cover_prefix_suffix=False,
            cover_whole_query=False,
        )
