"""Engine configuration presets.

Behavioral reference: Infidex ``Core/ConfigurationParameters.cs`` — numbered
presets 100/103/400/401 plus defaults. Config 400 is ``create_default()``:
IndexSizes=[3], start_pad=2, stop_term_limit=1.25M, max_index_text_len=300,
WordMatcher(LD1+affix, exact 2-8, LD1 3-8), auto-segmentation (200, 0.2).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional

from ..tokenization.normalizer import TextNormalizer
from ..tokenization.tokenizer import DEFAULT_DELIMITERS, TokenizerSetup

DEFAULT_FIELD_WEIGHTS = (1.5, 1.25, 1.0)  # High, Med, Low


@dataclass
class AutoSegmentationSetup:
    target_segment_size: int = 200
    overlap_ratio: float = 0.2


@dataclass
class WordMatcherSetup:
    maximum_word_size_exact: int = 8
    maximum_word_size_ld1: int = 8
    minimum_word_size_exact: int = 2
    minimum_word_size_ld1: int = 3
    support_ld1: bool = False
    support_affix: bool = False


@dataclass
class ConfigurationParameters:
    index_sizes: List[int] = field(default_factory=lambda: [2, 3])
    start_pad_size: int = 2
    stop_pad_size: int = 0
    stop_term_limit: int = 1_250_000
    case_sensitive: bool = False
    max_index_text_length: int = 300
    max_client_text_length: int = 1000
    max_documents: int = 5_000_000
    text_normalizer: Optional[TextNormalizer] = None
    tokenizer_setup: Optional[TokenizerSetup] = None
    delete_text_after_indexing: bool = False
    auto_segmentation_setup: Optional[AutoSegmentationSetup] = None
    filter_cache_size: int = 0
    field_weights: tuple = DEFAULT_FIELD_WEIGHTS
    word_matcher_setup: Optional[WordMatcherSetup] = None


def get_config(config_number: int) -> ConfigurationParameters:
    normalizer = TextNormalizer.create_default()
    if config_number == 100:
        return ConfigurationParameters(
            index_sizes=[2, 3],
            text_normalizer=normalizer,
            tokenizer_setup=TokenizerSetup(DEFAULT_DELIMITERS, False, True),
        )
    if config_number == 103:
        return ConfigurationParameters(
            index_sizes=[3],
            text_normalizer=normalizer,
            tokenizer_setup=TokenizerSetup(DEFAULT_DELIMITERS, False, True),
        )
    if config_number in (400, 401):
        return ConfigurationParameters(
            index_sizes=[3],
            text_normalizer=normalizer,
            tokenizer_setup=TokenizerSetup(DEFAULT_DELIMITERS, False, False),
            delete_text_after_indexing=True,
            auto_segmentation_setup=AutoSegmentationSetup(200, 0.2),
            filter_cache_size=200_000,
            word_matcher_setup=WordMatcherSetup(
                maximum_word_size_exact=8,
                maximum_word_size_ld1=8,
                minimum_word_size_exact=2,
                minimum_word_size_ld1=3,
                support_ld1=True,
                support_affix=True,
            ),
        )
    raise ValueError(f"Configuration {config_number} not found")


def has_config(config_number: int) -> bool:
    return config_number in (100, 103, 400, 401)
