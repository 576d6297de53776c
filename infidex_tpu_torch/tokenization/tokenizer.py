"""Char-n-gram ("shingle") + word tokenization.

Behavioral reference: Infidex ``Tokenization/Tokenizer.cs`` and
``Tokenization/TokenizerSetup.cs``:

* Indexing path (Tokenizer.cs:89-139): n-grams of each index size over
  ``start_pad + text + stop_pad`` (skipping all-padding grams), then whole
  words (>= min n-gram size) with their positions in the padded text.
* Search path (Tokenizer.cs:144-267): words first, then shingles over the
  padded query; HighResolutionMode additionally shingles the delimiter-
  stripped joined text and emits the joined text itself.
* If the padded text is shorter than the smallest index size nothing is
  emitted for that size; when ``len(padded) <= index_sizes[0]`` only the
  smallest size is used (Tokenizer.cs:278-298).

TPU-native design note: tokenization is host-side (strings never reach the
device). Documents are tokenized once at index time into term-id tensors;
queries are tokenized per search (microseconds). The C++ fast path in
``infidex_tpu/native`` implements the same contract.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Iterator, List, Optional, Tuple

from .normalizer import TextNormalizer

START_PAD_CHAR = "￿"
STOP_PAD_CHAR = "￾"

DEFAULT_DELIMITERS = (
    " ", "-", "/", ".", ",", ":", ";", "'", "`", "–", "—",
    "*", "&", "\\", "_", "(", ")", "{", "}", "[", "]", "\t",
)


@dataclass
class TokenizerSetup:
    """Word-splitting configuration (TokenizerSetup.cs).

    ``search_token_cache_size`` > 0 opts search-path tokenization into an
    LRU cache (TokenCache.cs — dormant in the reference's main path; here
    the opt-in wires it to ``tokenize_for_search``, the hot repeated-query
    path)."""

    delimiters: Tuple[str, ...] = DEFAULT_DELIMITERS
    high_resolution_mode: bool = False
    remove_duplicate_tokens: bool = True
    search_token_cache_size: int = 0

    def __post_init__(self) -> None:
        self.delimiters = tuple(self.delimiters)
        self.delimiter_set = frozenset(self.delimiters)

    @staticmethod
    def create_default() -> "TokenizerSetup":
        return TokenizerSetup()


class Tokenizer:
    """Multi-size char-n-gram + word tokenizer with padding."""

    def __init__(
        self,
        index_sizes: List[int],
        start_pad_size: int = 2,
        stop_pad_size: int = 0,
        text_normalizer: Optional[TextNormalizer] = None,
        tokenizer_setup: Optional[TokenizerSetup] = None,
    ):
        self.index_sizes = list(index_sizes)
        self.start_pad_size = start_pad_size
        self.stop_pad_size = stop_pad_size
        self.text_normalizer = text_normalizer
        self.tokenizer_setup = tokenizer_setup
        self._start_padding = START_PAD_CHAR * start_pad_size
        self._stop_padding = STOP_PAD_CHAR * stop_pad_size
        self.search_token_cache = None
        if (tokenizer_setup is not None
                and getattr(tokenizer_setup, "search_token_cache_size", 0) > 0):
            from .token_cache import TokenCache

            self.search_token_cache = TokenCache(
                tokenizer_setup.search_token_cache_size)

    @property
    def min_index_size(self) -> int:
        return min(self.index_sizes) if self.index_sizes else 1

    # ------------------------------------------------------------------
    # Word splitting

    def split_words(self, text: str) -> List[Tuple[str, int]]:
        """Split ``text`` on delimiters; returns (word, char_offset) pairs.

        Matches the delimiter scan in Tokenizer.cs:117-137 (no minimum size
        filter here; callers filter).
        """
        setup = self.tokenizer_setup
        if setup is None:
            return []
        delims = setup.delimiter_set
        words: List[Tuple[str, int]] = []
        i, n = 0, len(text)
        while i < n:
            while i < n and text[i] in delims:
                i += 1
            if i >= n:
                break
            start = i
            while i < n and text[i] not in delims:
                i += 1
            words.append((text[start:i], start))
        return words

    # ------------------------------------------------------------------
    # Indexing path

    def tokenize_for_indexing(
        self, text: str, is_segment_continuation: bool = False
    ) -> List[Tuple[str, int]]:
        """Tokens for indexing: (token, position-in-padded-text) pairs.

        Position semantics follow Tokenizer.cs:89-139: n-gram positions are
        offsets into the padded text; word positions are start_pad offset +
        word offset in the unpadded text.
        """
        if not text:
            return []
        if self.text_normalizer is not None:
            text = self.text_normalizer.normalize(text)

        start_pad = "" if is_segment_continuation else self._start_padding
        padded = start_pad + text + self._stop_padding

        out: List[Tuple[str, int]] = []
        self._extract_ngrams_with_pos(padded, out)

        if self.tokenizer_setup is not None:
            base = 0 if is_segment_continuation else self.start_pad_size
            min_size = self.index_sizes[0] if self.index_sizes else 1
            for word, offset in self.split_words(text):
                if len(word) >= min_size:
                    out.append((word, base + offset))
        return out

    # ------------------------------------------------------------------
    # Search path

    def tokenize_for_search(self, text: str) -> List[str]:
        """Tokens for the query side: words first, then shingles (Tokenizer.cs:144-267)."""
        if self.search_token_cache is not None:
            return self.search_token_cache.get_or_compute(
                text, self._tokenize_for_search_uncached)
        return self._tokenize_for_search_uncached(text)

    def _tokenize_for_search_uncached(self, text: str) -> List[str]:
        if self.text_normalizer is not None:
            text = self.text_normalizer.normalize(text)

        out: List[str] = []
        setup = self.tokenizer_setup
        if setup is not None:
            min_size = self.index_sizes[0] if self.index_sizes else 1
            for word, _ in self.split_words(text):
                if len(word) >= min_size:
                    out.append(word)

        padded = self._start_padding + text + self._stop_padding
        self._extract_ngrams(padded, out)

        if setup is not None and setup.high_resolution_mode:
            joined = "".join(c for c in text if c not in setup.delimiter_set)
            padded_joined = self._start_padding + joined + self._stop_padding
            self._extract_ngrams(padded_joined, out)
            min_size = self.index_sizes[0] if self.index_sizes else 1
            if len(joined) >= min_size:
                out.append(joined)
        return out

    def word_tokens_for_coverage(self, text: str, min_word_size: int) -> List[str]:
        """Unique lowercase words of at least ``min_word_size`` (Tokenizer.cs:331-341)."""
        if self.tokenizer_setup is None:
            return []
        seen = {}
        for word, _ in self.split_words(text):
            if len(word) >= min_word_size:
                seen.setdefault(word.lower(), None)
        return list(seen.keys())

    # ------------------------------------------------------------------
    # N-gram helpers

    def _effective_sizes(self, padded_len: int) -> List[int]:
        if not self.index_sizes:
            return []
        max_size = self.index_sizes[-1]
        if padded_len <= self.index_sizes[0]:
            max_size = self.index_sizes[0]
        sizes = []
        for size in self.index_sizes:
            sizes.append(size)
            if size == max_size:
                break
        return sizes

    def _extract_ngrams(self, padded: str, out: List[str]) -> None:
        n = len(padded)
        for size in self._effective_sizes(n):
            if n < size:
                continue
            for i in range(n - size + 1):
                gram = padded[i : i + size]
                if _all_padding(gram):
                    continue
                out.append(gram)

    def _extract_ngrams_with_pos(self, padded: str, out: List[Tuple[str, int]]) -> None:
        n = len(padded)
        for size in self._effective_sizes(n):
            if n < size:
                continue
            for i in range(n - size + 1):
                gram = padded[i : i + size]
                if _all_padding(gram):
                    continue
                out.append((gram, i))


def _all_padding(s: str) -> bool:
    for c in s:
        if c != START_PAD_CHAR and c != STOP_PAD_CHAR:
            return False
    return True
