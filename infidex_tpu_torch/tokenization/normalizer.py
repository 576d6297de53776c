"""Text normalization: character mapping + whitespace collapsing.

Behavioral reference: Infidex ``Tokenization/TextNormalizer.cs`` — a char->char
map (diacritic folding) plus the "standard whitespace" fast path that maps
``\\t \\n \\r`` to space and collapses runs of spaces.

TPU-native design note: normalization is a pure host-side string transform
(it runs once per document at index time and once per query). The hot path
uses a precomputed 64k-entry translation table driven through ``str.translate``
which is C-speed in CPython; the native C++ tokenizer (infidex_tpu/native)
can bypass this entirely by fusing normalization into tokenization.
"""

from __future__ import annotations

from typing import Dict, Optional

# Comprehensive Latin diacritic removal table (see TextNormalizer.cs:216-291).
_DEFAULT_CHAR_REPLACEMENTS: Dict[str, str] = {
    # Nordic/German
    "Æ": "E", "æ": "e", "Ø": "O", "ø": "o", "Å": "A", "å": "a",
    "Ä": "A", "ä": "a", "Ö": "O", "ö": "o", "Ü": "U", "ü": "u", "ß": "s",
    # Czech/Slovak carons
    "Š": "S", "š": "s", "Č": "C", "č": "c", "Ř": "R", "ř": "r",
    "Ž": "Z", "ž": "z", "Ň": "N", "ň": "n", "Ť": "T", "ť": "t",
    "Ď": "D", "ď": "d", "Ě": "E", "ě": "e",
    # Acute accents + Czech kroužek
    "Á": "A", "á": "a", "É": "E", "é": "e", "Í": "I", "í": "i",
    "Ó": "O", "ó": "o", "Ú": "U", "ú": "u", "Ý": "Y", "ý": "y",
    "Ů": "U", "ů": "u",
    # Polish
    "Ą": "A", "ą": "a", "Ć": "C", "ć": "c", "Ę": "E", "ę": "e",
    "Ł": "L", "ł": "l", "Ń": "N", "ń": "n", "Ś": "S", "ś": "s",
    "Ź": "Z", "ź": "z", "Ż": "Z", "ż": "z",
    # Hungarian
    "Ő": "O", "ő": "o", "Ű": "U", "ű": "u",
    # Romanian
    "Ă": "A", "ă": "a", "Â": "A", "â": "a", "Î": "I", "î": "i",
    "Ș": "S", "ș": "s", "Ț": "T", "ț": "t",
    # Turkish
    "Ğ": "G", "ğ": "g", "İ": "I", "ı": "i", "Ş": "S", "ş": "s",
    # French/Spanish/Portuguese
    "À": "A", "à": "a", "Ç": "C", "ç": "c", "È": "E", "è": "e",
    "Ê": "E", "ê": "e", "Ë": "E", "ë": "e", "Ì": "I", "ì": "i",
    "Ï": "I", "ï": "i", "Ñ": "N", "ñ": "n", "Ò": "O", "ò": "o",
    "Ô": "O", "ô": "o", "Õ": "O", "õ": "o", "Ù": "U", "ù": "u",
    "Û": "U", "û": "u", "Ÿ": "Y", "ÿ": "y",
    # Icelandic
    "Ð": "D", "ð": "d", "Þ": "T", "þ": "t",
}

_STANDARD_WHITESPACE_REPLACEMENTS: Dict[str, str] = {
    "  ": " ", "\t": " ", "\n": " ", "\r": " ",
}


class TextNormalizer:
    """Char/string replacement normalizer with a whitespace-collapsing fast path."""

    def __init__(
        self,
        string_replacements: Optional[Dict[str, str]] = None,
        char_replacements: Optional[Dict[str, str]] = None,
        one_way_mode: bool = False,
    ):
        self.string_replacements = dict(string_replacements or {})
        self.char_replacements = dict(char_replacements or {})
        self.one_way_mode = one_way_mode

        self._char_table = {ord(k): v for k, v in self.char_replacements.items()}

        # Detect the "standard whitespace" configuration (TextNormalizer.cs:50-57).
        sr = self.string_replacements
        self._standard_ws = (
            len(sr) == 4
            and sr.get("  ") == " "
            and sr.get("\t") == " "
            and sr.get("\n") == " "
            and sr.get("\r") == " "
        )
        if self._standard_ws:
            # Fold whitespace chars into the translate table, collapse after.
            self._ws_table = dict(self._char_table)
            for c in ("\t", "\n", "\r"):
                self._ws_table[ord(c)] = " "

    def normalize(self, text: str) -> str:
        if not text:
            return text
        if self._standard_ws:
            out = text.translate(self._ws_table)
            # Collapse runs of spaces into a single space (any run length).
            if "  " in out:
                out = _collapse_spaces(out)
            return out
        for k, v in self.string_replacements.items():
            text = text.replace(k, v)
        if self._char_table:
            text = text.translate(self._char_table)
        return text

    @staticmethod
    def create_default() -> "TextNormalizer":
        return TextNormalizer(
            string_replacements=dict(_STANDARD_WHITESPACE_REPLACEMENTS),
            char_replacements=dict(_DEFAULT_CHAR_REPLACEMENTS),
            one_way_mode=True,
        )


def _collapse_spaces(s: str) -> str:
    out = []
    prev_space = False
    for ch in s:
        if ch == " ":
            if prev_space:
                continue
            prev_space = True
        else:
            prev_space = False
        out.append(ch)
    return "".join(out)
