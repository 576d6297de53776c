"""Packed n-gram dictionary keys.

Behavioral reference: Infidex ``Tokenization/NGramKey.cs`` (89 LoC): a 2-3
char n-gram packed into a single 64-bit integer (length in the top bits +
up to three 16-bit chars) so short-term dictionary probes never allocate.

In Python the win is different but real: an int key hashes ~2x faster than
a short str and `TermDictionary` can keep a secondary int->id map for the
2-3-gram fast path (TermCollection.cs:87-111).
"""

from __future__ import annotations

from typing import Optional

MAX_NGRAM_KEY_LEN = 3


def pack_ngram(text: str) -> Optional[int]:
    """Pack a 1-3 char string into an int key, or None if unpackable.

    Layout (NGramKey.cs:19-33): bits 48-49 = length, chars little-end
    first in 16-bit lanes. Characters above U+FFFF are not packable.
    """
    n = len(text)
    if n == 0 or n > MAX_NGRAM_KEY_LEN:
        return None
    key = n << 48
    for i, ch in enumerate(text):
        cp = ord(ch)
        if cp > 0xFFFF:
            return None
        key |= cp << (16 * i)
    return key


def unpack_ngram(key: int) -> str:
    """Inverse of :func:`pack_ngram`."""
    n = (key >> 48) & 0x3
    chars = []
    for i in range(n):
        chars.append(chr((key >> (16 * i)) & 0xFFFF))
    return "".join(chars)
