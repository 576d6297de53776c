"""Corpus statistics the scoring rules read, worked out from the titles.

* Postings of words and of character 3-grams (the n-gram size of
  ``SearchEngine.create_default()``), with their occurrences, counted in
  NumPy over the whole corpus.
* BM25's idf, ``log(1 + (N - df + 0.5) / (df + 0.5))`` in float32.
* A query's terms with their n-gram idf (the mean over the word's
  3-grams that occur in the corpus; ``log2(len + 1)`` where none does)
  and their word idf (0 for a word no title holds).
"""

from __future__ import annotations

import re
from typing import Dict, List, NamedTuple, Optional

import numpy as np

#: the engine's default delimiters (TokenizerSetup)
DELIMITERS = frozenset(" -/.,:;'`–—*&\\_(){}[]\t")
GRAM = 3
PAD = "\x01"          # stands for the engine's padding character
_WORD = re.compile("[^" + re.escape("".join(sorted(DELIMITERS))) + "]+")
_WS = re.compile(r"[\t\n\r]")


def normalize(text: str) -> str:
    """A title or query as the engine reads it: tabs and line breaks to
    spaces, runs of spaces to one, lower case. (The corpora and queries
    are ASCII, so the engine's diacritic table changes nothing.)"""
    text = _WS.sub(" ", text)
    while "  " in text:
        text = text.replace("  ", " ")
    return text.lower()


def words(text: str) -> List[str]:
    return _WORD.findall(text)


def compute_idf(n_docs: int, df: int) -> np.float32:
    """BM25's idf of one term, in float32."""
    if df <= 0 or n_docs <= 0:
        return np.float32(0)
    ratio = (np.float32(n_docs) - np.float32(df) + np.float32(0.5)) / (
        np.float32(df) + np.float32(0.5))
    if ratio <= 0:
        return np.float32(0)
    return np.log1p(ratio, dtype=np.float32)


class Posting(NamedTuple):
    docs: np.ndarray     # int64, ascending
    tf: np.ndarray       # occurrences, int64


def _posting(keys: np.ndarray, i: int) -> Posting:
    """The titles of entry ``i`` of keys sorted as ``i << 21 | title``."""
    lo, hi = np.searchsorted(keys, [i << 21, (i + 1) << 21])
    u, tf = np.unique(keys[lo:hi] & ((1 << 21) - 1), return_counts=True)
    return Posting(u, tf.astype(np.int64))


class Corpus:
    """The normalized titles, the postings of their words and of their
    3-grams (over the title behind two padding characters, ``PAD``)."""

    def __init__(self, titles: List[str]):
        self.texts = [normalize(t) for t in titles]
        self.n = len(self.texts)
        if self.n >= 1 << 21:
            raise ValueError("the reference keys titles in 21 bits")
        self.word_ids: Dict[str, int] = {}
        ids: List[int] = []
        docs: List[int] = []
        self.long_words = np.zeros(self.n, np.int64)
        for d, t in enumerate(self.texts):
            ws = words(t)
            for w in ws:
                i = self.word_ids.get(w)
                if i is None:
                    i = self.word_ids[w] = len(self.word_ids)
                ids.append(i)
                docs.append(d)
            self.long_words[d] = sum(len(w) >= GRAM for w in ws)
        self._wkeys = np.sort((np.asarray(ids, np.int64) << 21)
                              | np.asarray(docs, np.int64))
        df = np.bincount((np.unique(self._wkeys) >> 21).astype(np.int64),
                         minlength=len(self.word_ids))
        self.word_idf: Dict[str, float] = {
            w: float(compute_idf(self.n, int(df[i])))
            for w, i in self.word_ids.items()}
        blob = "".join(PAD * 2 + t + "\n" for t in self.texts)
        a = np.frombuffer(blob.encode("ascii"), np.uint8).astype(np.int64)
        code = (a[:-2] << 16) | (a[1:-1] << 8) | a[2:]
        doc = np.cumsum(a == 10)[:-2]
        ok = (a[:-2] != 10) & (a[1:-1] != 10) & (a[2:] != 10)
        self._gkeys = np.sort((code[ok] << 21) | doc[ok])

    def word_posting(self, word: str) -> Optional[Posting]:
        i = self.word_ids.get(word)
        return None if i is None else _posting(self._wkeys, i)

    def gram_posting(self, gram: str) -> Posting:
        c = (ord(gram[0]) << 16) | (ord(gram[1]) << 8) | ord(gram[2])
        return _posting(self._gkeys, c)

    def grams(self) -> set:
        """Every 3-gram some title holds."""
        return {chr(c >> 16) + chr((c >> 8) & 255) + chr(c & 255)
                for c in np.unique(self._gkeys >> 21).tolist()}

    def term_idf(self, word: str) -> float:
        """A coverage term's idf: the mean idf of its 3-grams that some
        title holds, else log2(len + 1)."""
        vals = [float(compute_idf(self.n, p.docs.size))
                for p in (self.gram_posting(word[i:i + GRAM])
                          for i in range(len(word) - GRAM + 1))
                if p.docs.size]
        if vals:
            return sum(vals) / len(vals)
        return float(np.log2(len(word) + 1))
