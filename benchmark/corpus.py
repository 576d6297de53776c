"""Title corpora, made from a seed.

The recipe of the repository's bench corpus (``bench.py`` ``make_corpus``
and ``_make_vocab``; ``chip_smoke.py`` ``big_vocab_corpus`` for a larger
word list), copied here and seeded from the run's ``--seed``: a
vocabulary of syllable words behind a fixed list of adjectives and nouns,
each title 2-5 words drawn with Zipf weight 1/(rank + offset) and
title-cased, ``titles[0]`` a fixed title. A configuration file's
``corpus`` object gives the numbers.
"""

from __future__ import annotations

import bisect
import random
from typing import List, Tuple

ADJECTIVES = [
    "dark", "silent", "broken", "golden", "hidden", "lost", "final", "iron",
    "crimson", "frozen", "burning", "endless", "savage", "gentle", "wild",
]
NOUNS = [
    "knight", "redemption", "empire", "shadow", "river", "mountain", "storm",
    "garden", "promise", "journey", "kingdom", "harbor", "winter", "crown",
    "station", "shawshank", "galaxy", "horizon", "memory", "legacy",
]
SYLLABLES = ["ba", "ce", "dor", "fa", "gi", "han", "ji", "ka", "lo", "mer",
             "na", "pol", "qua", "ri", "sa", "tor", "ul", "vi", "wen", "xa",
             "yor", "zen", "ch", "st", "ra", "el", "in", "on", "ar", "us"]


def make_vocab(rng: random.Random, size: int) -> List[str]:
    """``size`` distinct words: the fixed list, then syllable words."""
    vocab = list(ADJECTIVES + NOUNS)
    seen = set(vocab)
    while len(vocab) < size:
        w = "".join(rng.choice(SYLLABLES) for _ in range(rng.randint(2, 4)))
        if w not in seen:
            seen.add(w)
            vocab.append(w)
    return vocab


def make_titles(spec: dict, seed: int) -> Tuple[List[str], List[str]]:
    """(titles, vocabulary) of a configuration's ``corpus`` spec: keys
    ``titles``, ``vocab_words``, ``words_min``, ``words_max``,
    ``zipf_offset`` and ``first_title``."""
    rng = random.Random(seed)
    vocab = make_vocab(rng, spec["vocab_words"])
    off = float(spec["zipf_offset"])
    weights = [1.0 / (r + off) for r in range(len(vocab))]
    total = sum(weights)
    cum, acc = [], 0.0
    for w in weights:
        acc += w / total
        cum.append(acc)
    lo, hi = spec["words_min"], spec["words_max"]
    last = len(vocab) - 1
    titles = []
    for _ in range(spec["titles"]):
        k = rng.randint(lo, hi)
        titles.append(" ".join(
            vocab[min(bisect.bisect_left(cum, rng.random()), last)]
            for _ in range(k)).title())
    titles[0] = spec["first_title"]
    return titles, vocab
