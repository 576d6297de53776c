"""The upstream's query kinds, drawn from the titles a deployment made.

The query kinds are those of the upstream benchmark (Infidex.Benchmark
``QueryBenchmarks.cs:134-157``, one benchmark method each: "Shawshank",
"Shaaawshank", "Shaa awashank", "redemption shank"), drawn from a title:

* ``exact``: one word of the title, as it is written there;
* ``typo``: one such word of 4 or more characters with one letter after
  the first written three times ("Shawshank" -> "Shaaawshank"); shorter
  words stay exact;
* ``split``: that typo split by a space inside the repeated run
  ("Shaa awshank"); shorter words stay exact;
* ``partial``: one word of the title, then the end of another of its
  words: the word less its first 4 characters, at least 3 ("Redemption
  shank"); a one-word title gives its word's end alone.

Titles are drawn uniformly from the corpus. A traffic file's ``kinds``
gives each kind's weight as a whole number; every block of sum(weights)
queries holds each kind that many times, in an order drawn from the seed,
so every seed sends the same mix. The ``Spec``s carry no options.
"""

from __future__ import annotations

import random
from typing import Dict, List

from . import Spec

KINDS = ("exact", "typo", "split", "partial")


def typo(word: str, rng: random.Random) -> str:
    if len(word) < 4:
        return word
    i = rng.randrange(1, len(word) - 1)
    return word[:i] + word[i] * 3 + word[i + 1:]


def split_typo(word: str, rng: random.Random) -> str:
    if len(word) < 4:
        return word
    i = rng.randrange(1, len(word) - 1)
    return word[:i] + word[i] * 2 + " " + word[i:]


def tail(word: str) -> str:
    return word[-max(3, len(word) - 4):]


def one_query(kind: str, title: str, rng: random.Random) -> str:
    words = title.split()
    if kind == "exact":
        return rng.choice(words)
    if kind == "typo":
        return typo(rng.choice(words), rng)
    if kind == "split":
        return split_typo(rng.choice(words), rng)
    if kind == "partial":
        if len(words) < 2:
            return tail(words[0])
        a, b = rng.sample(range(len(words)), 2)
        return f"{words[a]} {tail(words[b]).lower()}"
    raise ValueError(f"unknown query kind {kind!r}; known: {KINDS}")


def make_queries(titles: List[str], kinds: Dict[str, int], n: int,
                 rng: random.Random) -> List[str]:
    """``n`` queries over ``titles`` in the proportions of ``kinds``."""
    block = [k for k in sorted(kinds) for _ in range(int(kinds[k]))]
    if not block:
        raise ValueError("traffic: no query kind has a positive weight")
    out: List[str] = []
    while len(out) < n:
        order = block[:]
        rng.shuffle(order)
        for kind in order[: n - len(out)]:
            out.append(one_query(kind, rng.choice(titles), rng))
    return out


def queries(made, traffic: dict, n: int, rng: random.Random) -> List[Spec]:
    """``n`` queries over ``made.titles`` in the proportions of the
    traffic file's ``kinds``."""
    return [Spec(q) for q in make_queries(made.titles, traffic["kinds"], n,
                                          rng)]
