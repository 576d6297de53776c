"""Refinements: the upstream's query kinds, each with one Infiscript
filter taken from the title it was drawn from, and facets on.

A title is drawn uniformly from the corpus; the query's text is one of
the upstream's four kinds drawn from it (``upstream.one_query``: a word,
a typo, a split typo, a word and another's end), and its filter one of
four forms built from the same title's attributes (``made.attributes``,
as ``deployments/fielded.py`` makes them), so that the title passes it:

* ``genre``: one of its genres, ``genres CONTAINS 'Drama'``;
* ``decade``: its decade, ``start_year BETWEEN 1990 AND 1999``;
* ``type``: its type, ``title_type = 'movie'``;
* ``genre_decade``: ``genres CONTAINS 'Drama' AND start_year BETWEEN
  1990 AND 1999``.

A traffic file's ``kinds`` and ``filters`` give the weights as whole
numbers; every block of sum(weights) queries holds each kind (each form)
that many times, in an order drawn from the seed, so every seed sends
the same mix. Each ``Spec`` sets ``enable_facets`` and ``filter`` (the
Infiscript text, which the entry parses afresh for each query, as a web
tier parses each request).
"""

from __future__ import annotations

import random
from typing import Dict, List

from . import Spec, upstream

FORMS = ("genre", "decade", "type", "genre_decade")


def filter_text(form: str, attrs: Dict[str, list], i: int,
                rng: random.Random) -> str:
    """The Infiscript filter of ``form`` for title ``i``."""
    genre = f"genres CONTAINS '{rng.choice(attrs['genres'][i].split(','))}'"
    first = int(attrs["start_year"][i]) // 10 * 10
    decade = f"start_year BETWEEN {first} AND {first + 9}"
    if form == "genre":
        return genre
    if form == "decade":
        return decade
    if form == "type":
        return f"title_type = '{attrs['title_type'][i]}'"
    if form == "genre_decade":
        return f"{genre} AND {decade}"
    raise ValueError(f"unknown filter form {form!r}; known: {FORMS}")


def _block(weights: Dict[str, int], what: str) -> List[str]:
    block = [k for k in sorted(weights) for _ in range(int(weights[k]))]
    if not block:
        raise ValueError(f"traffic: no {what} has a positive weight")
    return block


def queries(made, traffic: dict, n: int, rng: random.Random) -> List[Spec]:
    """``n`` queries over ``made.titles`` and ``made.attributes`` in the
    proportions of the traffic file's ``kinds`` and ``filters``."""
    kinds = _block(traffic["kinds"], "query kind")
    forms = _block(traffic["filters"], "filter form")
    kind_order: List[str] = []
    form_order: List[str] = []
    out: List[Spec] = []
    for _ in range(n):
        if not kind_order:
            kind_order = kinds[:]
            rng.shuffle(kind_order)
        if not form_order:
            form_order = forms[:]
            rng.shuffle(form_order)
        i = rng.randrange(len(made.titles))
        text = upstream.one_query(kind_order.pop(), made.titles[i], rng)
        filt = filter_text(form_order.pop(), made.attributes, i, rng)
        out.append(Spec(text, (("enable_facets", True), ("filter", filt))))
    return out
