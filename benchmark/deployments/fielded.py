"""Fielded titles: a title to search, and IMDb title.basics attributes to
filter and facet on, under ``SearchEngine.create_default()``.

Documents: ``corpus.make_titles`` over the configuration's ``corpus``
recipe, from the seed (the titles of ``titles.py``, byte for byte), and
for each title, from a stream of the seed of its own, the configuration's
``attributes``: ``title_type`` (one of its weighted values),
``start_year`` (a year weighted ``growth ** (year - first)``) and
``genres`` (1-3 distinct genres, weighted ``1 / (rank + zipf_offset)``,
sorted and comma-joined). Engine: each title a ``DocumentFields`` of the
title (indexable, ``Weight.MED``, as ``Document(i, title)`` indexes it)
and the three attributes (filterable and facetable, not indexable).

The engine is handed to the entries behind ``Recorder``, which passes
every call and attribute through and keeps each answer's facets for the
judge (``check.answer_of`` keeps records only). Reference:
``reference.refine.Reference``; ``judge`` adds ``filter_violations`` and
``facets_mismatched`` to ``check.judge``'s four numbers.
"""

from __future__ import annotations

import functools
import random
from types import SimpleNamespace
from typing import Dict, List

import numpy as np

from .. import check, corpus
from ..reference import refine
from ..reference.stats import Corpus

#: the order of the attribute fields in a document
FIELDS = ("title_type", "start_year", "genres")
#: rows drawn at once for the genres (a [rows, genres] array of keys)
CHUNK = 100_000


def _rng(seed: int) -> np.random.Generator:
    """The attributes' stream: independent of the titles' (``seed``)."""
    return np.random.default_rng(
        random.Random(f"{seed}:attributes").getrandbits(128))


def _weights(values) -> np.ndarray:
    w = np.asarray(values, np.float64)
    return w / w.sum()


def attributes(spec: dict, n: int, seed: int) -> Dict[str, list]:
    """The ``n`` titles' attributes of a configuration's ``attributes``."""
    rng = _rng(seed)
    types = list(spec["title_type"])
    tt = rng.choice(len(types), size=n,
                    p=_weights([spec["title_type"][t] for t in types]))
    ys = spec["start_year"]
    years = np.arange(ys["first"], ys["last"] + 1)
    year = rng.choice(years, size=n,
                      p=_weights(float(ys["growth"]) ** (years - ys["first"])))
    gs = spec["genres"]
    names = gs["by_rank"]
    log_w = np.log(1.0 / (np.arange(len(names)) + float(gs["zipf_offset"])))
    counts = sorted(gs["count"])
    count = np.asarray(counts, np.int64)[rng.choice(
        len(counts), size=n, p=_weights([gs["count"][c] for c in counts]))]
    alpha = np.argsort(np.argsort(names))       # a genre's place A-Z
    joined: Dict[tuple, str] = {}
    genres: List[str] = []
    for lo in range(0, n, CHUNK):
        hi = min(n, lo + CHUNK)
        # weighted draws without replacement: the k largest of
        # log(weight) + Gumbel noise (successive sampling, Efraimidis and
        # Spirakis 2006)
        keys = log_w - np.log(-np.log(rng.random((hi - lo, len(names)))))
        order = np.argsort(-keys, axis=1)
        for row, k in zip(order, count[lo:hi]):
            pick = tuple(sorted(row[:k], key=alpha.__getitem__))
            s = joined.get(pick)
            if s is None:
                s = joined[pick] = ",".join(names[g] for g in pick)
            genres.append(s)
    return {"title_type": [types[t] for t in tt],
            "start_year": year.tolist(), "genres": genres}


def documents(config: dict, seed: int) -> SimpleNamespace:
    titles, _ = corpus.make_titles(config["corpus"], seed)
    return SimpleNamespace(
        titles=titles,
        attributes=attributes(config["attributes"], len(titles), seed),
        kept={}, link=None)


class Recorder:
    """The engine, every call and attribute passed through; each answer
    of ``search``, ``search_batch`` and ``search_many`` leaves its facets
    in ``kept[(query text, records)]`` with the query's filter."""

    def __init__(self, eng, kept: dict):
        self._eng, self._kept = eng, kept

    def __getattr__(self, name):
        return getattr(self._eng, name)

    def _keep(self, queries, results) -> None:
        for q, r in zip(queries, results):
            if r is not None:
                self._kept.setdefault(
                    (q.text, tuple(check.answer_of(r))), []).append(
                        (q.filter, r.facets))

    def search(self, query, *a, **k):
        r = self._eng.search(query, *a, **k)
        self._keep([query], [r])
        return r

    def search_batch(self, queries, *a, **k):
        out = self._eng.search_batch(queries, *a, **k)
        self._keep(queries, out)
        return out

    def search_many(self, queries, *a, **k):
        out = self._eng.search_many(queries, *a, **k)
        self._keep(queries, out)
        return out


def engine(it, made, config: dict):
    eng = it.SearchEngine.create_default()
    docs = []
    cols = [made.attributes[f] for f in FIELDS]
    for i, (title, *values) in enumerate(zip(made.titles, *cols)):
        fields = it.DocumentFields()
        fields.add_field("title", title, weight=it.Weight.MED)
        for name, value in zip(FIELDS, values):
            fields.add_field(name, value, indexable=False, filterable=True,
                             facetable=True)
        docs.append(it.Document(i, fields))
    eng.index_documents(docs)
    # the judge links a query's filter text to the filters it kept by
    # the program's own bytecode of each (the reference's semantics are
    # its own; this only finds the answers to judge)
    def link(f):
        if f is None:
            return None
        return (it.Filter.parse(f) if isinstance(f, str)
                else f).compile_to_bytes()

    made.link = link
    return Recorder(eng, made.kept)


def reference(made) -> refine.Reference:
    ref = refine.Reference(Corpus(made.titles), made.attributes)
    ref.observed = functools.partial(observed, made)
    return ref


def observed(made, spec, got) -> List[dict]:
    """The facets the program served with ``got`` for ``spec``'s text and
    filter, one entry an answer."""
    if got is None:
        return []
    want = made.link(dict(spec.options).get("filter"))
    return [facets for f, facets in made.kept.get(
        (spec.text, tuple(got)), []) if made.link(f) == want]


def judge(ref: refine.Reference, specs, got, replayed, state, top: int,
          log=None):
    return refine.judge(ref, specs, got, replayed, state, top,
                        observed=ref.observed, log=log)
