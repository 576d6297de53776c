"""One text field of titles under ``SearchEngine.create_default()``.

Documents: ``corpus.make_titles`` over the configuration's ``corpus``
recipe, from the seed. Engine: ``create_default()`` indexing
``Document(i, title)``. Reference: ``reference.stats.Corpus`` of the
titles, judged by ``check.judge`` (its four numbers), which is written
for ASCII titles and queries without options under the default
engine's settings.
"""

from __future__ import annotations

from types import SimpleNamespace

from .. import check, corpus
from ..reference.stats import Corpus


def documents(config: dict, seed: int) -> SimpleNamespace:
    titles, _ = corpus.make_titles(config["corpus"], seed)
    return SimpleNamespace(titles=titles)


def engine(it, made, config: dict):
    eng = it.SearchEngine.create_default()
    eng.index_documents([it.Document(i, x) for i, x in enumerate(made.titles)])
    return eng


def reference(made) -> Corpus:
    return Corpus(made.titles)


def judge(ref: Corpus, specs, got, replayed, state, top: int, log=None):
    if any(s.options for s in specs):
        raise ValueError("the titles reference judges queries without "
                         "options")
    return check.judge(ref, [s.text for s in specs], got, replayed, state,
                       top, log=log)
