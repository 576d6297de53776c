"""Corpus and query generators: deterministic by seed, bench.py's recipe;
the titles deployment and the upstream generator give what the harness
gave before they were split out of it."""

import hashlib
import random

import pytest

from benchmark import corpus, generators, run
from benchmark.deployments import titles as titles_deployment
from benchmark.generators import upstream as queries

#: bench.py make_corpus(1_000_000)[:6] (its random.Random(1234)), frozen
BENCH_FIRST_TITLES = [
    "The Shawshank Redemption",
    "Meron Usstquaqua Giulpolsa",
    "Wenstfa Shadow Hankachtor Chjiyor Inceriyor",
    "Redemption Wenhanzenin Elststfa",
    "Aruslo Hanfa Arwenbayor",
    "Viyorul Kingdom",
]


def spec(name, titles):
    cfg = run.cell_of(run.load_manifest(), name)["config_data"]
    return dict(cfg["corpus"], titles=titles)


def test_movies_recipe_matches_bench_at_1234():
    titles, vocab = corpus.make_titles(spec("movies1m.batch-mixed", 6), 1234)
    assert titles == BENCH_FIRST_TITLES
    assert len(vocab) == 50_000


def test_titles_deterministic_by_seed():
    for cell in ("movies1m.batch-mixed", "movies1m.single-mixed"):
        s = spec(cell, 500)
        big = 2**31 + 99991
        assert corpus.make_titles(s, big) == corpus.make_titles(s, big)
        assert corpus.make_titles(s, big)[0] != corpus.make_titles(
            s, big + 1)[0]
        titles, _ = corpus.make_titles(s, big)
        assert titles[0] == "The Shawshank Redemption"
        assert all(2 <= len(t.split()) <= 5 for t in titles[1:])


KINDS = {"exact": 1, "typo": 1, "split": 1, "partial": 1}


def test_queries_deterministic_and_balanced():
    titles, _ = corpus.make_titles(spec("movies1m.batch-mixed", 300), 7)
    a = queries.make_queries(titles, KINDS, 400,
                             generators.streams(5)["timed"])
    b = queries.make_queries(titles, KINDS, 400,
                             generators.streams(5)["timed"])
    c = queries.make_queries(titles, KINDS, 400,
                             generators.streams(6)["timed"])
    assert a == b and a != c
    # a split and a partial query a block of four bring a space
    assert sum(" " in q for q in a) >= 190


def test_chunks_continue_the_stream():
    titles, _ = corpus.make_titles(spec("movies1m.batch-mixed", 300), 7)
    whole = queries.make_queries(titles, KINDS, 1024,
                                 generators.streams(3)["timed"])
    rng = generators.streams(3)["timed"]
    parts = [q for _ in range(4)
             for q in queries.make_queries(titles, KINDS, 256, rng)]
    assert parts == whole


def test_upstream_query_kinds():
    """QueryBenchmarks.cs's examples: "Shaaawshank", "Shaa awashank"
    (here "Shaa awshank"), "redemption shank"."""
    rng = random.Random(0)
    for word in ("Shawshank", "Redemption", "abcd"):
        t = queries.typo(word, rng)
        i = next(i for i, (x, y) in enumerate(zip(word, t)) if x != y) - 1
        assert t == word[:i] + word[i] * 3 + word[i + 1:] and i >= 1
        s = queries.split_typo(word, rng)
        assert s.replace(" ", "") in {word[:j] + word[j] * 3 + word[j + 1:]
                                      for j in range(1, len(word) - 1)}
        assert s.count(" ") == 1 and s[0] == word[0]
    assert queries.typo("abc", rng) == "abc"
    assert queries.split_typo("abc", rng) == "abc"
    assert queries.tail("shawshank") == "shank"
    assert queries.tail("knight") == "ght"
    q = queries.one_query("partial", "The Shawshank Redemption",
                          random.Random(3))
    first, second = q.split(" ")
    assert first in ("The", "Shawshank", "Redemption")
    assert second in ("the", "shank", "mption") and \
        second != first.lower()[-len(second):]


def digest(texts):
    return hashlib.sha256("\n".join(texts).encode()).hexdigest()[:32]


#: sha256 of the movies-1m titles (``corpus.make_titles``, 1M titles, as
#: ``run.py`` made them before the deployments were split out of it)
PARENT_TITLES = {1: "2bfb0098a17907b432ac39cd3eb7bd37",
                 2: "0c3942dbf89d8778257bf1925d3b6844",
                 3: "393a66f36b754a7d1fd424d4bf5fbf1a",
                 4: "08104158c03f06cb28465c2e6759b700",
                 5: "ccad346bb82949d0548754005d16d32b"}
#: sha256 of the first 4,096 texts of each stream at seed 1 over the
#: seed-1 titles, as the entries drew them before the generators were
#: split out (both traffics' four kinds weigh alike, so they agree)
PARENT_STREAMS = {"warmup": "797272898d7be239a977e3a70928f09b",
                  "timed": "770fd5ed2b87a6a6a4a9ac83b31c0e62"}


def movies(titles=None):
    cfg = run.cell_of(run.load_manifest(), "movies1m.batch-mixed")
    cfg = dict(cfg["config_data"])
    if titles is not None:
        cfg["corpus"] = dict(cfg["corpus"], titles=titles)
    return cfg


@pytest.mark.parametrize("seed", sorted(PARENT_TITLES))
def test_titles_deployment_makes_the_parents_titles(seed):
    made = titles_deployment.documents(movies(), seed)
    assert len(made.titles) == 1_000_000
    assert digest(made.titles) == PARENT_TITLES[seed]


@pytest.mark.parametrize("stream", sorted(PARENT_STREAMS))
@pytest.mark.parametrize("cell", ["movies1m.batch-mixed",
                                  "movies1m.single-mixed"])
def test_upstream_generator_draws_the_parents_streams(cell, stream):
    made = titles_deployment.documents(movies(), 1)
    traffic = run.cell_of(run.load_manifest(), cell)["traffic_data"]
    gen = run._module("generators", traffic["generator"])
    specs = gen.queries(made, traffic, 4096, generators.streams(1)[stream])
    assert all(s.options == () for s in specs)
    assert digest([s.text for s in specs]) == PARENT_STREAMS[stream]


def test_exact_traffic_sends_one_title_word_a_query():
    made = titles_deployment.documents(movies(300), 7)
    traffic = run.cell_of(run.load_manifest(),
                          "movies1m.batch-exact")["traffic_data"]
    words = {w for t in made.titles for w in t.split()}
    specs = queries.queries(made, traffic, 512,
                            generators.streams(2**31 + 7)["timed"])
    assert all(s.text in words for s in specs)
