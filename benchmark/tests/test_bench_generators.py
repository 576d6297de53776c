"""Corpus and query generators: deterministic by seed, bench.py's recipe."""

import random

from benchmark import corpus, queries, run

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
    a = queries.make_queries(titles, KINDS, 400, queries.streams(5)["timed"])
    b = queries.make_queries(titles, KINDS, 400, queries.streams(5)["timed"])
    c = queries.make_queries(titles, KINDS, 400, queries.streams(6)["timed"])
    assert a == b and a != c
    # a split and a partial query a block of four bring a space
    assert sum(" " in q for q in a) >= 190


def test_chunks_continue_the_stream():
    titles, _ = corpus.make_titles(spec("movies1m.batch-mixed", 300), 7)
    whole = queries.make_queries(titles, KINDS, 1024,
                                 queries.streams(3)["timed"])
    rng = queries.streams(3)["timed"]
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
