"""The plain reference and the port agree on the CPU, over a corpus of a
few thousand titles from the configuration's generator, for both
entries; and the reference's pieces on small cases."""

import numpy as np
import pytest
import torch

from benchmark import check, corpus, generators, run
from benchmark.generators import upstream as queries
from benchmark.reference import answers, score
from benchmark.reference.stage1 import Stage1Index, is_top, ld1
from benchmark.reference.stats import Corpus


@pytest.mark.parametrize("cell", ["movies1m.batch-mixed",
                                  "movies1m.single-mixed"])
def test_reference_equals_port_on_cpu(cell):
    import infidex_tpu_torch as it
    from infidex_tpu_torch import runtime

    torch.set_num_threads(2)
    c = run.cell_of(run.load_manifest(), cell)
    spec = dict(c["config_data"]["corpus"], titles=6000, vocab_words=2500)
    titles, _ = corpus.make_titles(spec, 2**31 + 5)
    tr = dict(c["traffic_data"], batch_size=32)
    texts = queries.make_queries(titles, tr["kinds"], 64,
                                 generators.streams(11)["timed"])
    runtime.set_device("cpu")
    eng = it.SearchEngine.create_default()
    eng.index_documents([it.Document(i, t) for i, t in enumerate(titles)])
    cap = check.Capture(eng._pipeline, tr["top"])
    if tr["entry"] == "batch":
        res = eng.search_many([it.Query(t, 10) for t in texts],
                              batch_size=32)
    else:
        res = [eng.search(it.Query(t, 10)) for t in texts]
    cap.restore()
    got = [check.answer_of(r) for r in res]
    ref = Corpus(titles)
    numbers = check.judge(ref, texts, got, got, cap.state, 10)
    assert all(v["value"] == 0 for v in numbers.values()), numbers
    assert all(got)
    index = Stage1Index(ref)
    fuzzy = sum(bool(index.query_terms(answers.query_text(t))[1])
                for t in texts)
    assert 8 <= fuzzy < len(texts)     # typo tokens reach fuzzy groups
    assert max(len(s["ids"]) for s in cap.state.values()) > 100


def test_edit_distances():
    assert score.damerau("shawshank", "shawshnak", 1) == 1
    assert score.damerau("shawshank", "shawshank", 1) == 0
    assert score.damerau("abcd", "badc", 1) > 1      # past the cap
    assert score.lev("kitten", "sitting", 5) == 3
    assert score.lev("kitten", "sitting", 1) == 2   # past the cap
    assert ld1("shawshank", "shawshak") and ld1("shawshank", "hsawshank")
    assert ld1("shawshank", "shawsahnk") and ld1("abc", "abcd")
    assert not ld1("shawshank", "shawsnahk") and not ld1("abc", "abcde")
    assert score.lcs_value("shaw", "the shawshank", 0) == 4
    assert score.lcs_value("theo", "the shawshank", 1) == 4


def test_k_best_keeps_any_titles_of_the_cut_tie():
    best = [(4, 9.0), (1, 5.0), (2, 5.0), (3, 5.0)]
    assert is_top([(4, 9.0), (1, 5.0)], best, 4, 2)
    assert is_top([(4, 9.0), (3, 5.0)], best, 4, 2)
    assert not is_top([(1, 5.0), (4, 9.0)], best, 4, 2)
    assert not is_top([(4, 9.0), (5, 5.0)], best, 4, 2)
    assert not is_top([(4, 9.0)], best, 4, 2)
    assert is_top([(4, 9.0), (1, 5.0), (2, 5.0), (3, 5.0)], best, 4, 10)


def test_stage1_weights_and_lengths():
    ref = Corpus(["The Shawshank Redemption", "Redemption Day",
                  "Dark Dark Knight", "Aaa aaa aaaa"])
    index = Stage1Index(ref)
    assert index.dl.tolist() == [27, 16, 19, 15] and index.avgdl == 19.25
    assert index.posting("aaa").tf.tolist() == [6]     # 4 grams, 2 words
    assert index.posting("the").tf.tolist() == [2]
    terms, groups = index.query_terms("shawshenk day")
    assert len(groups) == 1 and groups[0]["host"][1].tolist() == [0]
    s = index.scores("redemption", np.arange(4))
    assert s["card"][0] > 0 and s["card"][2] == 0
    np.testing.assert_array_equal(s["card"], s["host"])
