"""The index build's one native pass over the corpus (``native/bulk.py``
``BulkIndexer.add_raw``, ``_lib.cpp`` ``infidex_bulk_add_raw``) and the
per-document products it hands the later build phases.

Held exactly, on every case below: each product of the fused build (the
bulk pass) equals what the per-document build (``index_documents`` with
``_can_bulk_index`` off, every phase deriving it from the documents) and
the reference package (infidex_tpu, JAX on the CPU) build: ``norm_texts``,
every ``CoverageTables`` array with the fake-LCS text table, the
metadata cache, the first-token index, the word document frequencies and
idf cache, the short-query doc tables and champion lists, and the
deleted / document-key arrays.

The pass derives a document's texts itself where ``fold_tables`` covers
every code point of it: held code point by code point and on random
strings against the Python recipes, and a document with any other code
point takes the recipes (counted by ``build.native_docs`` /
``build.fallback_docs``).
"""

import importlib
import random

import numpy as np
import pytest
import torch

import infidex_tpu as ref
import infidex_tpu_torch as port
from infidex_tpu_torch import runtime, tracing
from infidex_tpu_torch.core.config import get_config
from infidex_tpu_torch.native import bulk
from infidex_tpu_torch.tokenization.normalizer import \
    _DEFAULT_CHAR_REPLACEMENTS

runtime.set_device("cpu")
# the suite runs in several worker processes on shared cores
torch.set_num_threads(1)

pytestmark = pytest.mark.skipif(not bulk.bulk_available(),
                                reason="native bulk builder unavailable")

TITLES = [
    "The Shawshank Redemption", "The Godfather", "Pulp Fiction",
    "Schindler's List", "Zelená škola", "Star Wars: Episode IV - A New Hope",
    "Dr. Strangelove, or: How I Learned to Stop Worrying", "Amélie",
    "WALL·E", "Léon: The Professional", "a", "to be", "Up",
    "Once Upon a Time... in Hollywood", "Alien", "Aliens",
    # words past the coverage tables' L (24 chars) and D (64 words)
    "Supercalifragilisticexpialidocious Anticonstitutionnellement",
    "Supercalifragilisticexpiation",  # its first 24 chars as above
    " ".join(f"w{i % 9}" for i in range(70)),
]
#: code points the fold table does not cover, each in a title of its own
UNCOVERED = ["İstanbul Günleri", "Großes ẞ Haus", "ΟΔΟΣ Σοφίας",
             "Smile 😀 Again", "Москва"]


def _repeat(titles, n=320):
    return [titles[i % len(titles)] for i in range(n)]


def _case_tabs():
    extra = ["The\tGodfather", "  Pulp   Fiction  ", "Star\nWars\r\nIV",
             "tab\t\tand  spaces", " \t ", "a  b   c    d", "x\ry", " Up ",
             "\tab", "ab\u2003", "\xa0x"]
    return _repeat(TITLES + extra)


def _case_mixed_case():
    return _repeat([t.swapcase() for t in TITLES] + [t.upper()
                                                      for t in TITLES])


def _case_table():
    keys = sorted(_DEFAULT_CHAR_REPLACEMENTS)
    titles = [f"ab{k}cd {k}x {k}{k} y{k}" for k in keys]
    titles += ["".join(keys[i:i + 7]) + " word" for i in range(0, len(keys), 7)]
    return _repeat(titles + TITLES)


def _case_special():
    return _repeat(TITLES + UNCOVERED + ["Straße · ßig", "ıi Iı",
                                         "middle·dot", "São Paulo"])


def _case_empty():
    return _repeat(TITLES + ["", "", " ", "-", "--- ...", "§"])


CASES = {"tabs": _case_tabs, "mixed_case": _case_mixed_case,
         "char_table": _case_table, "special": _case_special,
         "empty": _case_empty}


def _module(pkg, name):
    return importlib.import_module(f"{pkg.__name__}.{name}")


def _docs(pkg, case):
    if case == "multifield":
        fields = _module(pkg, "api.fields")
        high, low = fields.Weight.HIGH, fields.Weight.LOW
        out = []
        for i, t in enumerate(_repeat(TITLES + UNCOVERED[:2])):
            f = fields.DocumentFields()
            f.add_field(fields.Field("title", t, high))
            f.add_field(fields.Field("body", f"Body\twords  {i % 7} ß", low))
            f.add_field(fields.Field("year", 1990 + i % 30, low,
                                     indexable=False, filterable=True))
            out.append(pkg.Document(i, f))
        return out
    if case == "segmented":
        out = []
        for i, t in enumerate(_repeat(TITLES + UNCOVERED[:1], 300)):
            out.append(pkg.Document(i, t))
            if i % 5 == 0:
                seg = pkg.Document(i, t + " continued Segment text")
                seg.segment_number = 1
                out.append(seg)
        return out
    titles = _repeat(TITLES, 300) if case == "synonyms" else CASES[case]()
    docs = [pkg.Document(i, t) for i, t in enumerate(titles)]
    for d in docs[3::17]:
        d.deleted = True  # indexed as deleted
    return docs


def _engine(pkg, case, fused=True):
    if case == "synonyms":
        syn = _module(pkg, "synonyms").SynonymMap()
        syn.add_synonym("godfather", "padrino")
        syn.add_synonym("alien", "xenomorph")
        syn.add_synonym("up", "above")
        config = _module(pkg, "core.config").get_config(400)
        eng = pkg.SearchEngine(
            index_sizes=config.index_sizes,
            start_pad_size=config.start_pad_size,
            stop_pad_size=config.stop_pad_size, enable_coverage=True,
            text_normalizer=config.text_normalizer,
            tokenizer_setup=config.tokenizer_setup,
            stop_term_limit=config.stop_term_limit,
            word_matcher_setup=config.word_matcher_setup,
            field_weights=config.field_weights, synonym_map=syn)
    else:
        eng = pkg.SearchEngine.create_default()
    if not fused:
        eng._can_bulk_index = lambda dl: False
    eng.index_documents(_docs(pkg, case))
    return eng


def _np(x):
    if isinstance(x, torch.Tensor):
        x = x.cpu().numpy()
    return np.asarray(x).astype(np.int64)


COV = ("word_chars", "word_chars_rev", "word_lens", "doc_tokens",
       "doc_tok_offsets", "doc_tok_count", "doc_adj_ws", "doc_text_len",
       "overflow", "tok_count_host", "max_wlen_host", "text_chars",
       "lcs_ok", "lcs_ok_host")


def _products(eng):
    m = eng.vector_model
    ct = m.coverage_tables
    fti = m.first_token_index
    res = eng.vector_model.short_query_resolver
    tables = res.ensure_tables()
    res.build_all_champions()
    out = {
        "norm_texts": list(m.norm_texts),
        "coverage_sizes": (ct.n_docs, ct.n_words),
        "metadata": [(d.first_token, d.token_count) for d in m.doc_metadata],
        "first_docs": {w: d.tolist() for w, d in fti._docs.items()},
        "first_sorted": list(fti._sorted_words),
        "first_sd": fti._sd,
        "word_df": dict(m._word_df),
        "word_idf": dict(m.word_idf_cache),
        "champions": {p: [(e.score, e.document_id) for e in lst]
                      for p, lst in res._champion_lists.items()},
        "deleted": m.deleted_arr.tolist(),
        "doc_keys": m.doc_keys_arr.tolist(),
    }
    for k in COV:
        out["coverage." + k] = _np(getattr(ct, k))
    for k, v in tables.items():
        out["sq." + k] = ({w: a.tolist() for w, a in v.items()}
                          if isinstance(v, dict) else v.tolist())
    return out


def _assert_same(got, want, label):
    assert set(got) == set(want)
    for k in want:
        if isinstance(want[k], np.ndarray):
            np.testing.assert_array_equal(got[k], want[k],
                                          err_msg=f"{label}: {k}")
        else:
            assert got[k] == want[k], f"{label}: {k}"


@pytest.mark.parametrize("case", list(CASES) + ["multifield", "segmented",
                                                "synonyms"])
def test_every_build_product_is_the_per_document_build(case):
    fused = _engine(port, case)
    assert "bulk_index" in fused.get_statistics().build_seconds
    assert fused.vector_model._bulk_image is None  # dropped after the build
    perdoc = _engine(port, case, fused=False)
    assert "index_documents" in perdoc.get_statistics().build_seconds
    want = _products(perdoc)
    _assert_same(_products(fused), want, "per-document build")
    _assert_same(_products(_engine(ref, case)), want, "reference")


def test_search_after_the_fused_build():
    """Searches read the products: the same records as the per-document
    build, over short, typo and multi-word queries."""
    fused, perdoc = _engine(port, "special"), _engine(port, "special", False)
    for q in ["shawshank", "shawshenk", "the godfathr", "zelena skola",
              "star wars", "alien", "a", "th", "up", "walle", "strasse",
              "istanbul", "ss"]:
        got = [(r.document_id, r.score) for r in
               fused.search(port.Query(q, 10)).records]
        assert got == [(r.document_id, r.score) for r in
                       perdoc.search(port.Query(q, 10)).records], q


def test_products_unused_after_a_later_write():
    """A document added after the pass leaves its products unread."""
    eng = port.SearchEngine.create_default()
    m = eng.vector_model
    captured = {}
    build = m.build_inverted_lists

    def spy():
        captured["fresh"] = m._bulk_product("deleted") is not None
        eng.vector_model.documents.add_document(port.Document(9999, "late"))
        captured["stale"] = m._bulk_product("deleted") is None
        build()

    m.build_inverted_lists = spy
    eng.index_documents(_docs(port, "tabs"))
    assert captured == {"fresh": True, "stale": True}
    assert m.deleted_arr.size == len(m.documents)


# -- the fold table against the Python recipes --------------------------------
def _recipes(m, raw):
    """The five texts the build phases derive from one raw text."""
    norm = m.tokenizer.text_normalizer
    index_text = m.normalize_doc_text(raw)
    return (norm.normalize(index_text), index_text,
            norm.normalize(raw.lower()), m._coverage_text(raw),
            m._df_text(raw))


def _folded(fold, raw):
    _, lower, f, collapse = fold
    out = "".join(chr(f[ord(c)]) for c in raw)
    while collapse and "  " in out:
        out = out.replace("  ", " ")
    return out, "".join(chr(lower[ord(c)]) for c in raw)


def _covered_strings(fold, n, seed):
    rng = random.Random(seed)
    alphabet = [chr(c) for c in np.flatnonzero(fold[0])]
    return ["".join(rng.choice(alphabet) for _ in range(rng.randint(0, 12)))
            for _ in range(n)]


def test_fold_table_reproduces_the_recipes():
    m = port.SearchEngine.create_default().vector_model
    fold = bulk.fold_tables(m.tokenizer.text_normalizer)
    covered = fold[0]
    # every key of the default table folds one to one
    for k in _DEFAULT_CHAR_REPLACEMENTS:
        assert covered[ord(k)] == (k != "İ"), k
    assert covered[:0x80].all()  # ASCII
    assert not covered[0x130]  # "İ".lower() is two code points
    singles = [chr(c) * r + chr(d) for c in range(bulk.FOLD_LIMIT)
               if covered[c] for r in (1, 2) for d in (32, 9, 65)]
    for raw in singles + _covered_strings(fold, 3000, 5):
        folded, lowered = _folded(fold, raw)
        assert set(_recipes(m, raw)) == {folded}, repr(raw)
        assert raw.lower() == lowered, repr(raw)


def _products_of(indexer):
    terms = indexer.export_terms()
    out = {"terms": terms[0]}
    for i, a in enumerate(terms[1:]):
        out[f"postings{i}"] = a
    for which in range(8):
        keys, off, ids = indexer.export_map(which)
        out[f"map{which}"] = (keys, off.tolist(), ids[:off[-1]].tolist())
    out["sq"] = {k: v.tolist() for k, v in indexer.export_sq().items()}
    prods = indexer.export_products()
    for k, v in prods.items():
        if k == "coverage":
            for i, a in enumerate(v):
                out[f"coverage{i}"] = a
        elif k == "norm":
            out["norm_blob"] = v[0][:v[1][-1]]
            out["norm_off"], out["lcs_slow"] = v[1], v[2]
        elif isinstance(v, dict):
            out[k] = {w: (a.tolist() if hasattr(a, "tolist") else a)
                      for w, a in v.items()}
        else:
            out[k] = v
    return out


def _indexer(m, wm, limit):
    from infidex_tpu_torch.ops.coverage_kernel import D_MAX, L_MAX

    c = get_config(400)
    ix = bulk.BulkIndexer(c.index_sizes, c.start_pad_size, c.stop_pad_size,
                          c.tokenizer_setup.delimiters, True,
                          c.stop_term_limit, c.field_weights,
                          wm_setup=c.word_matcher_setup, sq_minmax=(1, 3))
    ix.enable_products(bulk.fold_tables(m.tokenizer.text_normalizer, limit),
                       D_MAX, L_MAX)
    return ix


@pytest.mark.parametrize("which", ["code_points", "random", "uncovered",
                                   "greek"])
def test_native_texts_equal_the_recipes(which):
    """Every product of a chunk the pass normalizes itself equals the
    same chunk's products with every document's texts from the Python
    recipes (fold table empty). "greek" takes a wider fold table, up to
    U+03FF: its capital sigma lowers by its neighbours, so stays out."""
    eng = port.SearchEngine.create_default()
    m, wm = eng.vector_model, eng.word_matcher
    limit = 0x400 if which == "greek" else bulk.FOLD_LIMIT
    fold = bulk.fold_tables(m.tokenizer.text_normalizer, limit)
    if which == "greek":
        assert fold[0][0x391:0x3A3].all() and not fold[0][0x3A3]
        titles = ["ΟΔΟΣ ΣΟΦΙΑΣ", "ΣΑΣ", "Σ", "ΑΣ.Β", "σς Σσ"] + TITLES
    elif which == "code_points":
        titles = [f"a{chr(c)}b {chr(c)}{chr(c)}X {chr(c)} Zz{chr(c)}"
                  for c in range(bulk.FOLD_LIMIT)]
        titles += [f"{k}{k.upper()} x{k}" for k in _DEFAULT_CHAR_REPLACEMENTS]
    elif which == "random":
        titles = _covered_strings(fold, 2000, 11)
    else:
        titles = [t + " tail" for t in UNCOVERED] + TITLES
    deleted = [i % 13 == 5 for i in range(len(titles))]

    def recipe(raw, dead):
        index_text = m.normalize_doc_text(raw)
        norm = m.tokenizer.text_normalizer
        return (norm.normalize(index_text), index_text, wm._normalize(raw),
                m._coverage_text(raw),
                "" if dead or not raw else m._df_text(raw), raw.lower())

    got = {}
    for label, lim in (("native", limit), ("recipes", 0)):
        ix = _indexer(m, wm, lim)
        n_fb = ix.add_raw(titles, list(range(len(titles))),
                          [False] * len(titles), [[(0, 0)]] * len(titles),
                          deleted, recipe)
        got[label] = (n_fb, _products_of(ix))
        ix.close()
    n_native_fb, native = got["native"]
    assert got["recipes"][0] == sum(1 for t in titles if t)
    if which == "uncovered":
        assert n_native_fb == len(UNCOVERED)
    else:
        assert n_native_fb == sum(
            not all(ord(c) < limit and fold[0][ord(c)] for c in t)
            for t in titles)
    want = got["recipes"][1]
    assert set(native) == set(want)
    for k in want:
        if isinstance(want[k], np.ndarray):
            np.testing.assert_array_equal(native[k], want[k], err_msg=k)
        else:
            assert native[k] == want[k], k


# -- the counters --------------------------------------------------------------
@pytest.mark.parametrize("on", [False, True])
def test_native_and_fallback_docs_counted(on):
    titles = _repeat(TITLES, 600) + UNCOVERED * 3
    eng = port.SearchEngine.create_default()
    if on:
        tracing.start()
    try:
        eng.index_documents([port.Document(i, t)
                             for i, t in enumerate(titles)])
    finally:
        snap = tracing.stop()
    if not on:
        assert snap == tracing.Snapshot([], {})
        return
    counts = {k: v for k, v in snap.counters.items()
              if k.startswith("build.")}
    assert counts == {"build.native_docs": 600,
                      "build.fallback_docs": 3 * len(UNCOVERED)}
