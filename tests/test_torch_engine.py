"""The slice end to end: ``SearchEngine.search_batch`` of the port
(infidex_tpu_torch, plain PyTorch on the CPU) against the reference
(infidex_tpu, JAX on the CPU) on bench.py's workload at 3000 docs.

Held exactly: the doc ids of every result list, in order. Scores may
differ by at most 1 f32 ulp: XLA's CPU backend contracts the multiply-adds
of the BM25+ posting factor into FMAs and evaluates the fuzzy idf's log1p
with its own approximation, while the port rounds every operation and
takes log1p in f64 (so that the CPU and the GPU agree bit for bit).
"""

import os
import sys

import numpy as np
import pytest
import torch

import bench
import infidex_tpu as ref
import infidex_tpu_torch as port
from infidex_tpu_torch import runtime

runtime.set_device("cpu")
# the suite runs in several worker processes on shared cores; one intra-op
# thread each keeps torch from oversubscribing them
torch.set_num_threads(1)

#: score tolerance in f32 ulps (see module docstring)
MAX_ULP = 1
BATCH = 32


@pytest.fixture(scope="module")
def corpus():
    titles = bench.make_corpus(3000)
    return titles, bench.make_queries(titles, 64)


def _engine(pkg, titles):
    eng = pkg.SearchEngine.create_default()
    eng.index_documents([pkg.Document(i, t) for i, t in enumerate(titles)])
    return eng


def _run(pkg, eng, queries):
    out = []
    for i in range(0, len(queries), BATCH):
        out += eng.search_batch([pkg.Query(q, 10)
                                 for q in queries[i:i + BATCH]])
    return [([r.document_id for r in res.records],
             np.array([r.score for r in res.records], np.float32))
            for res in out]


def test_search_batch_same_ids_order_and_scores(corpus):
    titles, queries = corpus
    want = _run(ref, _engine(ref, titles), queries)
    eng = _engine(port, titles)
    got = _run(port, eng, queries)
    assert eng._pipeline.device_calls > 0
    assert sum(len(ids) for ids, _ in got) > 0
    for q, (wi, ws), (gi, gs) in zip(queries, want, got):
        assert gi == wi, q
        ulps = np.abs(ws.view(np.int32).astype(np.int64)
                      - gs.view(np.int32).astype(np.int64))
        assert ulps.max(initial=0) <= MAX_ULP, q


def test_typo_query_finds_the_title():
    docs = ["The Shawshank Redemption", "Redemption Day"]
    for pkg in (ref, port):
        eng = _engine(pkg, docs)
        (res,) = eng.search_batch([pkg.Query("shawshenk", 5)])
        assert res.records and res.records[0].document_id == 0, pkg.__name__


def test_port_search_many_equals_search_batch(corpus):
    titles, queries = corpus
    eng = _engine(port, titles[:500])
    qs = queries[:16]
    a = eng.search_batch([port.Query(q, 10) for q in qs])
    b = eng.search_many([port.Query(q, 10) for q in qs])
    for x, y in zip(a, b):
        assert [(r.document_id, r.score) for r in x.records] == \
            [(r.document_id, r.score) for r in y.records]


def test_no_jax_in_the_port_package():
    """Every module file the port owns is free of jax imports (the
    subprocess test in test_torch_no_jax.py checks the loaded modules)."""
    root = os.path.dirname(port.__file__)
    for dirpath, _, files in os.walk(root):
        for f in files:
            if f.endswith(".py"):
                with open(os.path.join(dirpath, f)) as fh:
                    src = fh.read()
                assert "import jax" not in src and "from jax" not in src, f
    assert "infidex_tpu_torch" in sys.modules
