"""The port's tracer (``infidex_tpu_torch/tracing.py``) and the spans and
counters inside the program, on a small corpus on the CPU.

Off, the tracer records nothing and changes no result. On, over
``search_many`` at pipeline depth 2 (interleaved batch generators),
``search_batch`` and ``search``: every child lies inside its parent on the
same thread, or runs on a worker thread under the span that submitted it;
every span of a batch carries that batch's request id; no span stays open
across a generator's yield; the route counters add up to the queries and
jobs that took a route; the memo counters add up to the lookups; the
index build's phases fit inside its wall.
"""

import random
import sys
import threading
import time
from collections import Counter

import pytest
import torch

import infidex_tpu_torch as it
from infidex_tpu_torch import runtime, tracing
from infidex_tpu_torch.index import conjunctive

runtime.set_device("cpu")
# the suite runs in several worker processes on shared cores
torch.set_num_threads(1)

WORDS = ("shawshank redemption day quixotic adventure night dark knight "
         "return king lord rings star wars empire strikes back matrix "
         "reloaded godfather casablanca vertigo psycho alien forest gump "
         "titanic gladiator inception memento amelie").split()
#: exact words, typos, splits, partial words, short and one-letter queries
QUERIES = ["shawshenk", "redemption day", "knigt", "lord rings", "st", "a",
           "star wors", "matrix reloded", "godfater", "casa blanca",
           "inceptoin memento", "dark knight return", "gladiat", "vertigo",
           "empire strkes back", "amelie forest"]


def _titles(n=2000, seed=7):
    rng = random.Random(seed)
    return [" ".join(rng.choice(WORDS) for _ in range(rng.randint(2, 5)))
            for _ in range(n)]


@pytest.fixture(scope="module")
def engine():
    assert not tracing.enabled()
    eng = it.SearchEngine.create_default()
    eng.index_documents([it.Document(i, t) for i, t in enumerate(_titles())])
    return eng


@pytest.fixture(scope="module")
def untraced(engine):
    """Each entry's results with the tracer off, served once."""
    cache = {}

    def get(entry):
        if entry not in cache:
            assert not tracing.enabled()
            cache[entry] = _serve(engine, entry)
        return cache[entry]

    return get


@pytest.fixture
def traced():
    tracing.start()
    try:
        yield
    finally:
        tracing.stop()


def _records(results):
    return [[(r.document_id, r.score) for r in res.records]
            for res in results]


def _serve(eng, entry, queries=QUERIES * 2):
    qs = [it.Query(q, 10) for q in queries]
    if entry == "search":
        return _records(eng.search(q) for q in qs)
    if entry == "search_batch":
        return _records(eng.search_batch(qs))
    return _records(eng.search_many(qs, batch_size=8, pipeline_depth=2))


# -- the tracer itself -------------------------------------------------------
def test_off_records_nothing(untraced):
    assert not tracing.enabled()
    assert tracing.span("a.b") is tracing.span("c.d")
    assert tracing.request() is None
    fn = len
    assert tracing.bind("worker.x", fn) is fn
    tracing.count("x.y", 3)
    untraced("search_many")
    untraced("search")
    assert tracing.snapshot() == tracing.Snapshot([], {})
    assert tracing.stop() == tracing.Snapshot([], {})


@pytest.mark.parametrize("entry", ["search", "search_batch", "search_many"])
def test_results_bit_identical_off_and_on(engine, untraced, entry):
    off = untraced(entry)
    tracing.start()
    try:
        on = _serve(engine, entry)
    finally:
        snap = tracing.stop()
    assert on == off
    assert snap.spans and snap.counters


def test_snapshot_keeps_and_stop_clears(traced):
    with tracing.span("a.outer", request=tracing.request()):
        with tracing.span("a.inner"):
            tracing.count("a.n", 2)
    first = tracing.snapshot()
    assert [s.name for s in first.spans] == ["a.inner", "a.outer"]
    assert tracing.snapshot() == first
    inner, outer = first.spans
    assert inner.parent_id == outer.span_id and outer.parent_id is None
    assert inner.request_id == outer.request_id is not None
    assert outer.start <= inner.start <= inner.end <= outer.end
    last = tracing.stop()
    assert last == first and first.counters == {"a.n": 2}
    assert not tracing.enabled()


def test_bind_runs_under_the_submitting_span(traced):
    from concurrent.futures import ThreadPoolExecutor

    with ThreadPoolExecutor(2) as pool:
        with tracing.span("a.submit", request=tracing.request()):
            fut = pool.submit(tracing.bind("worker.job", time.sleep), 0.01)
        fut.result()
    spans = {s.name: s for s in tracing.snapshot().spans}
    job, sub = spans["worker.job"], spans["a.submit"]
    assert job.parent_id == sub.span_id
    assert job.request_id == sub.request_id
    assert job.thread_id != sub.thread_id


def test_counts_and_spans_from_many_threads(traced):
    n_threads, n_each = 32, 300
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def work():
            for _ in range(n_each):
                with tracing.span("stress.outer"):
                    with tracing.span("stress.inner"):
                        tracing.count("stress.n")
        threads = [threading.Thread(target=work) for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    snap = tracing.snapshot()
    assert snap.counters["stress.n"] == n_threads * n_each
    by_id = {s.span_id: s for s in snap.spans}
    assert len(by_id) == len(snap.spans) == 2 * n_threads * n_each
    for s in snap.spans:
        if s.name == "stress.inner":
            parent = by_id[s.parent_id]
            assert parent.name == "stress.outer"
            assert parent.thread_id == s.thread_id


# -- spans inside the program --------------------------------------------------
@pytest.fixture
def batch_yields(engine, monkeypatch):
    """The instants at which each batch generator yielded."""
    pipe = engine._pipeline
    orig = type(pipe).execute_batch_gen
    yields = []

    def recording(self, *args, **kwargs):
        gen = orig(self, *args, **kwargs)
        while True:
            try:
                point = next(gen)
            except StopIteration as stop:
                return stop.value
            yields.append(time.perf_counter())
            yield point

    monkeypatch.setattr(type(pipe), "execute_batch_gen", recording)
    return yields


def _check_tree(spans):
    by_id = {s.span_id: s for s in spans}
    assert len(by_id) == len(spans)
    for s in spans:
        assert s.start <= s.end
        assert "." in s.name, s.name
        if s.parent_id is None:
            assert s.name.startswith(("engine.", "build.")), s.name
            continue
        parent = by_id[s.parent_id]
        if parent.thread_id == s.thread_id:
            assert parent.start <= s.start and s.end <= parent.end, (parent,
                                                                      s)
        else:                       # a worker job, under its submitter
            assert s.name.startswith("worker."), s.name
            assert s.start >= parent.start
        if parent.name not in ("engine.search_many", "engine.search_batch"):
            # a batch draws its own request id under its call's root
            assert s.request_id == parent.request_id, (parent, s)
    return by_id


def test_span_tree_of_interleaved_batches(engine, batch_yields, traced):
    _serve(engine, "search_many")
    snap = tracing.snapshot()
    by_id = _check_tree(snap.spans)
    roots = [s for s in snap.spans if s.name == "engine.search_many"]
    assert len(roots) == 1
    n_batches = -(-len(QUERIES) * 2 // 8)
    steps = [s for s in snap.spans if s.name == "pipeline.batch"]
    assert all(s.parent_id == roots[0].span_id for s in steps)
    rids = Counter(s.request_id for s in steps)
    assert len(rids) == n_batches and roots[0].request_id not in rids
    # every span below a batch carries that batch's request id; workers too
    for s in snap.spans:
        top = s
        while top.parent_id is not None and top.name != "pipeline.batch":
            top = by_id[top.parent_id]
        if top.name == "pipeline.batch":
            assert s.request_id == top.request_id
    workers = [s for s in snap.spans if s.name.startswith("worker.")]
    assert workers and all(s.request_id in rids for s in workers)
    # batches interleave (depth 2) and no span is open across a yield
    assert len(batch_yields) >= n_batches
    order = [s.request_id for s in sorted(steps, key=lambda s: s.start)]
    assert any(a != b for a, b in zip(order, order[1:]))
    pipe_thread = roots[0].thread_id
    for s in snap.spans:
        if s.thread_id != pipe_thread or s.name.startswith("engine."):
            continue
        assert not any(s.start < y < s.end for y in batch_yields), s
    names = {s.name for s in snap.spans}
    assert {"pipeline.stage1_prep", "pipeline.coverage_begin",
            "pipeline.wm_wait", "pipeline.conj_wait", "pipeline.prior",
            "pipeline.heads", "pipeline.memo", "coverage.prepare_query",
            "pipeline.coverage_run_begin", "pipeline.host_oracle",
            "pipeline.coverage_run_end", "pipeline.device_wait",
            "worker.wm_prefetch", "worker.conj_pool"} <= names


def test_span_tree_of_single_searches(engine, traced):
    _serve(engine, "search", QUERIES)
    snap = tracing.snapshot()
    _check_tree(snap.spans)
    roots = [s for s in snap.spans if s.name == "engine.search"]
    assert len(roots) == len(QUERIES)
    assert len({s.request_id for s in roots}) == len(QUERIES)
    names = {s.name for s in snap.spans}
    assert {"pipeline.stage1", "vector_model.prepare_stage1",
            "vector_model.finish_stage1", "pipeline.gate",
            "pipeline.coverage_begin", "word_matcher.lookup",
            "pipeline.coverage_run_begin", "pipeline.host_oracle",
            "pipeline.coverage_run_end", "pipeline.coverage_finish",
            "engine.post_process"} <= names
    routes = {"vector_model.stage1_host", "vector_model.stage1_device",
              "vector_model.stage1_tiered", "pipeline.stage1_short"}
    for root in roots:         # one Stage-1 route a search, under its root
        got = [s for s in snap.spans
               if s.request_id == root.request_id and s.name in routes]
        assert len(got) == 1, got


def _stage1_queries(eng, queries):
    """Queries that reach Stage 1: non-blank, with a scoreable term or
    too short for n-grams."""
    from infidex_tpu_torch.scoring.pipeline import analyze_query

    model = eng.vector_model
    n = 0
    for q in queries:
        text = q.strip().lower()
        can_use, mixed, long_text = analyze_query(text, model.tokenizer)
        if not can_use or model.prepare_stage1(long_text if mixed
                                               else text) is not None:
            n += 1
    return n


@pytest.mark.parametrize("entry", ["search", "search_batch", "search_many"])
def test_counters_add_up(engine, entry, monkeypatch):
    pipe = engine._pipeline
    seen = Counter()
    run_begin = type(pipe)._coverage_run_begin
    dispatch = type(pipe)._dispatch_chunk
    pool = conjunctive.conjunctive_pool
    impl = conjunctive._conjunctive_pool_impl

    def count_jobs(self, jobs, setup):
        seen["jobs"] += len(jobs)
        seen["items"] += sum(j["worklist_ids"].size if j.get("fast")
                             else len(j["worklist"]) for j in jobs)
        return run_begin(self, jobs, setup)

    def count_chunks(self, *args, **kwargs):
        seen["chunks"] += 1
        return dispatch(self, *args, **kwargs)

    def count_pool(model, groups, prep):
        if model.built is not None and len(groups) >= 2:
            seen["pool_lookups"] += 1
        return pool(model, groups, prep)

    def count_words(model, built, groups, prep):
        seen["word_lookups"] += len(groups)
        return impl(model, built, groups, prep)

    monkeypatch.setattr(type(pipe), "_coverage_run_begin", count_jobs)
    monkeypatch.setattr(type(pipe), "_dispatch_chunk", count_chunks)
    monkeypatch.setattr(conjunctive, "conjunctive_pool", count_pool)
    monkeypatch.setattr(conjunctive, "_conjunctive_pool_impl", count_words)
    # fresh memos, so that the window holds misses, hits and a full
    # evidence memo
    engine.vector_model._conj_pool_memo = None
    engine.vector_model._conj_token_evidence = None
    queries = QUERIES * 2
    tracing.start()
    try:
        _serve(engine, entry, queries)
    finally:
        snap = tracing.stop()
    c = snap.counters
    routes = sum(c.get(f"stage1.route.{r}", 0)
                 for r in ("device", "host", "tiered", "short"))
    assert routes == _stage1_queries(engine, queries)
    assert seen["jobs"] > 0
    assert c.get("coverage.route.device", 0) \
        + c.get("coverage.route.host", 0) == seen["jobs"]
    assert c["coverage.work_items"] == seen["items"]
    assert c.get("coverage.chunks", 0) == seen["chunks"]
    assert seen["pool_lookups"] > 0
    assert c.get("conj_memo.hit", 0) + c["conj_memo.miss"] \
        == seen["pool_lookups"]
    if entry != "search_batch":      # one batch: every text looked up once
        assert c["conj_memo.hit"] > 0
    assert c.get("evidence_memo.hit", 0) + c["evidence_memo.miss"] \
        == seen["word_lookups"]


@pytest.mark.parametrize("on", [False, True])
def test_build_phases_fit_in_the_build(on):
    eng = it.SearchEngine.create_default()
    assert eng.get_statistics().build_seconds == {}
    docs = [it.Document(i, t) for i, t in enumerate(_titles(600, seed=3))]
    if on:
        tracing.start()
    try:
        t0 = time.perf_counter()
        eng.index_documents(docs)
        wall = time.perf_counter() - t0
    finally:
        snap = tracing.stop()
    phases = eng.get_statistics().build_seconds
    assert {"inverted_lists", "word_matcher", "optimized_indexes",
            "short_query_resolver", "invalidate_caches"} <= set(phases)
    assert ("bulk_index" in phases) != ("index_documents" in phases)
    assert all(v >= 0 for v in phases.values())
    assert sum(phases.values()) <= wall
    if not on:
        assert snap.spans == []
        return
    build = {s.name: s for s in snap.spans if s.name.startswith("build.")}
    root = build.pop("build.index")
    assert {n[len("build."):] for n in build} == set(phases)
    for s in build.values():
        assert s.parent_id == root.span_id
        assert s.end - s.start >= phases[s.name[len("build."):]]
