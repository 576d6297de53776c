"""The readers of the program's own spans and counters
(``benchmark/program_trace.py``): each on a made-up record, each giving
nothing where the program recorded nothing, and a shrunk traced CPU run
of each cell in which every one reads a number and the program's dotted
spans reach the record."""

import sys
from types import SimpleNamespace

import pytest

from benchmark import program_trace, run
from benchmark.record import Record
from infidex_tpu_torch.tracing import Snapshot, SpanRecord

NEW = {"movies1m.batch-mixed": ["coverage_begin_ms.batch",
                                "prefetch_wait_ms.batch",
                                "conj_memo_hit_share.batch",
                                "index_build_s"],
       "movies1m.single-mixed": ["host_stage1_ms.single",
                                 "coverage_begin_ms.single",
                                 "coverage_host_ms.single",
                                 "index_build_s"]}


def made_up():
    rec = Record()
    rec.window = (10.0, 12.0)
    rec.batches = 2
    rec.searches = 4
    main, worker = rec.main_thread, rec.main_thread + 1

    def span(name, rid, t0, t1, thread=main):
        return SpanRecord(name, 0, None, rid, thread, t0, t1)

    spans = [
        span("pipeline.coverage_begin", 1, 10.1, 10.3),
        span("pipeline.coverage_begin", 2, 10.5, 10.6),
        span("pipeline.coverage_begin", 3, 10.7, 10.8, worker),  # not main
        span("pipeline.coverage_begin", 4, 11.9, 12.5),     # past the window
        span("pipeline.wm_wait", 1, 10.1, 10.15),
        span("pipeline.conj_wait", 1, 10.2, 10.25),
        span("pipeline.tier_wait", 2, 10.4, 10.5),
        span("pipeline.host_oracle", 1, 11.0, 11.2),
        span("vector_model.stage1_host", 1, 11.3, 11.4),
        span("vector_model.stage1_host", 1, 11.4, 11.5),
        span("vector_model.stage1_host", 2, 11.6, 11.7),
    ]
    counters = {"conj_memo.hit": 3, "conj_memo.miss": 1}
    setattr(rec, program_trace.KEY, SimpleNamespace(
        tracing=None, snap=Snapshot(spans, counters),
        build={"bulk_index": 1.5, "inverted_lists": 0.5}))
    return rec


@pytest.mark.parametrize("name, want", [
    ("coverage_begin_ms.batch", (0.2 + 0.1) * 1e3 / 2),
    ("prefetch_wait_ms.batch", (0.05 + 0.05 + 0.1) * 1e3 / 2),
    ("conj_memo_hit_share.batch", 75.0),
    ("host_stage1_ms.single", 0.3 * 1e3 / 2),
    ("coverage_begin_ms.single", (0.2 + 0.1 + 0.1) * 1e3 / 4),
    ("coverage_host_ms.single", 0.2 * 1e3 / 4),
    ("index_build_s", 2.0),
])
def test_reader_values(name, want):
    assert run.reader(name).read(made_up()) == pytest.approx(want)


ALL = sorted({n for names in NEW.values() for n in names})


@pytest.mark.parametrize("name", ALL)
def test_nothing_to_read_gives_nothing(name):
    assert run.reader(name).read(Record()) is None


@pytest.mark.parametrize("name", ALL)
def test_no_spans_no_counters_no_build_give_nothing(name):
    rec = made_up()
    getattr(rec, program_trace.KEY).snap = Snapshot([], {})
    getattr(rec, program_trace.KEY).build = None
    assert run.reader(name).read(rec) is None


@pytest.mark.parametrize("name", ALL)
def test_a_program_without_the_tracer_gives_nothing(name, monkeypatch):
    """The parent of the change that added the tracer: no module, no
    ``build_seconds``; install and read neither raise nor read."""
    import infidex_tpu_torch

    monkeypatch.delattr(infidex_tpu_torch, "tracing")
    monkeypatch.setitem(sys.modules, "infidex_tpu_torch.tracing", None)
    eng = SimpleNamespace(get_statistics=lambda: SimpleNamespace(
        document_count=3, vocabulary_size=5))
    rec = Record()
    rec.window, rec.batches, rec.searches = (0.0, 1.0), 2, 2
    mod = run.reader(name)
    mod.install(SimpleNamespace(eng=eng), rec)
    assert mod.read(rec) is None
    assert rec.spans == []


def test_install_starts_the_tracer_once_and_the_first_read_stops_it():
    from infidex_tpu_torch import tracing

    eng = SimpleNamespace(get_statistics=lambda: SimpleNamespace(
        build_seconds={"bulk_index": 1.0}))
    rec = Record()
    ctx = SimpleNamespace(eng=eng)
    try:
        program_trace.install(ctx, rec)
        with tracing.span("a.first"):
            pass
        program_trace.install(ctx, rec)      # a second reader: no restart
        with tracing.span("a.second"):
            pass
        st = program_trace.state(rec)
        assert not tracing.enabled()
        assert [s.name for s in st.snap.spans] == ["a.first", "a.second"]
        assert [s[0] for s in rec.spans] == ["a.first", "a.second"]
        assert program_trace.state(rec) is st and len(rec.spans) == 2
    finally:
        tracing.stop()


@pytest.mark.parametrize("cell", sorted(NEW))
def test_traced_cpu_run_reads_every_new_metric(cell, monkeypatch):
    import helpers

    made = []

    class Kept(Record):
        def __init__(self):
            super().__init__()
            made.append(self)

    monkeypatch.setattr(run, "Record", Kept)
    res = helpers.cpu_run(cell, trace=True)
    assert res["correct"], res
    for name in NEW[cell]:
        assert res["metrics"][name]["value"] is not None, name
        assert res["metrics"][name]["value"] >= 0, name
    rec, = made
    dotted = {s[0] for s in rec.spans if "." in s[0]}
    root = "engine.search_many" if "batch" in cell else "engine.search"
    assert {root, "pipeline.coverage_begin"} <= dotted
    # the window's gap (no kernels on the CPU) is named by a program span
    assert "." in res["breakdown"]["idle_gaps"][0][0].split(" | ")[0]
