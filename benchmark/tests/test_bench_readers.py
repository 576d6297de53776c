"""The per-layer readers and the trace reduction, on a made-up record."""

import pytest

from benchmark import devtrace, run
from benchmark.record import Record


def made_up():
    rec = Record()
    rec.window = (10.0, 12.0)
    rec.batches = 4
    rec.kernels = [
        ("stage1_epilogue_kernel", 10.1, 10.3),
        ("coverage_fusion_kernel<12, 8>", 10.2, 10.4),   # overlaps
        ("fuzzy_pass_mask_kernel", 11.0, 11.1),
        ("fuzzy_place_kernel", 11.1, 11.2),
        ("stage1_topk_kernel", 11.9, 12.5),              # past the window
    ]
    rec.spans = [("search_many", rec.main_thread, 10.0, 12.0),
                 ("coverage_begin", rec.main_thread, 10.5, 10.9),
                 ("tier_batch", rec.main_thread + 1, 10.4, 10.8)]
    rec.calls["stage1_epilogue_kernel"] = [3.35e12 * 0.1]
    rec.calls["fuzzy_match"] = [3.35e12 * 0.05]
    rec.counters = {"device_wait_s": 0.2}
    rec.window_metrics = {"qps": 256.0, "search_p50_ms": 30.0,
                          "search_p95_ms": 90.0}
    return rec


def test_busy_is_the_union_inside_the_window():
    assert made_up().busy_s() == pytest.approx(0.3 + 0.2 + 0.1)


@pytest.mark.parametrize("name, want", [
    ("device_idle_share.batch", 100 * (1 - 0.6 / 2.0)),
    ("stage1_device_ms.batch", (0.2 + 0.6) * 1e3 / 4),
    ("coverage_device_ms.batch", 0.2 * 1e3 / 4),
    ("stage1_pass_roofline.batch", 50.0),
    ("device_wait_ms.batch", 50.0),
    ("candidates_ms.batch", (0.4 + 0.4) * 1e3 / 4),
    ("qps.batch", 256.0),
    ("search_p50_ms.single", 30.0),
    ("search_p95_ms.single", 90.0),
])
def test_reader_values(name, want):
    assert run.reader(name).read(made_up()) == pytest.approx(want)


@pytest.mark.parametrize("name", ["device_idle_share.batch",
                                  "stage1_pass_roofline.batch",
                                  "stage1_device_ms.batch",
                                  "host_stage1_share.single",
                                  "coverage_device_ms.batch",
                                  "qps.batch", "search_p50_ms.single",
                                  "search_p95_ms.single"])
def test_nothing_to_read_gives_nothing(name):
    assert run.reader(name).read(Record()) is None


def test_roofline_counts_only_kept_records():
    rec = made_up()
    rec.calls["stage1_epilogue_kernel"] *= 2      # two calls, one record
    assert run.reader("stage1_pass_roofline.batch").read(rec) == \
        pytest.approx(50.0)


def test_breakdown_names_gaps_by_host_spans():
    b = devtrace.breakdown(made_up())
    assert b["device_ops"][0] == ["stage1_epilogue_kernel", pytest.approx(0.2)]
    assert ["stage1_topk_kernel", pytest.approx(0.1)] in b["device_ops"]
    assert b["idle_gaps"][:2] == [
        ["search_many", pytest.approx(0.7)],                       # 11.2-11.9
        ["coverage_begin | threads: tier_batch", pytest.approx(0.6)]]
    assert devtrace.kernel_name(
        "void stage1_topk_kernel(topk::Args)") == "stage1_topk_kernel"
