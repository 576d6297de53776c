"""BENCHMARK.json against the benchmark's contract and its files."""

import json
import os
import re

import pytest

from benchmark import run

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


@pytest.fixture(scope="module")
def manifest():
    return run.load_manifest()


def test_top_level_keys(manifest):
    assert set(manifest) == {"command", "paths", "run_seconds", "configs",
                             "workloads", "end_to_end", "per_layer"}
    assert manifest["command"] == ["python3", "benchmark/run.py"]
    assert manifest["paths"] == ["benchmark"]
    assert 1 <= manifest["run_seconds"] <= 51
    path = os.path.join(run.ROOT, "BENCHMARK.json")
    assert os.path.getsize(path) <= 64 * 1024


def test_names_and_units(manifest):
    names = []
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for entry in manifest[group]:
            assert NAME.match(entry["name"]), entry["name"]
            names.append((group in ("end_to_end", "per_layer"),
                          entry["name"]))
            if "unit" in entry:
                assert UNIT.match(entry["unit"]), entry["unit"]
                assert entry["better"] in ("lower", "higher")
                assert entry["source"] in SOURCES
    metric_names = [n for is_metric, n in names if is_metric]
    assert len(metric_names) == len(set(metric_names))
    for group in ("configs", "workloads"):
        got = [e["name"] for e in manifest[group]]
        assert len(got) == len(set(got))


def test_configs(manifest):
    files = set()
    for c in manifest["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("benchmark/configs/")
        assert c["file"] not in files
        files.add(c["file"])
        with open(os.path.join(run.ROOT, c["file"])) as f:
            data = json.load(f)
        assert data["name"] == c["name"]
        assert data["reduced"] == c["reduced"] == []
        assert data["guarantees"]["top"] == 10
        for text in (c["source"], c["why"]):
            assert 1 <= len(text) <= 200 and "\n" not in text


def test_workloads(manifest):
    configs = {c["name"] for c in manifest["configs"]}
    pairs = set()
    for w in manifest["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["config"] in configs and w["chips"] == 1
        assert NAME.match(w["traffic"])
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
        assert 1 <= len(w["why"]) <= 200
        cell = run.cell_of(manifest, w["name"])
        entry = cell["traffic_data"]["entry"]
        assert os.path.exists(os.path.join(run.HERE, "entries",
                                           f"{entry}.py"))
    assert {c["config"] for c in manifest["workloads"]} == configs


def test_metrics_moves_and_cells(manifest):
    cells = {w["name"] for w in manifest["workloads"]}
    e2e = {m["name"]: m for m in manifest["end_to_end"]}
    assert "setup_s" in e2e and "workloads" not in e2e["setup_s"]
    for m in manifest["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
    for m in manifest["per_layer"]:
        assert set(m) == {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["moves"] in e2e
        assert set(m["workloads"]) <= cells
        for cell in m["workloads"]:
            assert run.applies(e2e[m["moves"]], cell, manifest)
        assert os.path.exists(os.path.join(run.HERE, "metrics",
                                           f"{m['name']}.py"))
        if m["name"].endswith("_roofline") or "_roofline." in m["name"]:
            assert m["unit"] == "%"
    for cell in cells:
        reported = [n for n in e2e if run.applies(e2e[n], cell, manifest)]
        assert "setup_s" in reported and len(reported) >= 2
        assert any(run.applies(m, cell, manifest)
                   for m in manifest["per_layer"])


def test_layers_name_one_layer_one_way(manifest):
    layers = {m["layer"] for m in manifest["per_layer"]}
    for layer in layers:
        assert 1 <= len(layer) <= 200 and "\n" not in layer


def test_every_reader_loads(manifest):
    for m in manifest["per_layer"]:
        mod = run.reader(m["name"])
        assert callable(mod.read)
