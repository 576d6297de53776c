"""BENCHMARK.json against the benchmark's contract and its files.

Each rule is a function of a manifest and the checkout it lies in, so
that the same rules run on the repository's manifest and, broken one at
a time, on copies of it in a temporary directory, where they must fail.
"""

import copy
import json
import os
import re
import shutil

import pytest

from benchmark import run

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def _json(root, *parts):
    with open(os.path.join(root, *parts)) as f:
        return json.load(f)


def _module_exists(root, folder, name):
    return (NAME.match(name) is not None and "." not in name
            and os.path.exists(os.path.join(root, "benchmark", folder,
                                            f"{name}.py")))


def check_top_level_keys(manifest, root):
    assert set(manifest) == {"command", "paths", "run_seconds", "configs",
                             "workloads", "end_to_end", "per_layer"}
    assert manifest["command"] == ["python3", "benchmark/run.py"]
    assert manifest["paths"] == ["benchmark"]
    assert 1 <= manifest["run_seconds"] <= 51


def check_names_and_units(manifest, root):
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


def check_configs(manifest, root):
    """Each configuration's file: its name, the cuts it lists as the
    manifest lists them, the deployment it stands for, and a deployment
    module that exists."""
    files = set()
    for c in manifest["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("benchmark/configs/")
        assert c["file"] not in files
        files.add(c["file"])
        data = _json(root, c["file"])
        assert data["name"] == c["name"]
        assert data["reduced"] == c["reduced"]
        assert len(c["reduced"]) <= 16
        for key in c["reduced"]:
            assert isinstance(key, str) and key and NAME.match(key), key
        assert isinstance(data.get("deployment"), str) \
            and data["deployment"].strip()
        assert _module_exists(root, "deployments",
                              data.get("deployment_module", "")), data
        assert data["guarantees"]["top"] == 10
        for text in (c["source"], c["why"]):
            assert 1 <= len(text) <= 200 and "\n" not in text


def check_workloads(manifest, root):
    """Each cell: a known configuration, 1 or 4 chips (four on at most a
    quarter of the cells, rounded down, or one), a traffic file that
    names an entry and a generator that exist."""
    configs = {c["name"] for c in manifest["configs"]}
    pairs = set()
    for w in manifest["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["config"] in configs and w["chips"] in (1, 4)
        assert NAME.match(w["traffic"])
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
        assert 1 <= len(w["why"]) <= 200 and "\n" not in w["why"]
        traffic = _json(root, "benchmark", "traffic", f"{w['traffic']}.json")
        assert _module_exists(root, "entries", traffic.get("entry", ""))
        assert _module_exists(root, "generators",
                              traffic.get("generator", ""))
    four = sum(w["chips"] == 4 for w in manifest["workloads"])
    assert four <= max(1, len(manifest["workloads"]) // 4)
    assert {c["config"] for c in manifest["workloads"]} == configs


def check_metrics_moves_and_cells(manifest, root):
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
        assert os.path.exists(os.path.join(root, "benchmark", "metrics",
                                           f"{m['name']}.py"))
        if m["name"].endswith("_roofline") or "_roofline." in m["name"]:
            assert m["unit"] == "%"
    for cell in cells:
        reported = [n for n in e2e if run.applies(e2e[n], cell, manifest)]
        assert "setup_s" in reported and len(reported) >= 2
        assert any(run.applies(m, cell, manifest)
                   for m in manifest["per_layer"])


def check_layers_name_one_layer_one_way(manifest, root):
    layers = {m["layer"] for m in manifest["per_layer"]}
    for layer in layers:
        assert 1 <= len(layer) <= 200 and "\n" not in layer


RULES = [check_top_level_keys, check_names_and_units, check_configs,
         check_workloads, check_metrics_moves_and_cells,
         check_layers_name_one_layer_one_way]


@pytest.fixture(scope="module")
def manifest():
    return run.load_manifest()


def test_top_level_keys(manifest):
    check_top_level_keys(manifest, run.ROOT)
    path = os.path.join(run.ROOT, "BENCHMARK.json")
    assert os.path.getsize(path) <= 64 * 1024


def test_names_and_units(manifest):
    check_names_and_units(manifest, run.ROOT)


def test_configs(manifest):
    check_configs(manifest, run.ROOT)


def test_workloads(manifest):
    check_workloads(manifest, run.ROOT)
    for w in manifest["workloads"]:
        run.cell_of(manifest, w["name"])       # both files name a module


def test_metrics_moves_and_cells(manifest):
    check_metrics_moves_and_cells(manifest, run.ROOT)


def test_layers_name_one_layer_one_way(manifest):
    check_layers_name_one_layer_one_way(manifest, run.ROOT)


def test_every_reader_loads(manifest):
    for m in manifest["per_layer"]:
        mod = run.reader(m["name"])
        assert callable(mod.read)


# -- the rules on broken copies ------------------------------------------

def _copy(tmp_path):
    """A checkout of BENCHMARK.json and the benchmark's data and module
    folders; returns (manifest, root)."""
    shutil.copy(os.path.join(run.ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(run.HERE, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    return _json(tmp_path, "BENCHMARK.json"), str(tmp_path)


def _edit_json(root, rel, change):
    path = os.path.join(root, rel)
    data = _json(path)
    change(data)
    with open(path, "w") as f:
        json.dump(data, f)


def _config_file(m):
    return m["configs"][0]["file"]


def _traffic_file(m):
    return os.path.join("benchmark", "traffic",
                        f"{m['workloads'][0]['traffic']}.json")


def _four_chip_cells(m, n):
    for w in m["workloads"][:n]:
        w["chips"] = 4


def _more_cells(m, n):
    """``n`` cells of one chip beside the manifest's, each on a pair of
    its own (the first traffic under configurations of their own), with
    the first cell's per-layer metrics."""
    first = m["workloads"][0]["name"]
    for i in range(n):
        c = dict(m["configs"][0], name=f"copy{i}")
        m["configs"].append(c)
        m["workloads"].append(dict(m["workloads"][0], name=f"copy{i}.cell",
                                   config=c["name"], chips=1))
        for metric in m["per_layer"]:
            if first in metric["workloads"]:
                metric["workloads"].append(f"copy{i}.cell")


def _same_file_configs(m, root):
    """Each added configuration gets a file of its own, a copy of the
    first's under its name."""
    first = _json(root, _config_file(m))
    for c in m["configs"][1:]:
        rel = f"benchmark/configs/{c['name']}.json"
        c["file"] = rel
        with open(os.path.join(root, rel), "w") as f:
            json.dump(dict(first, name=c["name"]), f)


def _ok_four_chips(m, root):
    _more_cells(m, 4 - len(m["workloads"]) % 4 + 4)  # 8 cells or more
    _same_file_configs(m, root)
    _four_chip_cells(m, len(m["workloads"]) // 4)


@pytest.mark.parametrize("change", [
    lambda m, root: None,
    lambda m, root: (m["configs"][0].update(reduced=["titles"]),
                     _edit_json(root, _config_file(m),
                                lambda d: d.update(reduced=["titles"]))),
    lambda m, root: _four_chip_cells(m, 1),
    _ok_four_chips,
], ids=["as_is", "a_cut_listed_in_both", "one_four_chip_cell",
        "a_quarter_on_four_chips"])
def test_rules_take_what_the_contract_allows(tmp_path, change):
    m, root = _copy(tmp_path)
    change(m, root)
    for rule in RULES:
        rule(m, root)


def _break_config(change):
    return lambda m, root: _edit_json(root, _config_file(m), change)


def _break_traffic(change):
    return lambda m, root: _edit_json(root, _traffic_file(m), change)


BROKEN = {
    "cut_in_manifest_only":
        lambda m, root: m["configs"][0].update(reduced=["titles"]),
    "cut_in_file_only":
        _break_config(lambda d: d.update(reduced=["titles"])),
    "empty_cut_name": lambda m, root: (
        m["configs"][0].update(reduced=[""]),
        _edit_json(root, _config_file(m),
                   lambda d: d.update(reduced=[""]))),
    "no_deployment_text": _break_config(lambda d: d.pop("deployment")),
    "no_deployment_module": _break_config(
        lambda d: d.pop("deployment_module")),
    "deployment_module_missing": _break_config(
        lambda d: d.update(deployment_module="nowhere")),
    "two_chips": lambda m, root: m["workloads"][0].update(chips=2),
    "two_four_chip_cells_of_three": lambda m, root: _four_chip_cells(m, 2),
    "a_fourth_and_one_more_on_four_chips": lambda m, root: (
        _ok_four_chips(m, root),
        _four_chip_cells(m, len(m["workloads"]) // 4 + 1)),
    "no_generator": _break_traffic(lambda d: d.pop("generator")),
    "generator_missing": _break_traffic(
        lambda d: d.update(generator="nowhere")),
    "entry_missing": _break_traffic(lambda d: d.update(entry="nowhere")),
}


@pytest.mark.parametrize("name", sorted(BROKEN))
def test_a_broken_copy_fails_a_rule(tmp_path, name):
    m, root = _copy(tmp_path)
    BROKEN[name](m, root)
    failed = []
    for rule in RULES:
        try:
            rule(copy.deepcopy(m), root)
        except (AssertionError, KeyError, FileNotFoundError) as exc:
            failed.append((rule.__name__, exc))
    assert failed, f"{name}: every rule passed"


@pytest.mark.parametrize("kind, key", [("configs", "deployment_module"),
                                       ("traffic", "generator")])
def test_a_file_without_its_module_key_stops_the_run(monkeypatch, kind,
                                                     key):
    data = run._data

    def without(k, name):
        d = data(k, name)
        if k == kind:
            d.pop(key)
        return d

    monkeypatch.setattr(run, "_data", without)
    with pytest.raises(SystemExit, match=key):
        run.cell_of(run.load_manifest(), "movies1m.batch-mixed")
