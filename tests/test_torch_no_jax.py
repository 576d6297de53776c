"""The port never imports JAX: a fresh interpreter imports
infidex_tpu_torch, indexes a small corpus on the CPU, drives one entry
point, and JAX (and the reference package) is still absent from
``sys.modules``. One interpreter per entry point, so that each one is
checked on its own."""

import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SETUP = r"""
import sys, tempfile
import infidex_tpu_torch as it
from infidex_tpu_torch import runtime
runtime.set_device("cpu")
eng = it.SearchEngine.create_default()
eng.index_documents([it.Document(i, t) for i, t in enumerate(
    ["The Shawshank Redemption", "Redemption Day", "Shawshank Story",
     "Dark Knight Rises", "Silent River"])])
"""

CHECK = r"""
bad = sorted(m for m in sys.modules if m == "jax" or m.startswith("jax.")
             or m.startswith("jaxlib") or m == "infidex_tpu"
             or m.startswith("infidex_tpu."))
print("LOADED", bad)
sys.exit(1 if bad else 0)
"""

CASES = {
    # search_batch / search_many
    "batch": r"""
res = eng.search_batch([it.Query(q, 5) for q in
                        ("shawshenk", "redemption", "dark kni", "rivr")])
assert res[0].records[0].document_id == 0
assert eng._pipeline.device_calls > 0
""",
    # one query: the host Stage-1 route (index/mmap_serving.py)
    "search": r"""
assert eng.search(it.Query("shawshenk", 5)).records[0].document_id == 0
""",
    "search_async": r"""
res = eng.search_async(it.Query("shawshenk", 5)).result(timeout=120)
assert res.records[0].document_id == 0
""",
    # incremental append: CoverageTables.append_texts
    "append": r"""
tables = eng.vector_model.coverage_tables
eng.index_document(it.Document(10, "Quixotic Adventures"))
eng.calculate_weights()
assert eng.vector_model.coverage_tables is tables and tables.n_docs == 6
res = eng.search_batch([it.Query("quixotik", 5)])
assert res[0].records[0].document_id == 10
""",
    # large-vocabulary fuzzy matcher (ops/fuzzy.py)
    "signature": r"""
eng.vector_model.SIGNATURE_VOCAB_THRESHOLD = 0
res = eng.search_batch([it.Query(q, 5) for q in ("shawshenk", "redemptoin")])
assert eng.vector_model._sig_index is not None
assert res[0].records[0].document_id == 0
""",
    # segments: flush(materialize=False) and mmap serving
    "mmap": r"""
eng.flush(tempfile.mkdtemp() + "/seg0", materialize=False)
assert eng.search(it.Query("shawshenk", 5)).records[0].document_id == 0
res = eng.search_batch([it.Query(q, 5) for q in
                        ("shawshenk", "redemption", "dark", "river")])
assert eng.vector_model._mmap_stage1.device_stream and res[1].records
""",
}


def _run(case: str):
    env = dict(os.environ)
    env["OMP_NUM_THREADS"] = "1"   # shares the cores with other test workers
    env["PYTHONPATH"] = os.pathsep.join(
        [ROOT] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep) if p])
    res = subprocess.run([sys.executable, "-c", SETUP + CASES[case] + CHECK],
                         cwd=ROOT, env=env, capture_output=True, text=True,
                         timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr
    assert "LOADED []" in res.stdout


def test_port_serves_without_importing_jax():
    _run("batch")


@pytest.mark.parametrize("case", ["search", "search_async", "append",
                                  "signature", "mmap"])
def test_entry_point_runs_without_importing_jax(case):
    _run(case)
