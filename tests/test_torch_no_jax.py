"""The port never imports JAX: a fresh interpreter imports
infidex_tpu_torch, indexes a small corpus on the CPU, drives one entry
point, and JAX (and the reference package) is still absent from
``sys.modules``. Every loaded module of the port comes from a file under
``infidex_tpu_torch/``, no loaded module and no native library comes
from ``infidex_tpu/`` (the port keeps its own copies of the host
modules). One interpreter per entry point, so that each one is checked on
its own."""

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
import os
from infidex_tpu_torch import native
root = os.path.dirname(os.path.dirname(os.path.abspath(it.__file__)))
port_dir = os.path.join(root, "infidex_tpu_torch") + os.sep
ref_dir = os.path.join(root, "infidex_tpu") + os.sep
bad = sorted(m for m in sys.modules if m == "jax" or m.startswith("jax.")
             or m.startswith("jaxlib") or m == "infidex_tpu"
             or m.startswith("infidex_tpu."))
files = {m: os.path.abspath(getattr(mod, "__file__", None) or "")
         for m, mod in list(sys.modules.items())}
bad += sorted(m for m, f in files.items()
              if f.startswith(ref_dir)
              or (m.startswith("infidex_tpu_torch")
                  and not f.startswith(port_dir)))
libs = [os.path.abspath(native._SO)]
with open("/proc/self/maps") as maps:
    libs += [line.split()[-1] for line in maps if ".so" in line]
bad += sorted({f for f in libs if f.startswith(ref_dir)})
assert native.available and libs[0].startswith(port_dir), libs[0]
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
    # batched facets on the device counter (ops/facets.py)
    "facets": r"""
import os
os.environ["INFIDEX_TPU_DEVICE_FACETS"] = "1"
from infidex_tpu_torch.ops import facets
calls = []
orig = facets.DeviceFacetCounter.counts
facets.DeviceFacetCounter.counts = (
    lambda self, *a: calls.append(1) or orig(self, *a))
docs = []
for i, (title, genre) in enumerate([("The Shawshank Redemption", "Drama"),
                                    ("Redemption Day", "Action"),
                                    ("Shawshank Story", "Drama")]):
    f = it.DocumentFields()
    f.add_field("title", title, it.Weight.HIGH)
    f.add_field("genre", genre, indexable=False, facetable=True)
    docs.append(it.Document(i, f))
feng = it.SearchEngine.create_default()
feng.index_documents(docs)
qs = [it.Query("shawshank", 5), it.Query("redemption", 5)]
for q in qs:
    q.enable_facets = True
res = feng.search_batch(qs)
assert calls, "the device facet counter was not used"
assert dict(res[0].facets["genre"]) == {"Drama": 2}, res[0].facets
assert dict(res[1].facets["genre"]) == {"Drama": 1, "Action": 1}
""",
    # sharded serving over a mesh of 4 CPU shards (parallel/sharding.py)
    "sharded": r"""
eng.enable_sharded_serving(n_devices=4)
assert len(eng.vector_model.sharded.mesh) == 4
assert eng.search(it.Query("shawshenk", 5)).records[0].document_id == 0
res = eng.search_batch([it.Query(q, 5) for q in ("shawshenk", "dark kni")])
assert res[0].records[0].document_id == 0 and res[1].records
""",
    # device pool scoring (ops/pool_score.py) on the tier path
    "pool": r"""
from infidex_tpu_torch.index import candidates
from infidex_tpu_torch.ops import pool_score
import random
rng = random.Random(7)
words = ["alpha", "bravo", "charlie", "delta", "echo", "foxtrot", "golf"]
peng = it.SearchEngine.create_default()
peng.index_documents([it.Document(i, " ".join(rng.choices(words, k=4)))
                      for i in range(400)])
candidates.TIER_LANE_BUDGET = 1
peng.vector_model.POOL_DEVICE = "1"
calls = []
orig = pool_score.pool_score_plain
pool_score.pool_score_plain = lambda *a: calls.append(1) or orig(*a)
res = peng.search_batch([it.Query(q, 5) for q in
                         ("alpha bravo", "charlie delta echo")])
assert calls, "the device pool scorer was not used"
assert res[0].records and res[1].records
""",
    # the single-query device Stage 1 (index/device.py DeviceIndex.search)
    # with a typo token's extra postings
    "device_search": r"""
import numpy as np
m = eng.vector_model
t, i, groups = m.prepare_stage1("shawshenk redemption")
extra = np.concatenate([m.built.postings_for(int(x))[0] for g in groups
                        for x in g] + [np.asarray([0, 2, 0], np.int32)])
scores, ids = m.device.search(t, i, 5, extra.astype(np.int32),
                              np.ones(extra.size, np.float32))
assert ids[0] == 0 and scores[0] > 0, (scores, ids)
""",
    # the single-query sharded Stage 1 (parallel/sharding.py)
    "sharded_search": r"""
from infidex_tpu_torch.parallel.sharding import ShardedDeviceIndex, make_mesh
m = eng.vector_model
t, i, _ = m.prepare_stage1("shawshank redemption")
got = ShardedDeviceIndex(m.built, make_mesh(n_devices=4)).search(t, i, 5)
want = m.device.search(t, i, 5)
assert (got[1] == want[1]).all() and (got[0] == want[0]).all()
assert got[1][0] == 0
""",
    # the single-token edit distances (ops/editdistance.py)
    "editdistance": r"""
import numpy as np
from infidex_tpu_torch.ops.editdistance import (batched_damerau,
                                                 batched_levenshtein)
q = np.zeros(8, np.int32)
q[:4] = [ord(c) for c in "abcd"]
d = np.zeros((1, 2, 8), np.int32)
d[0, 0, :4] = [ord(c) for c in "abdc"]
d[0, 1, :3] = [ord(c) for c in "abc"]
lens = np.asarray([[4, 3]], np.int32)
assert batched_levenshtein(q, 4, d, lens, budget=2, l_max=8).tolist() == [[2, 1]]
assert batched_damerau(q, 4, d, lens, max_distance=1, l_max=8).tolist() == [[1, 1]]
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
                                  "signature", "mmap", "facets", "sharded",
                                  "pool", "device_search", "sharded_search",
                                  "editdistance"])
def test_entry_point_runs_without_importing_jax(case):
    _run(case)
