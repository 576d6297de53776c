"""The port never imports JAX: a fresh interpreter imports
infidex_tpu_torch, indexes a small corpus on the CPU, serves a batch, and
JAX is still absent from ``sys.modules``."""

import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SCRIPT = r"""
import sys
import infidex_tpu_torch as it
from infidex_tpu_torch import runtime
runtime.set_device("cpu")
eng = it.SearchEngine.create_default()
eng.index_documents([it.Document(i, t) for i, t in enumerate(
    ["The Shawshank Redemption", "Redemption Day", "Shawshank Story",
     "Dark Knight Rises", "Silent River"])])
res = eng.search_batch([it.Query(q, 5) for q in
                        ("shawshenk", "redemption", "dark kni", "rivr")])
assert res[0].records[0].document_id == 0
assert eng._pipeline.device_calls > 0
bad = sorted(m for m in sys.modules if m == "jax" or m.startswith("jax.")
             or m.startswith("jaxlib") or m == "infidex_tpu"
             or m.startswith("infidex_tpu."))
print("LOADED", bad)
sys.exit(1 if bad else 0)
"""


def test_port_serves_without_importing_jax():
    env = dict(os.environ)
    env["OMP_NUM_THREADS"] = "1"   # shares the cores with other test workers
    env["PYTHONPATH"] = os.pathsep.join(
        [ROOT] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep) if p])
    res = subprocess.run([sys.executable, "-c", SCRIPT], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr
    assert "LOADED []" in res.stdout
