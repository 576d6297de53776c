"""No run holds jax, jaxlib or infidex_tpu; the reference holds nothing of
the port. Each check runs in a fresh interpreter."""

import json
import os
import subprocess
import sys

from benchmark import run

REHEARSAL = """
import json, sys
sys.path.insert(0, {root!r})
sys.path.insert(0, {tests!r})
import helpers
for name in ("movies1m.batch-mixed", "movies1m.single-mixed"):
    r = helpers.cpu_run(name, trace=True)
    assert r["correct"], r
from benchmark import run
print(json.dumps(run.forbidden_modules()))
"""

REFERENCE = """
import json, sys
sys.path.insert(0, {root!r})
from benchmark.reference import answers
from benchmark.reference.stats import Corpus
ref = Corpus(["The Shawshank Redemption", "Redemption Day"])
got = answers.answer(ref, "Shawshenk", [0, 1], [1.0, 0.0], True, [])
assert got and got[0][0] == 0, got
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""


def _fresh(code: str) -> list:
    tests = os.path.dirname(os.path.abspath(__file__))
    res = subprocess.run([sys.executable, "-c",
                          code.format(root=run.ROOT, tests=tests)],
                         capture_output=True, text=True, timeout=600,
                         cwd=run.ROOT)
    assert res.returncode == 0, res.stderr[-3000:]
    return json.loads(res.stdout.strip().splitlines()[-1])


def test_rehearsal_imports_nothing_forbidden():
    assert _fresh(REHEARSAL) == []


def test_reference_imports_nothing_of_the_program():
    top = _fresh(REFERENCE)
    for name in ("infidex_tpu_torch", "infidex_tpu", "jax", "jaxlib"):
        assert name not in top


def test_forbidden_names_compare_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "infidex_tpu_torch_like", sys)
    assert "infidex_tpu_torch_like" not in run.forbidden_modules()
    monkeypatch.setitem(sys.modules, "jaxlib.fake", sys)
    assert "jaxlib.fake" in run.forbidden_modules()
