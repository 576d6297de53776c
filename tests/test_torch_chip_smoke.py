"""chip_smoke.py, the port's check on a card, where there is none: run
alone (a directory that holds the script and nothing else of the
repository) it stops before it imports anything of the repository, says
why and prints no result; run from the repository's root on a machine
without CUDA it stops at the CUDA check. Either way it exits 2, and its
last line is not the result line."""

import os
import shutil
import subprocess
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(cwd):
    return subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd,
                          capture_output=True, text=True, timeout=120)


def test_alone_it_stops_and_says_why(tmp_path):
    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), tmp_path)
    res = _run(tmp_path)
    assert res.returncode == 2, res.stderr
    assert '"ok"' not in res.stdout
    assert "bench.py and infidex_tpu_torch not found" in res.stderr
    assert "Traceback" not in res.stderr


def test_without_cuda_it_stops_at_the_cuda_check():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: chip_smoke.py runs in full")
    res = _run(ROOT)
    assert res.returncode == 2, res.stderr
    assert '"ok"' not in res.stdout
    assert "CUDA is not available" in res.stderr
