"""The measured path needs a CUDA card and the program; it never falls
back to the CPU and prints no result without them."""

import os
import shutil
import subprocess
import sys

import pytest

from benchmark import run

ARGS = ["--workload", "movies1m.batch-mixed", "--seed", "3",
        "--seconds", "1", "--trace", "0"]


def _run(cwd):
    return subprocess.run([sys.executable, "benchmark/run.py"] + ARGS,
                          capture_output=True, text=True, timeout=600,
                          cwd=cwd)


def _bare_checkout(tmp_path):
    """A directory with only BENCHMARK.json and the benchmark's files."""
    shutil.copy(os.path.join(run.ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(run.HERE, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", "*.so"))
    return tmp_path


def test_no_card_no_result():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    res = _run(run.ROOT)
    assert res.returncode != 0
    assert res.stdout.strip() == ""
    assert "CUDA" in res.stderr


def test_run_cell_refuses_cuda_without_a_card():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        run.run_cell(run.load_manifest(), "movies1m.batch-mixed", 3, 1.0,
                     False, device="cuda")


def test_bare_directory_no_result(tmp_path):
    res = _run(_bare_checkout(tmp_path))
    assert res.returncode != 0
    assert res.stdout.strip() == ""


@pytest.mark.gpu
def test_bare_directory_no_result_on_the_card(tmp_path):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    res = _run(_bare_checkout(tmp_path))
    assert res.returncode != 0
    assert res.stdout.strip() == ""
    assert "infidex_tpu_torch" in res.stderr
