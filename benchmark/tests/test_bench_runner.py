"""The runner's refusals: off the GPU it exits with an error and prints no
result, and in a directory that holds only ``BENCHMARK.json`` and the
benchmark it exits with an error too."""

import os
import shutil
import subprocess
import sys

import pytest

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CHECKOUT = os.path.dirname(BENCH)


def run_runner(cwd, env=None):
    return subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload",
         "nyu14-bf16-batch1024", "--seed", "3000000001", "--seconds", "1",
         "--trace", "0"], cwd=cwd, capture_output=True, text=True,
        timeout=300, env=dict(os.environ, **(env or {})))


def test_no_gpu_no_result():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the refusal is not reached")
    proc = run_runner(CHECKOUT)
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""


def test_benchmark_alone_fails(tmp_path):
    shutil.copy(os.path.join(CHECKOUT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(BENCH, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns(".cache", "__pycache__"))
    proc = run_runner(str(tmp_path), env={"CUDA_VISIBLE_DEVICES": ""})
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""
    # past the look for a GPU, the run needs the program itself
    proc = subprocess.run(
        [sys.executable, "-c",
         "import sys; sys.path.insert(0, 'benchmark'); import run; "
         "run.run_cell('nyu14-bf16-batch1024', 1, 1, False, device='cpu')"],
        cwd=str(tmp_path), capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0
    assert "densereg_torch" in proc.stderr
