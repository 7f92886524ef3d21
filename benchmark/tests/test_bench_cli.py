"""The run command fails, and prints no result, without a card."""

import os
import subprocess
import sys

import pytest
import torch

import bench_tiny


def test_fails_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    out = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", "tum_vga.sync",
         "--seed", str(2 ** 31 + 3), "--seconds", "1", "--trace", "0"],
        cwd=bench_tiny.REPO_DIR, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert "{" not in out.stdout
    assert "CUDA card" in out.stderr


def test_unknown_workload_fails():
    out = subprocess.run(
        [sys.executable, os.path.join("benchmark", "run.py"), "--workload",
         "no.such.cell", "--seed", "1", "--seconds", "1", "--trace", "0"],
        cwd=bench_tiny.REPO_DIR, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and out.stdout == ""
