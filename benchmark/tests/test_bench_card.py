"""One short run of each cell on the card (skips without one)."""

import json
import subprocess
import sys

import pytest
import torch

import bench_tiny
from harness import registry

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.parametrize("cell", [w["name"] for w in
                                  registry.spec()["workloads"]])
def test_cell_runs_on_the_card(card, cell):
    out = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", cell, "--seed",
         str(2 ** 31 + 17), "--seconds", "3", "--trace", "0"],
        cwd=bench_tiny.REPO_DIR, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"], line["checks"]
    assert list(line)[-1] == "checks"
    assert line["device"]["platform"] == "gpu"
    assert set(line["metrics"]) == {m["name"] for m in registry.cell_metrics(
        registry.spec(), cell, "end_to_end")}
