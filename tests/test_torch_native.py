"""tests/test_native.py on flame_tpu_torch: the port's own Delaunay core
(flame_tpu_torch/csrc/delaunay.cpp) built plain and with ASan/UBSan
against the JAX package's standalone invariant checker
(flame_tpu/native/delaunay_test.cpp: random points, regular grids,
collinear runs, near-duplicates and minimal inputs; winding, Euler
counts, neighbour reciprocity, index bounds). The checker declares
delaunay_triangulate itself, so only that file is read from flame_tpu/;
nothing of the JAX package is built. Each build runs to "ALL OK"."""

import os
import subprocess

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(REPO, "flame_tpu_torch", "csrc", "delaunay.cpp")
CHECKER = os.path.join(REPO, "flame_tpu", "native", "delaunay_test.cpp")


@pytest.mark.parametrize("flags,name", [
    (["-O2"], "plain"),
    (["-O1", "-g", "-fsanitize=address,undefined",
      "-fno-sanitize-recover=all"], "asan_ubsan"),
])
def test_native_invariants(tmp_path, flags, name):
    binary = os.path.join(tmp_path, f"delaunay_test_{name}")
    build = subprocess.run(
        ["g++", "-std=c++17", *flags, SOURCE, CHECKER, "-o", binary],
        capture_output=True, text=True, timeout=180)
    assert build.returncode == 0, build.stderr
    run = subprocess.run([binary], capture_output=True, text=True,
                         timeout=120)
    assert run.returncode == 0, run.stdout + run.stderr
    assert "ALL OK" in run.stdout
