"""Nothing the benchmark runs loads jax, jaxlib, flax or the JAX package
flame_tpu, compared by whole top-level module name."""

import os
import subprocess
import sys

import bench_tiny

SCRIPT = r"""
import sys, time
sys.path[:0] = [{repo!r}, {bench!r}, {tests!r}]
import run
import bench_tiny
paths = bench_tiny.make({tmp!r})
from harness import cell, checks, hooks, registry, trace  # noqa: F401
for name in registry.spec()["per_layer"]:
    registry.metric_reader(name["name"])
registry.rooflines()
r = bench_tiny.run(paths, "tum_vga.sync", seconds=1.0)
assert r["attempted"] > 0
print("FORBIDDEN", run.forbidden_modules())
print("TOP", sorted({{m.split(".")[0] for m in sys.modules}}))
"""


def test_no_jax_in_a_run(tmp_path):
    tests = os.path.dirname(os.path.abspath(__file__))
    code = SCRIPT.format(repo=bench_tiny.REPO_DIR, bench=bench_tiny.BENCH_DIR,
                         tests=tests, tmp=str(tmp_path))
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600, env=env)
    assert out.returncode == 0, out.stderr[-3000:]
    lines = dict(line.split(" ", 1) for line in out.stdout.splitlines()
                 if line.startswith(("FORBIDDEN", "TOP")))
    assert lines["FORBIDDEN"] == "[]"
    top = eval(lines["TOP"])  # a list literal printed above
    assert "flame_tpu_torch" in top
    for bad in ("jax", "jaxlib", "flax", "flame_tpu"):
        assert bad not in top


def test_whole_name_comparison(monkeypatch):
    sys.path.insert(0, bench_tiny.BENCH_DIR)
    import run
    monkeypatch.setitem(sys.modules, "flame_tpu_torch_extra", sys)
    assert "flame_tpu_torch_extra" not in run.forbidden_modules()
    monkeypatch.setitem(sys.modules, "flame_tpu.core", sys)
    assert run.forbidden_modules() == ["flame_tpu.core"]
