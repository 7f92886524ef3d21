"""flame_tpu_torch.bench, the port's counterpart of bench.py, on the CPU.

make_params and resolve_modes against bench.py's own under the same
environment; solver_rate timing the smoother resolve_smoother picks; a
small whole run of main(device="cpu") (320x240, 1024 features, one
window of 8 frames per mode, about 25 s on one CPU thread) whose last
stdout line has bench.py's fields with the map's bounds (coverage > 0.5,
median relative error < 0.01); the module importing no jax; and main()
refusing to run without a card unless asked for the CPU.
"""

import dataclasses
import importlib.util
import json
import os
import subprocess
import sys
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from flame_tpu_torch import bench, convert  # noqa: E402
from flame_tpu_torch.optimize import nltgv2, smoother_kernel  # noqa: E402
from flame_tpu_torch.parallel import halo_kernel  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_spec = importlib.util.spec_from_file_location(
    "jax_bench", os.path.join(REPO, "bench.py"))
jax_bench = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(jax_bench)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this module's small CPU tensors: the test
    workers run side by side, and more threads only oversubscribe the
    cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


ENV_KEYS = ("BENCH_MODES", "BENCH_RESIDENT", "BENCH_BA", "BENCH_RES",
            "BENCH_FEATS", "BENCH_WINDOWS", "BENCH_WINDOWS_SECONDARY",
            "BENCH_WINLEN", "BENCH_BATCH", "BENCH_BATCH_HOST",
            "BENCH_DEGREE", "BENCH_REACH", "BENCH_MINB", "BENCH_LAG",
            "BENCH_STRIDE", "BENCH_JOINAGE", "BENCH_SHEDS", "BENCH_SMOOTHER",
            "BENCH_ITERS", "BENCH_BA_GN", "BENCH_BA_MINPF", "BENCH_VERBOSE")


@pytest.fixture
def bench_env(monkeypatch):
    """No BENCH_* variable set; returns a setter."""
    for k in ENV_KEYS:
        monkeypatch.delenv(k, raising=False)

    def set_env(env):
        for k, v in env.items():
            monkeypatch.setenv(k, v)
    return set_env


KNOBS = [
    {},
    {"BENCH_DEGREE": "16", "BENCH_REACH": "2", "BENCH_ITERS": "30"},
    {"BENCH_BATCH": "4", "BENCH_LAG": "1", "BENCH_JOINAGE": "12",
     "BENCH_SHEDS": "0", "BENCH_STRIDE": "2"},
    {"BENCH_MINB": "0.02", "BENCH_BA_GN": "5", "BENCH_BA_MINPF": "2",
     "BENCH_SMOOTHER": "pallas", "BENCH_BATCH_HOST": "2"},
]


@pytest.mark.parametrize("n_feats", [4096, 8192])
@pytest.mark.parametrize("knobs", KNOBS, ids=["defaults", "solver",
                                              "pipeline", "ba_smoother"])
@pytest.mark.parametrize("mode", bench.MODES)
def test_make_params_matches_bench_py(bench_env, mode, knobs, n_feats):
    """Each mode's Params (bench.py main's mode_params) equal bench.py's,
    carried over through convert."""
    bench_env(knobs)
    if mode == "host_upload":
        ref = jax_bench.make_params(
            False, n_feats,
            frame_batch=os.environ.get("BENCH_BATCH_HOST", 4))
    else:
        ref = jax_bench.make_params(mode == "resident_ba", n_feats)
    port = bench.mode_params(mode, n_feats)
    assert port == convert.params_from_dict(dataclasses.asdict(ref))
    assert (port.edge_capacity, port.triangle_capacity) == \
        (3 * n_feats, 2 * n_feats)


@pytest.mark.parametrize("env", [
    {},
    {"BENCH_MODES": "host_upload,resident"},
    {"BENCH_MODES": "resident, bogus"},
    {"BENCH_MODES": " , "},
    {"BENCH_BA": "1"},
    {"BENCH_RESIDENT": "0"},
    {"BENCH_BA": "1", "BENCH_RESIDENT": "0"},
], ids=["defaults", "explicit", "unknown", "empty", "ba", "host", "both"])
def test_resolve_modes_matches_bench_py(bench_env, env):
    bench_env(env)

    def outcome(fn):
        try:
            return ("modes", fn())
        except SystemExit as e:
            return ("exit", str(e))
    assert outcome(bench.resolve_modes) == outcome(jax_bench.resolve_modes)


def _ring_flame(V=256, n_edges=300):
    """A stand-in Flame for solver_rate: a GraphState of V vertices, the
    first 200 members, joined in a ring of short chords."""
    rng = np.random.default_rng(0)
    n_mem = 200
    lo = np.arange(n_edges) % n_mem
    hi = (lo + 1 + np.arange(n_edges) // n_mem) % n_mem
    edges = np.sort(np.stack([lo, hi], 1), axis=1)
    g = nltgv2.empty(V, 3 * V, 20, "cpu")
    g = dataclasses.replace(
        g, vtx_mask=torch.arange(V) < n_mem,
        x=torch.as_tensor(rng.random(V, dtype=np.float32)))
    return types.SimpleNamespace(_graph=g, _edges_np=edges,
                                 _n_edges=n_edges,
                                 device=torch.device("cpu"))


@pytest.mark.parametrize("smoother,timed", [
    ("auto", "k1"), ("vertex", "k1"), ("pallas", "k3"), ("halo", None)])
def test_solver_rate_times_the_resolved_smoother(bench_env, monkeypatch,
                                                 smoother, timed):
    """"auto" and "vertex" time K1's wrapper, "pallas" K3's on one
    partition; "halo" needs a mesh and raises. Never the other one."""
    bench_env({"BENCH_SMOOTHER": smoother})
    params = bench.make_params(False, 256)
    calls = []

    def spy(name):
        def fn(*a, **k):
            calls.append((name, [x for x in a if isinstance(x, int)]))
            return types.SimpleNamespace(x=torch.zeros(1))
        return fn
    monkeypatch.setattr(smoother_kernel, "smooth", spy("k1"))
    monkeypatch.setattr(halo_kernel, "smooth_sharded", spy("k3"))
    fl = _ring_flame()
    if timed is None:
        with pytest.raises(ValueError, match="mesh"):
            bench.solver_rate(params, fl)
        assert not calls
        return
    rate = bench.solver_rate(params, fl)
    assert rate > 0
    assert [c[0] for c in calls] == [timed, timed]  # warm-up, timed
    assert all(bench.SOLVER_ITERS in c[1] for c in calls)


FIELDS = {"metric": str, "value": float, "unit": str,
          "solver_iters_per_sec": int, "modes": dict, "windows": dict,
          "mode_fetch_ms": dict, "do_ba": bool, "coverage": float,
          "median_rel_depth_err": float, "win_fps_best": float,
          "packed_sheds": int, "device": str, "host": dict}


def test_main_cpu_small_run(bench_env, monkeypatch, capsys):
    """The whole run, with 400 solver iterations in place of 4000 (the
    rate's routing is test_solver_rate_times_the_resolved_smoother's)."""
    bench_env({"BENCH_RES": "320x240", "BENCH_FEATS": "1024",
               "BENCH_WINDOWS": "1", "BENCH_WINDOWS_SECONDARY": "1",
               "BENCH_WINLEN": "8"})
    monkeypatch.setattr(bench, "SOLVER_ITERS", 400)
    result = bench.main([], device="cpu")
    out = capsys.readouterr().out.strip().splitlines()
    line = json.loads(out[-1])
    assert line == result
    for k, typ in FIELDS.items():
        assert isinstance(line[k], typ), (k, line[k])
    assert "device_floor_ms" not in line and "vs_baseline" not in line
    for k in ("latency_ms_p50", "latency_ms_p95", "fetch_latency_ms"):
        assert isinstance(line.get(k, 0.0), float), (k, line[k])
    assert line["metric"] == "320x240_dense_fps_per_chip"
    assert line["unit"] == "frames/sec"
    assert list(line["modes"]) == list(bench.MODES)
    assert all(v > 0 for v in line["modes"].values())
    assert line["windows"] == {m: 1 for m in bench.MODES}
    assert line["value"] == line["modes"]["resident"]
    assert line["do_ba"] is False
    assert line["solver_iters_per_sec"] > 0
    assert line["coverage"] > 0.5
    assert line["median_rel_depth_err"] < 0.01
    assert line["device"] == "cpu"
    assert set(line["host"]) == {"cpu", "logical_cpus", "torch", "cuda"}


def test_main_without_a_card_raises(bench_env, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--cpu"):
        bench.main([])


def test_bench_imports_no_jax():
    code = ("import sys, flame_tpu_torch.bench; "
            "assert 'jax' not in sys.modules, 'jax imported'; "
            "assert not any(m.startswith('flame_tpu.') or m == 'flame_tpu' "
            "or m == 'bench' for m in sys.modules), 'JAX side imported'")
    env = dict(os.environ, PYTHONPATH=REPO)
    subprocess.run([sys.executable, "-c", code], check=True, cwd=REPO,
                   env=env, timeout=120)
