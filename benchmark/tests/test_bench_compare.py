"""Compared numbers as plug-in files (compare/<name>.py): a plug-in
added to a copy of the benchmark, and named in a cell's limits, is
installed on its points (a method among them), computed, held to its
limit and read with its control by limits.py; a fault under its hook
fails it; what it keeps after the last sampled read reaches it; a cell
that names none of its numbers installs only the built-in points; a
name taken twice raises. The feed's poses equal the loop they replace."""

import json
import math
import os
import shutil

import numpy as np
import pytest

import bench_tiny
from flame_tpu_torch.ba import window
from flame_tpu_torch.core import flame
from harness import cell, checks, hooks, registry
from scenes import box_room

TESTS_DIR = os.path.dirname(os.path.abspath(__file__))
PLUGINS = {"ba_probe": "plugin_ba_probe.py",
           "map_reads": "plugin_map_reads.py"}
BUILTIN = {hooks.SMOOTH, hooks.RASTER, hooks.RASTER_BATCH, hooks.TRACK,
           hooks.POST, hooks.DELAUNAY}
LIMITS = {"ba_qnorm_gap": 1e-4, "reads_since_arm": 1e9}


def _write(path, obj):
    with open(path, "w") as f:
        json.dump(obj, f)


def _add_plugins(bench_dir):
    os.makedirs(os.path.join(bench_dir, "compare"), exist_ok=True)
    for name, src in PLUGINS.items():
        shutil.copy(os.path.join(TESTS_DIR, src),
                    os.path.join(bench_dir, "compare", name + ".py"))


@pytest.fixture(scope="module")
def paths(tmp_path_factory):
    """A tiny copy with the two probes in compare/ and a cell tiny.ba:
    the synchronous tiny cell with BA on noisy poses, whose limits also
    name the probes' numbers. Nothing else of the copy is edited. Every
    frame is a poseframe, so a solve is staged at each update and
    applied at the next: a sampled read sees one land however few
    reads the CPU's window holds."""
    paths = bench_tiny.make(str(tmp_path_factory.mktemp("bench")))
    bench = paths["bench_dir"]
    _add_plugins(bench)
    tr = registry.traffic("tiny_sync_closed_loop", bench)
    tr["name"] = "tiny_ba"
    tr["posture"]["do_ba"] = True
    tr["pose_noise"] = {"t_m": 0.015, "deg": 0.3}
    tr["poseframe_every"] = 1
    _write(os.path.join(bench, "traffic", "tiny_ba.json"), tr)
    wl = registry.workload("tiny.tum_vga.sync", bench)
    wl["name"] = "tiny.ba"
    wl["limits"].update(LIMITS)
    _write(os.path.join(bench, "workloads", "tiny.ba.json"), wl)
    sp = registry.spec(paths["spec_path"])
    sp["workloads"].append(dict(name="tiny.ba", config="tiny_tum_fr1_vga",
                                traffic="tiny_ba", chips=1, why="w"))
    _write(paths["spec_path"], sp)
    return paths


def _spied_run(paths, mp, seconds=3.0):
    """Routes cell.run to the copy on the CPU, and records each run's
    result and the points each Hooks.install wrapped, with whether
    BundleAdjuster._apply was replaced at that moment."""
    seen = dict(results=[], installs=[])
    run, install = cell.run, hooks.Hooks.install
    held = vars(window.BundleAdjuster)["_apply"]

    def spy_run(workload, seed, _seconds, traced, t_start, **kw):
        r = run(workload, seed, seconds, traced, t_start, device="cpu",
                **paths, **kw)
        seen["results"].append(r)
        return r

    def spy_install(self):
        install(self)
        seen["installs"].append(dict(
            points=set(self._listeners),
            apply_wrapped=vars(window.BundleAdjuster)["_apply"] is not held))
    mp.setattr(cell, "run", spy_run)
    mp.setattr(hooks.Hooks, "install", spy_install)
    return seen


@pytest.fixture(scope="module")
def ba_run(paths, tmp_path_factory):
    """tiny.ba through limits.py (the control on), as on the card."""
    import limits
    out = str(tmp_path_factory.mktemp("limits") / "limits.jsonl")
    held = {"apply": vars(window.BundleAdjuster)["_apply"],
            "read": vars(flame.Flame)["get_inverse_depth_map"]}
    with pytest.MonkeyPatch.context() as mp:
        seen = _spied_run(paths, mp)
        assert limits.main(["--workload", "tiny.ba", "--seeds",
                            str(2 ** 31 + 11), "--out", out]) == 0
    with open(out) as f:
        seen["line"] = json.loads(f.read().splitlines()[-1])
    seen["held"] = held
    return seen


def test_plugin_number_is_checked_with_its_control(ba_run):
    r = ba_run["results"][0]
    assert r["correct"], r["checks"]
    c = r["checks"]["ba_qnorm_gap"]
    assert c["limit"] == LIMITS["ba_qnorm_gap"]
    assert c["value"] is not None and c["value"] <= c["limit"]
    values = ba_run["line"]["values"]  # what limits.py prints
    assert values["ba_qnorm_gap"] == c["value"]
    assert values["ba_qnorm_gap.control"] > c["limit"]


def test_method_hooks_installed_called_restored(ba_run):
    (inst,) = ba_run["installs"]
    assert inst["points"] == BUILTIN | {
        ("flame_tpu_torch.ba.window", "BundleAdjuster._apply"),
        ("flame_tpu_torch.core.flame", "Flame.get_inverse_depth_map")}
    assert inst["apply_wrapped"]
    held = ba_run["held"]
    assert vars(window.BundleAdjuster)["_apply"] is held["apply"]
    assert vars(flame.Flame)["get_inverse_depth_map"] is held["read"]


def test_capture_after_last_sampled_read_is_kept(ba_run):
    # The latest sampled read's own map read, then at least the drain's.
    r = ba_run["results"][0]
    assert r["checks"]["reads_since_arm"]["value"] >= 2


def test_fault_under_the_hook_is_not_correct(paths, monkeypatch):
    """The solve's quaternions scaled where the result is produced."""
    orig = window._flat_result
    monkeypatch.setattr(window, "_flat_result",
                        lambda q, t, lm, cost: orig(1.01 * q, t, lm, cost))
    _spied_run(paths, monkeypatch)
    r = cell.run("tiny.ba", 2 ** 31 + 13, 0, False, 0.0)
    assert not r["correct"]
    c = r["checks"]["ba_qnorm_gap"]
    assert c["value"] is not None and c["value"] > c["limit"], c


def test_cell_without_plugin_numbers_installs_builtin_points(paths,
                                                             monkeypatch):
    seen = _spied_run(paths, monkeypatch, seconds=1.0)
    r = cell.run("tiny.tum_vga.sync", 2 ** 31 + 17, 0, False, 0.0)
    (inst,) = seen["installs"]
    assert inst["points"] == BUILTIN and not inst["apply_wrapped"]
    limits = registry.workload("tiny.tum_vga.sync",
                               paths["bench_dir"])["limits"]
    assert set(r["checks"]) == set(limits)
    assert set(r["_extra"]["values"]) <= set(checks.NUMBERS)


class _Base:
    def ping(self, x):
        return x + 1


class _Child(_Base):
    pass


class _Count:
    def __init__(self):
        self.calls = []

    def before(self, point, args, kwargs):
        return args[1]

    def after(self, point, token, out):
        self.calls.append((point[1], token, out))


def test_dotted_point_restores_the_held_object():
    held = vars(_Base)["ping"]
    base, child = _Count(), _Count()
    hk = hooks.Hooks()
    hk.listen((__name__, "_Base.ping"), base)
    hk.listen((__name__, "_Child.ping"), child)  # inherited, not held
    hk.install()
    assert vars(_Base)["ping"] is not held and "ping" in vars(_Child)
    assert _Child().ping(4) == 5 and _Base().ping(1) == 2
    hk.uninstall()
    assert vars(_Base)["ping"] is held and "ping" not in vars(_Child)
    assert child.calls == [("_Child.ping", 4, 5)]
    assert base.calls == [("_Base.ping", 4, 5), ("_Base.ping", 1, 2)]


@pytest.mark.parametrize("clash", ["map_gap", "reads_since_arm",
                                   "x.control"])
def test_taken_number_raises(tmp_path, clash):
    paths = bench_tiny.make(str(tmp_path))
    _add_plugins(paths["bench_dir"])
    with open(os.path.join(paths["bench_dir"], "compare", "clash.py"),
              "w") as f:
        f.write(f"NUMBERS = ({clash!r},)\n")
    with pytest.raises(ValueError, match="clash.py"):
        registry.compare_plugins(paths["bench_dir"], checks.NUMBERS)
    with pytest.raises(ValueError, match="clash.py"):
        cell.run("tiny.tum_vga.sync", 1, 1.0, False, 0.0, device="cpu",
                 **paths)


def _old_noisy_poses(cfg, n, sigma_t, sigma_deg, seed, start=0):
    """The feed's loop before it indexed the period's true poses."""
    rng = np.random.default_rng([seed, 1])
    out = []
    for i in range(start, start + n):
        q, t = box_room.true_pose(cfg, i)
        if sigma_t or sigma_deg:
            t = t + rng.normal(0.0, sigma_t, 3)
            ang = math.radians(sigma_deg) * rng.normal()
            ax = rng.normal(size=3)
            ax /= np.linalg.norm(ax)
            q = box_room._quat_mul(q, np.array([math.cos(ang / 2),
                                                *(math.sin(ang / 2) * ax)]))
        out.append((q, t))
    return out


@pytest.mark.parametrize("noise", [(0.0, 0.0), (0.015, 0.3)])
def test_feed_poses_equal_the_old_loop(noise):
    with open(os.path.join(bench_tiny.BENCH_DIR, "configs",
                           "tum_fr1_vga.json")) as f:
        cfg = json.load(f)
    P = box_room.period_frames(cfg)
    seed = 2 ** 31 + 19
    start = box_room.start_frame(cfg, seed)
    n = 2 * P + 17
    new = box_room.noisy_poses(cfg, n, *noise, seed, start)
    old = _old_noisy_poses(cfg, n, *noise, seed, start)
    assert len(new) == len(old) == n
    for (qa, ta), (qb, tb) in zip(new, old):
        assert np.array_equal(qa, qb) and np.array_equal(ta, tb)


def test_no_plugin_directory_is_no_plugin(tmp_path):
    assert registry.compare_plugins(str(tmp_path), checks.NUMBERS) == {}
