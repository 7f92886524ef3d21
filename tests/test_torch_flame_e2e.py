"""The slice as a whole: the tests/test_flame_e2e.py scene (160x120, 512
features, photo_error_num_pfs=0) as uint8 frames for 12 frames through
flame_tpu.Flame and flame_tpu_torch.Flame on the CPU.

update() must return the same booleans frame by frame; both runs must
meet the test_flame_e2e.py bounds; the final dense maps must cover the
same pixels (IoU >= 0.95) with median |d idepth| / idepth <= 1e-2 where
both cover. Trajectories are held to bounds rather than bit-equality:
match decisions flip on float noise and the runs drift apart slowly."""

import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import flame_tpu_torch  # noqa: E402
from flame_tpu.core.flame import Flame as JFlame  # noqa: E402
from flame_tpu.geometry import camera as jcam  # noqa: E402
from flame_tpu.params import (DetectionParams, Params,  # noqa: E402
                              SolverParams)
from flame_tpu_torch import _kernels, convert  # noqa: E402
from flame_tpu_torch.core import frame as tframe  # noqa: E402
from flame_tpu_torch.parallel import sharding  # noqa: E402
from flame_tpu_torch.parallel.orchestrator import ShardedFlame  # noqa: E402

FX = 100.0
W, H = 160, 120
PLANE_Z = 5.0
TRUE_IDEPTH = 1.0 / PLANE_Z
N_FRAMES = 12
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def render(cam_x):
    vv, uu = np.mgrid[0:H, 0:W].astype(np.float64)
    X = (uu - W / 2) * PLANE_Z / FX + cam_x
    Y = (vv - H / 2) * PLANE_Z / FX
    tex = (128 + 60 * np.sin(4.1 * X + 0.9 * Y) + 35 * np.cos(1.73 * X)
           + 18 * np.sin(2.31 * Y) + 10 * np.sin(0.83 * X))
    return np.clip(tex, 0, 255).astype(np.uint8)


def make_params():
    return Params(
        feature_capacity=512, edge_capacity=2048, triangle_capacity=1024,
        poseframe_capacity=8, min_height=-100.0, max_height=100.0,
        idepth_init=0.05, idepth_var_init=0.25, photo_error_num_pfs=0,
        detection=DetectionParams(win_size=16),
        solver=SolverParams(n_iters_per_frame=30, max_vertex_degree=16),
        debug_quiet=True)


def _K():
    K = jcam.make_k(FX, FX, W / 2, H / 2)
    return K, jcam.inv_k(K)


@pytest.fixture(scope="module")
def runs():
    jp = make_params()
    K, Kinv = _K()
    jf = JFlame(W, H, K, Kinv, jp)
    tf = flame_tpu_torch.Flame(W, H, np.array(K), np.array(Kinv),
                               convert.params_from_dict(
                                   dataclasses.asdict(jp)),
                               device=torch.device("cpu"))
    launches = dict(_kernels.LAUNCHES)
    jr, tr = [], []
    for i in range(N_FRAMES):
        q = np.array([1.0, 0, 0, 0], np.float32)
        t = np.array([0.15 * i, 0, 0], np.float32)
        img = render(0.15 * i)
        jr.append(jf.update(i * 0.1, i, (jnp.asarray(q), jnp.asarray(t)),
                            img, i % 2 == 0))
        tr.append(tf.update(i * 0.1, i, (q, t), img, i % 2 == 0))
    assert _kernels.LAUNCHES == launches  # CPU tensors never launch
    return jf, tf, jr, tr


def test_update_booleans_match(runs):
    _, _, jr, tr = runs
    assert jr == tr
    assert not tr[0] and all(tr[6:])


@pytest.mark.parametrize("which", ["jax", "torch"])
def test_dense_map_and_raw_idepth_bounds(runs, which):
    fl = runs[0] if which == "jax" else runs[1]
    idm = fl.get_inverse_depth_map()
    cov = np.mean(~np.isnan(idm))
    assert cov > 0.3, cov
    err = np.abs(idm[~np.isnan(idm)] - TRUE_IDEPTH) / TRUE_IDEPTH
    assert np.median(err) < 0.1, np.median(err)
    verts, mu, var = fl.get_raw_idepths()
    assert verts.shape[0] > 30
    assert np.median(np.abs(mu - TRUE_IDEPTH) / TRUE_IDEPTH) < 0.08
    assert np.all(var >= 0)


def test_final_maps_agree(runs):
    jf, tf, _, _ = runs
    a = jf.get_inverse_depth_map()
    b = tf.get_inverse_depth_map()
    ca, cb = ~np.isnan(a), ~np.isnan(b)
    assert (ca & cb).sum() / (ca | cb).sum() >= 0.95
    both = ca & cb
    assert np.median(np.abs(a[both] - b[both]) / np.abs(a[both])) <= 1e-2
    assert abs(jf.coverage() - tf.coverage()) < 0.05


def test_mesh_and_stats(runs):
    _, tf, _, _ = runs
    mesh = tf.get_inverse_depth_mesh()
    nv = mesh["vertices"].shape[0]
    assert nv >= 3 and mesh["normals"].shape == (nv, 3)
    assert mesh["triangles"].max() < nv and mesh["edges"].max() < nv
    assert mesh["tri_validity"].shape == (mesh["triangles"].shape[0],)
    n = mesh["normals"]
    assert np.median(n[np.linalg.norm(n, axis=1) > 0.5][:, 2]) < -0.8
    timings = tf.stats.snapshot()["timings_ms"]
    for key in ("update", "frame_creation", "update_idepths", "triangulate",
                "sync_graph", "smoother", "raster"):
        assert key in timings, key
    assert tf.failure_stats()["updates"] > 20


def test_unported_paths_raise():
    """Every single-card path constructs: automatic poseframes, the
    throughput path (async topology, batching, comparison-poseframe
    scoring) and bundle adjustment; BA rejects an odd feature_capacity
    and more than 128 poseframe slots as the JAX package does."""
    K, Kinv = _K()
    fl = flame_tpu_torch.Flame(W, H, np.array(K), np.array(Kinv),
                               flame_tpu_torch.Params(auto_poseframe=True),
                               device="cpu")
    assert fl.params.auto_poseframe and fl._curr_pf_pose_np is None
    flame_tpu_torch.Flame(W, H, np.array(K), np.array(Kinv),
                          flame_tpu_torch.Params(
                              solver=flame_tpu_torch.SolverParams(
                                  async_topology=True, frame_batch=8)),
                          device="cpu")
    fl = flame_tpu_torch.Flame(W, H, np.array(K), np.array(Kinv),
                               flame_tpu_torch.Params(do_ba=True),
                               device="cpu")
    assert fl._ba is not None
    for bad in (dict(feature_capacity=511), dict(poseframe_capacity=129)):
        with pytest.raises(ValueError):
            flame_tpu_torch.Flame(W, H, np.array(K), np.array(Kinv),
                                  flame_tpu_torch.Params(do_ba=True, **bad),
                                  device="cpu")
        with pytest.raises(ValueError):
            JFlame(W, H, K, Kinv, Params(do_ba=True, **bad))


def _render_float(cam_x):
    """__graft_entry__.dryrun_multichip's scene: float frames."""
    vv, uu = np.mgrid[0:H, 0:W].astype(np.float64)
    X = (uu - W / 2) * PLANE_Z / FX + cam_x
    Y = (vv - H / 2) * PLANE_Z / FX
    return (128 + 60 * np.sin(4.1 * X + 0.9 * Y) + 35 * np.cos(1.73 * X)
            + 18 * np.sin(2.31 * Y) + 10 * np.sin(0.83 * X)).astype(
                np.float32)


@pytest.fixture(scope="module")
def sharded_ba_runs():
    """ShardedFlame with do_ba on dryrun_multichip's BA sequence (14
    frames, every second one a poseframe, 512 features, BA window 4 with
    3 Gauss-Newton iterations, max_obs 1001 so that the observation rows
    are padded to the mesh) in both packages, on 4 partitions (the port's
    of the CPU, the JAX package's 4 virtual devices)."""
    sys.path.insert(0, REPO)
    import __graft_entry__ as ge
    from flame_tpu.params import BAParams
    from flame_tpu.parallel import sharding as jsh
    from flame_tpu.parallel.orchestrator import ShardedFlame as JSharded
    import jax
    jp = ge._small_params(feature_capacity=512, edge_capacity=2048).replace(
        triangle_capacity=1024, poseframe_capacity=8, min_height=-100.0,
        max_height=100.0, idepth_init=0.05, idepth_var_init=0.25,
        detection=DetectionParams(win_size=16), do_ba=True,
        ba=BAParams(window_size=4, n_gn_iters=3, obs_capacity=4096,
                    max_landmarks=256, max_obs=1001),
        solver=SolverParams(n_iters_per_frame=30, max_vertex_degree=16,
                            smoother="vertex"))
    K, Kinv = _K()
    jf = JSharded(W, H, K, Kinv, jp, mesh=jsh.make_mesh(jax.devices()[:4]))
    tf = ShardedFlame(W, H, np.array(K), np.array(Kinv),
                      convert.params_from_dict(dataclasses.asdict(jp)),
                      mesh=sharding.make_mesh(4, "cpu"), device="cpu")
    for i in range(14):
        q = np.array([1.0, 0, 0, 0], np.float32)
        t = np.array([0.15 * i, 0, 0], np.float32)
        img = _render_float(0.15 * i)
        jf.update(i * 0.1, i, (jnp.asarray(q), jnp.asarray(t)), img,
                  i % 2 == 0)
        tf.update(i * 0.1, i, (q, t), img, i % 2 == 0)
    return {"jax": jf, "torch": tf}


@pytest.mark.parametrize("which", ["jax", "torch"])
def test_sharded_flame_runs_ba(sharded_ba_runs, which):
    """Every BA solve under the mesh takes the observation-sharded path,
    and the run meets the dry run's bounds (coverage > 0.4, median
    relative error < 0.05). Trajectories are not compared: the sharded
    solve applies at once, the single one a step or two later."""
    fl = sharded_ba_runs[which]
    idm = fl.get_inverse_depth_map()
    cov = float(np.mean(~np.isnan(idm)))
    err = float(np.nanmedian(np.abs(idm - TRUE_IDEPTH)) * PLANE_Z)
    assert cov > 0.4, cov
    assert err < 0.05, err
    assert fl.stats.stats("ba_sharded_solves") >= 1
    assert fl.stats.stats("ba_single_solves") == 0.0


def test_failure_stats_match_jax():
    """failure_stats() on a run whose first mesh overflows the triangle,
    edge and vertex-degree capacities: the JAX package's keys and values
    (plus the port's raster_max_union_candidates), and its
    num_idepth_updates stat. Detections enter the graph at once
    (idepth_var_init below idepth_var_max_graph), so the first mesh is
    built from the same detections in both packages."""
    jp = dataclasses.replace(
        make_params(), idepth_var_init=0.005, triangle_capacity=96,
        edge_capacity=64, solver=dataclasses.replace(make_params().solver,
                                                     max_vertex_degree=4))
    K, Kinv = _K()
    jf = JFlame(W, H, K, Kinv, jp)
    tf = flame_tpu_torch.Flame(W, H, np.array(K), np.array(Kinv),
                               convert.params_from_dict(
                                   dataclasses.asdict(jp)), device="cpu")
    for i in range(3):  # frame 2 is the first poseframe that meshes
        q = np.array([1.0, 0, 0, 0], np.float32)
        t = np.array([0.15 * i, 0, 0], np.float32)
        jr = jf.update(i * 0.1, i, (jnp.asarray(q), jnp.asarray(t)),
                       render(0.15 * i), i % 2 == 0)
        assert tf.update(i * 0.1, i, (q, t), render(0.15 * i),
                         i % 2 == 0) == jr
    assert jr
    js, ts = jf.failure_stats(), tf.failure_stats()
    assert set(ts) == set(js) | {"raster_max_union_candidates"}
    assert {k: ts[k] for k in js} == js
    assert min(js[k] for k in ("tris_truncated", "edges_truncated",
                               "edges_degree_dropped")) > 0
    assert tf.stats.stats("num_idepth_updates") == \
        jf.stats.stats("num_idepth_updates")


def test_full_poseframe_slots_evict_the_oldest():
    K, Kinv = _K()
    p = convert.params_from_dict(dataclasses.asdict(make_params()))
    fl = flame_tpu_torch.Flame(W, H, np.array(K), np.array(Kinv),
                               p.replace(poseframe_capacity=2), device="cpu")
    pose = (np.array([1.0, 0, 0, 0]), np.zeros(3))
    for i in range(3):
        fl.update(0.1 * i, i, pose, render(0.0), True)
    assert sorted(fl._pf_slot_by_id) == [1, 2]
    assert fl.stats.stats("pf_evictions") == 1
    assert sorted(fl._stack.frame_id.tolist()) == [1, 2]
    with pytest.raises(ValueError):  # the current poseframe must stay
        fl.prune_poseframes([1])


def test_frame_insert_rejects_bad_slot():
    stack = tframe.empty_stack(2, H, W, 5, "cpu")
    f = tframe.create(0, torch.tensor([1.0, 0, 0, 0]), torch.zeros(3),
                      torch.as_tensor(render(0.0)), 5)
    tframe.insert(stack, 1, f)
    assert bool(stack.valid[1]) and not bool(stack.valid[0])
    for bad in (-1, 2):
        with pytest.raises(IndexError):
            tframe.insert(stack, bad, f)


def test_port_imports_no_jax():
    code = ("import sys, flame_tpu_torch, flame_tpu_torch.convert, "
            "flame_tpu_torch.optimize.smoother_kernel, "
            "flame_tpu_torch.ops.raster_kernel, flame_tpu_torch.ops.pyramid, "
            "flame_tpu_torch.utils.checkpoint, "
            "flame_tpu_torch.utils.load_tracker, "
            "flame_tpu_torch.parallel.sharding, "
            "flame_tpu_torch.parallel.distributed_ba, "
            "flame_tpu_torch.parallel.multihost, "
            "flame_tpu_torch.parallel.orchestrator, "
            "flame_tpu_torch.run_synthetic; "
            "assert 'jax' not in sys.modules, 'jax imported'; "
            "assert not any(m.startswith('flame_tpu.') or m == 'flame_tpu' "
            "for m in sys.modules), 'flame_tpu imported'")
    env = dict(os.environ, PYTHONPATH=REPO)
    subprocess.run([sys.executable, "-c", code], check=True, cwd=REPO,
                   env=env, timeout=120)
