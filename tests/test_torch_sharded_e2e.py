"""The partitioned smoother path as a whole: flame_tpu_torch's ShardedFlame
on the tests/test_sharded_e2e.py scene (160x120, 1024 features, 14
frames, every second one a poseframe) with 4 partitions of the CPU, in
both partitioned modes ("halo", plain torch; "pallas_halo", the halo
kernel's plain version here), and Flame with smoother="pallas" (the
banded layout with one partition).

Each run must meet the JAX package's bounds for its ShardedFlame
(coverage > 0.5, median relative error < 0.02) and reproduce the port's
vertex-smoother run on the same frames to a median |d idepth| of 1e-4
(the same math, summed in another order). The routing checks: the
banded modes never run the vertex smoother, a mode without its mesh or
its RCM order raises, and ShardedFlame checks its configuration as the
JAX package's does.
"""

import dataclasses
import inspect
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import flame_tpu_torch  # noqa: E402
from flame_tpu_torch import (DetectionParams, Params,  # noqa: E402
                             SolverParams, _kernels)
from flame_tpu_torch.core import pipeline  # noqa: E402
from flame_tpu_torch.optimize import nltgv2  # noqa: E402
from flame_tpu_torch.parallel import halo_kernel, sharding  # noqa: E402
from flame_tpu_torch.parallel.orchestrator import ShardedFlame  # noqa: E402

FX = 100.0
W, H = 160, 120
PLANE_Z = 5.0
N_FRAMES = 14
K = np.array([[FX, 0, W / 2], [0, FX, H / 2], [0, 0, 1]], np.float32)
KINV = np.linalg.inv(K.astype(np.float64)).astype(np.float32)


def render(cam_x):
    vv, uu = np.mgrid[0:H, 0:W].astype(np.float64)
    X = (uu - W / 2) * PLANE_Z / FX + cam_x
    Y = (vv - H / 2) * PLANE_Z / FX
    return (128 + 60 * np.sin(4.1 * X + 0.9 * Y) + 35 * np.cos(1.73 * X)
            + 18 * np.sin(2.31 * Y) + 10 * np.sin(0.83 * X)) \
        .astype(np.float32)


def make_params(smoother, **solver):
    return Params(
        feature_capacity=1024, edge_capacity=4096, triangle_capacity=2048,
        poseframe_capacity=8, min_height=-100.0, max_height=100.0,
        idepth_init=0.05, idepth_var_init=0.25,
        detection=DetectionParams(win_size=16),
        solver=SolverParams(n_iters_per_frame=30, max_vertex_degree=16,
                            smoother=smoother, **solver),
        debug_quiet=True)


def run(smoother, n_parts=4, n_frames=N_FRAMES, **solver):
    p = make_params(smoother, **solver)
    if smoother in ("halo", "pallas_halo"):
        fl = ShardedFlame(W, H, K, KINV, p,
                          mesh=sharding.make_mesh(n_parts, "cpu"),
                          device="cpu")
    else:
        fl = flame_tpu_torch.Flame(W, H, K, KINV, p, device="cpu")
    for i in range(n_frames):
        cam_x = 0.15 * i
        img = render(cam_x)
        if solver.get("frame_batch", 1) > 1:
            img = np.clip(img, 0, 255).astype(np.uint8)
        fl.update(i * 0.1, i, (np.array([1.0, 0, 0, 0]),
                               np.array([cam_x, 0.0, 0.0])), img, i % 2 == 0)
    return fl


@pytest.fixture(scope="module")
def runs():
    launches = dict(_kernels.LAUNCHES)
    out = {mode: run(mode) for mode in ("vertex", "pallas", "halo",
                                        "pallas_halo")}
    assert _kernels.LAUNCHES == launches  # CPU tensors never launch
    return out


@pytest.mark.parametrize("mode", ["pallas", "halo", "pallas_halo"])
def test_accuracy(runs, mode):
    idm = runs[mode].get_inverse_depth_map()
    cov = np.mean(~np.isnan(idm))
    assert cov > 0.5, (mode, cov)
    err = np.abs(idm[~np.isnan(idm)] - 1.0 / PLANE_Z) * PLANE_Z
    assert np.median(err) < 0.02, (mode, np.median(err))


@pytest.mark.parametrize("mode", ["pallas", "halo", "pallas_halo"])
def test_matches_vertex_run(runs, mode):
    a = runs[mode].get_inverse_depth_map()
    b = runs["vertex"].get_inverse_depth_map()
    both = ~np.isnan(a) & ~np.isnan(b)
    assert both.mean() > 0.5, mode
    assert np.median(np.abs(a[both] - b[both])) < 1e-4, mode


@pytest.mark.parametrize("mode", ["pallas", "halo", "pallas_halo"])
def test_drop_stats(runs, mode):
    """The band / degree attribution is counted (nothing drops here:
    RCM bandwidth stays inside reach 2 and degree 16)."""
    st = runs[mode].stats
    for key in ("edges_rank_dropped", "edges_band_dropped",
                "edges_degree_dropped"):
        assert st.stats(key) == 0.0, (mode, key)
    assert runs[mode]._topo_dev.dev["perm"] is not None


def test_throughput_path_with_pallas_halo():
    """Async topology with frame_batch=4 (deterministic schedule) through
    the partitioned kernel path matches the vertex run of the same
    configuration."""
    kw = dict(async_topology=True, frame_batch=4, deterministic=True)
    a = run("pallas_halo", **kw)
    b = run("vertex", **kw)
    assert a._dispatches >= 1
    ia, ib = a.get_inverse_depth_map(), b.get_inverse_depth_map()
    both = ~np.isnan(ia) & ~np.isnan(ib)
    assert both.mean() > 0.5
    assert np.median(np.abs(ia[both] - ib[both])) < 1e-4


@pytest.mark.parametrize("mode", ["pallas", "pallas_halo"])
def test_banded_modes_run_the_halo_kernel_path(monkeypatch, mode):
    """Every post-Delaunay step of a banded mode runs the halo kernel's
    path once and never the vertex smoother."""
    calls = []
    plain = halo_kernel.iterate_plain
    monkeypatch.setattr(halo_kernel, "iterate_plain",
                        lambda *a, **k: calls.append(a[4]) or plain(*a, **k))

    def forbidden(*a, **k):
        raise AssertionError("vertex smoother on a banded path")
    monkeypatch.setattr(nltgv2, "iterate_plain", forbidden)
    posts = []
    inner = pipeline._post_delaunay_inner
    monkeypatch.setattr(pipeline, "_post_delaunay_inner",
                        lambda *a, **k: posts.append(1) or inner(*a, **k))
    run(mode, n_frames=6)
    assert len(posts) >= 1 and len(calls) == len(posts)
    assert set(calls) == {4 if mode == "pallas_halo" else 1}


def test_halo_modes_need_a_mesh():
    for mode in ("halo", "pallas_halo"):
        with pytest.raises(ValueError):
            flame_tpu_torch.Flame(W, H, K, KINV, make_params(mode),
                                  device="cpu")
    with pytest.raises(ValueError):
        flame_tpu_torch.Flame(W, H, K, KINV, make_params("no_such_mode"),
                              device="cpu")


def test_rank_layout_needs_perm_and_mesh():
    """Without the RCM order (or, for the partitioned modes, the mesh) the
    smoother raises: the graph holds no incidence tables to fall back on."""
    g = nltgv2.empty(1024, 4096, 16, "cpu")
    ranks = torch.zeros((4096, 2), dtype=torch.int64)
    perm = torch.arange(1024)
    for mode, pm, mesh in (("pallas", None, None),
                           ("halo", perm, None),
                           ("pallas_halo", perm, None),
                           ("pallas_halo", None,
                            sharding.make_mesh(2, "cpu"))):
        with pytest.raises(ValueError):
            pipeline._smooth(make_params(mode), g, mode, ranks, pm, mesh)


def test_sharded_constructor_checks():
    mesh = sharding.make_mesh(4, "cpu")
    with pytest.raises(ValueError):  # capacity does not divide
        ShardedFlame(W, H, K, KINV,
                     make_params("vertex").replace(edge_capacity=4094),
                     mesh=mesh, device="cpu")
    with pytest.raises(ValueError):  # 8 rows over 8 partitions < reach 2
        ShardedFlame(W, H, K, KINV, make_params("pallas_halo"),
                     mesh=sharding.make_mesh(8, "cpu"), device="cpu")
    with pytest.raises(ValueError):  # the mesh lies on another device
        ShardedFlame(W, H, K, KINV, make_params("halo"),
                     mesh=sharding.Mesh((torch.device("cuda", 0),)),
                     device="cpu")
    with pytest.warns(UserWarning):
        fl = ShardedFlame(W, H, K, KINV, make_params("pallas"), mesh=mesh,
                          device="cpu")
    assert fl.params.solver.smoother == "vertex"
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        fl = ShardedFlame(W, H, K, KINV, make_params("auto"), mesh=mesh,
                          device="cpu")
    assert fl.params.solver.smoother == "vertex"
    assert fl.mesh is mesh


def test_band_drops_are_counted():
    """pallas_reach 0 keeps only edges within one row of 128 ranks; the
    rest drop and are counted as band drops, and the run still meshes."""
    fl = run("pallas_halo", pallas_reach=0)
    assert fl.stats.stats("edges_band_dropped") > 0
    assert fl.stats.stats("edges_rank_dropped") \
        >= fl.stats.stats("edges_band_dropped")
    assert np.mean(~np.isnan(fl.get_inverse_depth_map())) > 0.3


def test_entry_points_default_to_the_card():
    for cls in (flame_tpu_torch.Flame, ShardedFlame):
        assert inspect.signature(cls.__init__).parameters["device"] \
            .default == "cuda"
    assert inspect.signature(sharding.make_mesh).parameters["device"] \
        .default == "cuda"
    assert dataclasses.replace(SolverParams()).pallas_reach == 2
