"""tests/test_above_vga.py on the port: the whole pipeline at 1024x768
with a 2048-feature budget on the CPU, the CPU check of the bench's XGA
row (python -m flame_tpu_torch.bench with BENCH_RES=1024x768).

The same frames and Params as the JAX package's test (its Params carried
over through convert), the same bounds: the dense map covers > 0.5 of the
image within a median relative error of 0.01, and failure_stats() shows
no truncated triangle or edge and no band or rank drop, and at most two
degree drops. Then the packed-coordinate ceiling: a Flame one pixel past
it is refused at construction.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import flame_tpu_torch  # noqa: E402
from flame_tpu.params import (DetectionParams, Params,  # noqa: E402
                              SolverParams)
from flame_tpu_torch import convert  # noqa: E402
from flame_tpu_torch.core import pipeline  # noqa: E402
from flame_tpu_torch.geometry import camera  # noqa: E402
from test_above_vga import FX, H, PLANE_Z, W, render  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this module's small CPU tensors: the test
    workers run side by side, and more threads only oversubscribe the
    cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def jax_params():
    """test_above_vga.py's Params."""
    n_feats = 2048
    return Params(
        feature_capacity=n_feats, edge_capacity=3 * n_feats,
        triangle_capacity=2 * n_feats, poseframe_capacity=8,
        min_height=-1e6, max_height=1e6, idepth_init=0.05,
        detection=DetectionParams(win_size=32),
        solver=SolverParams(n_iters_per_frame=30, max_vertex_degree=20,
                            pallas_reach=3, async_topology=True,
                            frame_batch=4, join_age=8),
        debug_quiet=True)


def test_xga_pipeline_quality_and_capacities():
    params = convert.params_from_dict(dataclasses.asdict(jax_params()))
    K = camera.make_k(FX, FX, W / 2, H / 2)
    fl = flame_tpu_torch.Flame(W, H, K, camera.inv_k(K), params,
                               device="cpu")
    vv, uu = np.mgrid[0:H, 0:W].astype(np.float64)
    for i in range(16):
        cam_x = 0.08 * i
        fl.update(i * 0.1, i, (np.array([1.0, 0.0, 0.0, 0.0]),
                               np.array([cam_x, 0.0, 0.0])),
                  render(cam_x, vv, uu), i % 2 == 0)

    idm = fl.get_inverse_depth_map()
    cov = float(np.mean(~np.isnan(idm)))
    err = np.abs(idm[~np.isnan(idm)] - 1.0 / PLANE_Z) * PLANE_Z
    assert cov > 0.5, cov
    assert float(np.median(err)) < 0.01

    fs = fl.failure_stats()
    for k in ("tris_truncated", "edges_truncated", "edges_band_dropped",
              "edges_rank_dropped"):
        assert fs[k] == 0, (k, fs[k])
    assert fs["edges_degree_dropped"] <= 2


def test_packed_coordinate_ceiling():
    lim = int(65536 / pipeline.PACK_XY_SCALE)
    assert W < lim and H < lim
    params = flame_tpu_torch.Params(feature_capacity=256, edge_capacity=1024,
                                    triangle_capacity=512,
                                    poseframe_capacity=4)
    K = camera.make_k(100.0, 100.0, lim / 2, 64.0)
    with pytest.raises(ValueError, match="packed coordinate"):
        flame_tpu_torch.Flame(lim, 128, K, camera.inv_k(K), params,
                              device="cpu")
    flame_tpu_torch.Flame(lim - 1, 128, K, camera.inv_k(K), params,
                          device="cpu")
