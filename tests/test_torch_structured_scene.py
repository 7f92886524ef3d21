"""tests/test_structured_scene.py on flame_tpu_torch: a slanted plane
meeting a closer fronto-parallel slab (a depth discontinuity), the scene
that checks what NLTGV2's piecewise-planar prior is for.

One run of each package on the JAX test's scene, Params and 14 frames
(the port on the CPU, the JAX package's Flame jitted, as its test runs):

  * the port's final map meets every bound of the JAX test: coverage >
    0.3, median relative idepth error < 0.08, a contrast across the split
    > 0.12 with the slab's median within 15% of 1 / 2.2, and a slope over
    the far plane's columns of the true sign within 0.3x-3x of the truth's;
  * the two final maps cover the same pixels (IoU >= 0.95) with median
    relative |d idepth| <= 1e-2 where both cover
    (tests/test_torch_flame_e2e.py's whole-run bound: match decisions flip
    on float noise, so whole runs are held to bounds, not bits);
  * the contrast across the split agrees within 2% and the slope ratio
    within 20% between the packages (the slope is a linear fit to ~20
    column medians of a small true slant, so it moves with a few vertices
    more than the contrast does).
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import flame_tpu_torch  # noqa: E402
from flame_tpu.core.flame import Flame as JFlame  # noqa: E402
from flame_tpu.geometry import camera as jcam  # noqa: E402
from flame_tpu.geometry import se3 as jse3  # noqa: E402
from flame_tpu.params import (DetectionParams, Params,  # noqa: E402
                              SolverParams)
from flame_tpu_torch import convert  # noqa: E402
from test_structured_scene import (FX, H, W, X_SPLIT, ZB,  # noqa: E402
                                   render_and_truth)

N_FRAMES = 14
STEP = 0.12  # metres the camera moves per frame


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this module's small CPU tensors: the test
    workers run side by side, and more threads only oversubscribe the
    cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def make_params():
    """tests/test_structured_scene.py's Params."""
    return Params(
        feature_capacity=512, edge_capacity=2048, triangle_capacity=1024,
        poseframe_capacity=8, min_height=-100.0, max_height=100.0,
        idepth_init=0.05, idepth_var_init=0.25,
        detection=DetectionParams(win_size=12),
        solver=SolverParams(n_iters_per_frame=40, max_vertex_degree=16),
        debug_quiet=True)


@pytest.fixture(scope="module")
def maps():
    """The final dense maps of both packages and the truth at the last
    camera position."""
    jp = make_params()
    K = jcam.make_k(FX, FX, W / 2, H / 2)
    Kinv = jcam.inv_k(K)
    jf = JFlame(W, H, K, Kinv, jp)
    tf = flame_tpu_torch.Flame(
        W, H, np.array(K), np.array(Kinv),
        convert.params_from_dict(dataclasses.asdict(jp)), device="cpu")
    for i in range(N_FRAMES):
        cam_x = STEP * i
        img, _ = render_and_truth(cam_x)
        jf.update(i * 0.1, i, (jse3.quat_identity(),
                               jnp.array([cam_x, 0.0, 0.0])), img,
                  i % 2 == 0)
        tf.update(i * 0.1, i, (np.array([1.0, 0, 0, 0], np.float32),
                               np.array([cam_x, 0.0, 0.0], np.float32)),
                  img, i % 2 == 0)
    _, truth = render_and_truth(STEP * (N_FRAMES - 1))
    return dict(port=tf.get_inverse_depth_map(),
                jax=jf.get_inverse_depth_map(), truth=truth)


def measure(est, truth):
    """The JAX test's quantities: coverage, median relative error, the
    medians left and right of the split (12 px clear of it), and the
    slope over the far plane's columns with the truth's."""
    ok = ~np.isnan(est)
    rel = np.abs(est[ok] - truth[ok]) / truth[ok]
    u_split = (X_SPLIT - STEP * (N_FRAMES - 1)) / ZB * FX + W / 2
    lm = np.nanmedian(est[:, : max(int(u_split) - 12, 1)])
    rm = np.nanmedian(est[:, min(int(u_split) + 12, W - 1):])
    cols = np.arange(10, int(u_split) - 16)
    col_med = np.array([np.nanmedian(est[:, c]) for c in cols])
    t_cols = np.array([np.nanmedian(truth[:, c]) for c in cols])
    valid = ~np.isnan(col_med)
    slope_est = np.polyfit(cols[valid], col_med[valid], 1)[0]
    slope_true = np.polyfit(cols[valid], t_cols[valid], 1)[0]
    return dict(coverage=ok.mean(), rel=np.median(rel), lm=lm, rm=rm,
                n_cols=int(valid.sum()), slope_est=slope_est,
                slope_true=slope_true)


def test_structured_scene_reconstruction(maps):
    m = measure(maps["port"], maps["truth"])
    assert m["coverage"] > 0.3
    assert m["rel"] < 0.08, f"median rel idepth err {m['rel']}"
    # Left: the slanted far plane (idepth ~0.2-0.24); right: the slab.
    assert m["rm"] - m["lm"] > 0.12, (m["lm"], m["rm"])
    np.testing.assert_allclose(m["rm"], 1.0 / ZB, rtol=0.15)
    # The far plane's idepth varies across x as the slant dictates.
    assert m["n_cols"] > 10
    assert np.sign(m["slope_est"]) == np.sign(m["slope_true"])
    assert 0.3 < m["slope_est"] / m["slope_true"] < 3.0


def test_final_map_matches_jax(maps):
    a, b = maps["port"], maps["jax"]
    ca, cb = ~np.isnan(a), ~np.isnan(b)
    iou = (ca & cb).sum() / (ca | cb).sum()
    assert iou >= 0.95, iou
    both = ca & cb
    d = np.median(np.abs(a[both] - b[both]) / np.abs(b[both]))
    assert d <= 1e-2, d


def test_discontinuity_and_slant_match_jax(maps):
    mp = measure(maps["port"], maps["truth"])
    mj = measure(maps["jax"], maps["truth"])
    contrast = [m["rm"] - m["lm"] for m in (mp, mj)]
    np.testing.assert_allclose(contrast[0], contrast[1], rtol=0.02)
    ratio = [m["slope_est"] / m["slope_true"] for m in (mp, mj)]
    np.testing.assert_allclose(ratio[0], ratio[1], rtol=0.2)
