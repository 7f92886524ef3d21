"""tests/test_nonideal.py's four scenes through flame_tpu_torch on the CPU,
held to the same assertions as the JAX package's runs (whole runs are
held to bounds, not to the JAX output: match decisions flip on float
noise and trajectories drift apart).

  * an occluding box in mini-TUM's ray-cast corridor: the depth
    discontinuity survives smoothing, the failure counters fire, the
    oblique-triangle filter rejects triangles;
  * exposure drift and sensor noise: the cost and ambiguity gates fire,
    features die, the map still forms with bounded error;
  * a texture-free wall patch: no features inside it, the mesh
    interpolates across it;
  * a picket fence (a pure vertical sinusoid under lateral motion): the
    ambiguity gate fires instead of locking onto wrong lobes.

20 frames at 192x144, 1024 features, as the JAX tests run.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import flame_tpu_torch  # noqa: E402
from flame_tpu_torch import DetectionParams, Params, SolverParams  # noqa
from flame_tpu_torch.io import synthetic  # noqa: E402

W, H, FX = 192, 144, 160.0
N_FRAMES = 20


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this module's small CPU tensors: the test
    workers run side by side, and more threads only oversubscribe the
    cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def make_flame():
    params = Params(
        feature_capacity=1024, edge_capacity=4096, triangle_capacity=2048,
        poseframe_capacity=10, min_height=-100.0, max_height=100.0,
        idepth_init=0.2, idepth_var_init=0.25,
        detection=DetectionParams(win_size=12),
        solver=SolverParams(n_iters_per_frame=40, max_vertex_degree=16),
        debug_quiet=True)
    K = np.array([[FX, 0, W / 2], [0, FX, H / 2], [0, 0, 1]], np.float32)
    Kinv = np.linalg.inv(K.astype(np.float64)).astype(np.float32)
    return (flame_tpu_torch.Flame(W, H, K, Kinv, params, device="cpu"),
            K.astype(np.float64))


def _accumulate(fl, totals):
    if fl.inited:
        for k, v in fl.failure_stats().items():
            totals[k] = totals.get(k, 0) + v


def drive(fl, K, **render_kw):
    """The corridor sequence; returns (final true idepth map, summed
    failure counters). exposure_drift scales the per-frame gain and bias
    as in the JAX test; a noise_sigma draws from one seeded generator."""
    drift = render_kw.pop("exposure_drift", 0.0)
    rng = np.random.default_rng(11)
    totals, truth = {}, None
    for i in range(N_FRAMES):
        q, t = synthetic.trajectory(i)
        kw = dict(render_kw)
        if drift or kw.get("noise_sigma"):
            kw.update(exposure_gain=1.0 + drift * np.sin(i / 4.0),
                      exposure_bias=8.0 * drift * np.sin(i / 3.0),
                      noise_rng=rng)
        img, truth = synthetic.render_frame(K, q, t, W, H, **kw)
        fl.update(i * 0.1, i, (np.asarray(q, np.float32),
                               np.asarray(t, np.float32)),
                  img.astype(np.float32), i % 2 == 0)
        _accumulate(fl, totals)
    return truth, totals


def _box_masks(truth):
    """The occluder's pixels (near) and a background ring around them."""
    near = truth > 0.9 / (synthetic._BOX_Z[0]
                          - synthetic.trajectory(N_FRAMES - 1)[1][2])
    pad = 14
    dil = np.zeros_like(near)
    ys, xs = np.nonzero(near)
    if ys.size:
        y0, y1 = max(ys.min() - pad, 0), min(ys.max() + pad, truth.shape[0])
        x0, x1 = max(xs.min() - pad, 0), min(xs.max() + pad, truth.shape[1])
        dil[y0:y1, x0:x1] = True
    return near, dil & ~near


def _fail_sum(d):
    return sum(v for k, v in d.items() if k.startswith("fail_"))


def test_occluder_discontinuity_and_outlier_machinery():
    fl, K = make_flame()
    truth, totals = drive(fl, K, with_box=True)
    est = fl.get_inverse_depth_map()
    ok = ~np.isnan(est) & ~np.isnan(truth)
    assert ok.mean() > 0.4, ok.mean()
    rel = np.abs(est[ok] - truth[ok]) / truth[ok]
    assert np.median(rel) < 0.08, np.median(rel)

    near, ring = _box_masks(truth)
    near_ok, ring_ok = near & ok, ring & ok
    assert near_ok.sum() > 50 and ring_ok.sum() > 100, \
        (near_ok.sum(), ring_ok.sum())
    c_true = np.median(truth[near_ok]) - np.median(truth[ring_ok])
    c_est = np.median(est[near_ok]) - np.median(est[ring_ok])
    assert c_true > 0.1
    assert c_est > 0.6 * c_true, (c_est, c_true)
    rel_near = np.abs(est[near_ok] - truth[near_ok]) / truth[near_ok]
    assert np.median(rel_near) < 0.1, np.median(rel_near)

    fails = sum(totals.get(k, 0) for k in (
        "fail_max_cost", "fail_ambiguous_match", "fail_max_dropouts",
        "fail_max_var"))
    assert fails > 0, totals
    tv = fl._tri_validity[:fl._n_tris].numpy()
    assert fl._n_tris > 50
    assert (~tv).sum() > 0, "no triangles filtered at a discontinuity"


def test_photometric_stress_degrades_gracefully():
    fl, K = make_flame()
    truth, totals = drive(fl, K, with_box=True, exposure_drift=0.15,
                          noise_sigma=6.0)
    est = fl.get_inverse_depth_map()
    ok = ~np.isnan(est) & ~np.isnan(truth)
    assert ok.mean() > 0.25, ok.mean()
    rel = np.abs(est[ok] - truth[ok]) / truth[ok]
    assert np.median(rel) < 0.12, np.median(rel)
    assert totals.get("fail_max_cost", 0) \
        + totals.get("fail_ambiguous_match", 0) > 0, totals
    assert totals.get("fail_max_dropouts", 0) \
        + totals.get("fail_max_var", 0) > 0, totals
    _, clean_totals = drive(make_flame()[0], K, with_box=True)
    assert _fail_sum(totals) > _fail_sum(clean_totals), \
        (_fail_sum(totals), _fail_sum(clean_totals))


def test_textureless_region_yields_no_features_and_interpolates():
    fl, K = make_flame()
    truth, _ = drive(fl, K, with_flat_patch=True)
    q, t = synthetic.trajectory(N_FRAMES - 1)
    patch = synthetic.wall_patch_mask(
        K, q, t, W, H, 0, synthetic._RIGHT_X,
        1, synthetic._FLAT_PATCH_Y, 2, synthetic._FLAT_PATCH_Z)
    # Eroded by the detection cell: a cell straddling the patch border may
    # take a winner from its textured half.
    win = fl.params.detection.win_size
    er = np.zeros_like(patch)
    er[win:-win, win:-win] = patch[win:-win, win:-win]
    for s in range(1, win + 1):
        er[win:-win, win:-win] &= (
            patch[win - s:-win - s, win:-win]
            & patch[win + s:H - win + s, win:-win]
            & patch[win:-win, win - s:-win - s]
            & patch[win:-win, win + s:W - win + s])
    assert er.sum() > 400, er.sum()

    verts, _, _ = fl.get_raw_idepths()
    assert verts.shape[0] > 0
    xi = np.clip(np.round(verts[:, 0]).astype(int), 0, W - 1)
    yi = np.clip(np.round(verts[:, 1]).astype(int), 0, H - 1)
    assert int(er[yi, xi].sum()) == 0, "features in the flat patch"

    est = fl.get_inverse_depth_map()
    assert np.mean(~np.isnan(est[er])) > 0.5
    ok = er & ~np.isnan(est) & ~np.isnan(truth)
    rel = np.abs(est[ok] - truth[ok]) / truth[ok]
    assert np.median(rel) < 0.1, np.median(rel)


def _picket_fence(K, cam_x, plane_z, band_px, period_m=0.2, seed=5):
    """Fronto-parallel plane: the central band_px columns a pure vertical
    sinusoid of period_m, fractal texture elsewhere (the JAX test's
    scene). Returns the uint8 image."""
    fx, cx, cy = K[0, 0], K[0, 2], K[1, 2]
    vv, uu = np.mgrid[0:H, 0:W].astype(np.float64)
    X = (uu - cx) * plane_z / fx + cam_x
    Y = (vv - cy) * plane_z / fx
    tex = synthetic._fractal_texture(X, Y, seed, base_scale=1.8)
    stripes = 128.0 + 60.0 * np.sin(2.0 * np.pi * X / period_m)
    img = np.where(np.abs(uu - cx) < band_px / 2, stripes, tex)
    return np.clip(img, 0, 255).astype(np.uint8)


def test_repetitive_texture_fires_ambiguity_gate():
    plane_z, band = 3.0, 72

    def run(band_px):
        fl, K = make_flame()
        totals = {}
        for i in range(N_FRAMES):
            cam_x = 0.12 * i  # lateral: horizontal epilines
            img = _picket_fence(K, cam_x, plane_z, band_px)
            fl.update(i * 0.1, i, (np.array([1.0, 0, 0, 0], np.float32),
                                   np.array([cam_x, 0, 0], np.float32)),
                      img.astype(np.float32), i % 2 == 0)
            _accumulate(fl, totals)
        return fl, totals

    fl, totals = run(band)
    _, clean_totals = run(0)
    amb = totals.get("fail_ambiguous_match", 0)
    amb_clean = clean_totals.get("fail_ambiguous_match", 0)
    assert amb > max(2 * amb_clean, 20), (amb, amb_clean)

    est = fl.get_inverse_depth_map()
    ok = ~np.isnan(est)
    assert ok.mean() > 0.3, ok.mean()
    rel = np.abs(est - 1.0 / plane_z) * plane_z
    assert np.median(rel[ok]) < 0.05, np.median(rel[ok])
    in_band = np.abs(np.arange(W)[None, :] - W / 2) < band / 2
    band_ok = ok & in_band
    if band_ok.sum() > 50:
        assert np.median(rel[band_ok]) < 0.04, np.median(rel[band_ok])
