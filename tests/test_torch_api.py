"""The public functions of flame_tpu_torch that complete its API, against
the JAX package on the same seeded numpy inputs (JAX on the CPU).

Tolerances, per function:
  * keyframe.test_disparity and KeyframeSelector._relative (float64
    numpy in both): 1e-12; KeyframeSelector.select: the same index
    sequence and the same pool;
  * keyframe.score (float32): the same hard-reject decisions, live scores
    at rtol 1e-5;
  * rasterize.interpolate_mesh, rasterize_auto and rasterize_batch_auto:
    the same covered pixels, values at 1e-6;
  * pyramid, gradients, interp.bilinear_uv: atol 1e-4 on 0..255 images
    (float32 sums of up to 9 terms); max_filter3, interp.nearest,
    se3.index/stack and the Delaunay triangles: exactly equal;
  * nltgv2.total_cost: rtol 1e-5 (float32 sums over 2048 edges);
  * topology.from_triangles: edges, masks, incidence tables, src_slot and
    carried duals exactly equal, alpha at rtol 1e-6;
  * filters.plane_param_normal: atol 1e-6; camera.backproject: atol 1e-6;
  * filter.search: statuses equal, match positions and residuals at atol
    1e-3 (the SSD walk sums five float32 products per step);
  * utils.stats.StatsTracker: the same keys (prefixed), the same stats
    and the same behaviour of timings() and clear() as the JAX class.
"""

import ast
import dataclasses
import math
import os
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from flame_tpu.core import keyframe as jkf  # noqa: E402
from flame_tpu.geometry import camera as jcam  # noqa: E402
from flame_tpu.geometry import epipolar as jepi  # noqa: E402
from flame_tpu.geometry import se3 as jse3  # noqa: E402
from flame_tpu.mesh import delaunay as jdel  # noqa: E402
from flame_tpu.mesh import filters as jfilt  # noqa: E402
from flame_tpu.ops import gradients as jgrad  # noqa: E402
from flame_tpu.ops import interp as jinterp  # noqa: E402
from flame_tpu.ops import pyramid as jpyr  # noqa: E402
from flame_tpu.ops import rasterize as jras  # noqa: E402
from flame_tpu.optimize import nltgv2 as jnl  # noqa: E402
from flame_tpu.optimize import topology as jtopo  # noqa: E402
from flame_tpu.params import Params as JParams  # noqa: E402
from flame_tpu.stereo import filter as jfilter  # noqa: E402
from flame_tpu.stereo import line_stereo as jls  # noqa: E402
from flame_tpu.utils import stats as jstats  # noqa: E402
from flame_tpu_torch import convert  # noqa: E402
from flame_tpu_torch.core import keyframe  # noqa: E402
from flame_tpu_torch.geometry import camera, epipolar, se3  # noqa: E402
from flame_tpu_torch.mesh import delaunay, filters  # noqa: E402
from flame_tpu_torch.ops import gradients, interp, pyramid  # noqa: E402
from flame_tpu_torch.ops import rasterize  # noqa: E402
from flame_tpu_torch.optimize import nltgv2, topology  # noqa: E402
from flame_tpu_torch.params import RegularizerParams  # noqa: E402
from flame_tpu_torch.stereo import filter as tfilter  # noqa: E402
from flame_tpu_torch.stereo import line_stereo  # noqa: E402
from flame_tpu_torch.utils import stats  # noqa: E402
from flame_tpu_torch.utils import load_tracker  # noqa: E402

W, H = 160, 120
FX = 100.0
PKG = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "flame_tpu_torch")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this module's small CPU tensors: the test
    workers run side by side, and more threads only oversubscribe the
    cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _K():
    K = np.array(jcam.make_k(FX, FX, W / 2, H / 2), np.float32)
    return K, np.array(jcam.inv_k(K), np.float32)


def _unit_quat(rng, max_angle):
    axis = rng.normal(size=3)
    ang = rng.uniform(-max_angle, max_angle)
    return np.concatenate([[np.cos(ang / 2)],
                           np.sin(ang / 2) * axis / np.linalg.norm(axis)])


def _t(a, dtype=None):
    t = torch.as_tensor(np.asarray(a))
    return t if dtype is None else t.to(dtype)


def _rel_poses(seed, n=64):
    """Crafted hard rejections first (orientation, corners behind, no
    overlap), then seeded relative poses over a broad range."""
    qs = [np.array([np.cos(np.pi / 4), 0, np.sin(np.pi / 4), 0]),
          np.array([1.0, 0, 0, 0]), np.array([1.0, 0, 0, 0])]
    ts = [np.zeros(3), np.array([0, 0, -60.0]), np.array([200.0, 0, 0])]
    rng = np.random.default_rng(seed)
    for _ in range(n - len(qs)):
        qs.append(_unit_quat(rng, 1.6))
        ts.append(rng.normal(size=3) * rng.choice([0.3, 5.0, 40.0]))
    return np.asarray(qs), np.asarray(ts)


# ---------------------------------------------------------------------------
# Keyframe host half.
# ---------------------------------------------------------------------------

def test_test_disparity_and_relative_match_jax():
    K, Kinv = _K()
    rng = np.random.default_rng(1)
    for _ in range(32):
        qa, qb = _unit_quat(rng, 1.0), _unit_quat(rng, 1.0)
        ta, tb = rng.normal(size=3), rng.normal(size=3)
        jr = jkf.KeyframeSelector._relative(qa, ta, qb, tb)
        tr = keyframe.KeyframeSelector._relative(qa, ta, qb, tb)
        for a, b in zip(jr, tr):
            np.testing.assert_allclose(b, a, rtol=0, atol=1e-12)
        u = rng.uniform([0, 0], [W, H])
        depth = float(rng.uniform(0.5, 20.0))
        a = jkf.test_disparity(K, Kinv, *jr, u, depth)
        b = keyframe.test_disparity(K, Kinv, *tr, u, depth)
        assert (math.isinf(a) and math.isinf(b)) or abs(a - b) <= 1e-12 * \
            max(1.0, abs(a)), (a, b)


def test_score_matches_jax():
    K, Kinv = _K()
    qs, ts = _rel_poses(2)
    low = -np.finfo(np.float32).max / 2
    live = 0
    for q, t in zip(qs, ts):
        a = jkf.score(W, H, K, Kinv, q, t)
        b = keyframe.score(W, H, K, Kinv, q, t)
        assert (a <= low) == (b <= low), (q, t, a, b)
        if a > low:
            live += 1
            assert b == pytest.approx(a, rel=1e-5, abs=1e-6)
    assert 10 <= live < len(qs) - 2


def test_keyframe_selector_matches_jax():
    K, _ = _K()
    rng = np.random.default_rng(3)
    js = jkf.KeyframeSelector(K, max_kfs=5, new_kf_thresh=0.1)
    ts_ = keyframe.KeyframeSelector(K, max_kfs=5, new_kf_thresh=0.1)
    img = np.zeros((H, W), np.uint8)
    t = np.zeros(3)
    q = np.array([1.0, 0, 0, 0])
    seq_j, seq_t = [], []
    for i in range(20):
        # Steps of 0-0.25 m: some frames join the pool, some do not.
        t = t + rng.uniform(-0.25, 0.25, 3) * [1.0, 0.3, 1.0]
        q = _unit_quat(rng, 0.15) if i % 3 else q
        seq_j.append(js.select(0.1 * i, img, (q, t)))
        seq_t.append(ts_.select(0.1 * i, img, (q, t)))
    assert seq_t == seq_j
    assert ts_.times == js.times and len(ts_.poses) == len(js.poses) == 5
    for (qa, ta), (qb, tb) in zip(js.poses, ts_.poses):
        np.testing.assert_array_equal(qa, qb)
        np.testing.assert_array_equal(ta, tb)
    assert max(seq_t) >= 0 and ts_.get_keyframe(0)[0] == js.get_keyframe(0)[0]


# ---------------------------------------------------------------------------
# Rasterization, pyramids, stencils, sampling.
# ---------------------------------------------------------------------------

def _mesh(seed, n=120, w=W, h=H):
    rng = np.random.default_rng(seed)
    pts = rng.uniform([2, 2], [w - 3, h - 3], (n, 2)).astype(np.float32)
    tris = delaunay.triangulate(pts).triangles.astype(np.int64)
    return rng, pts, tris


def test_interpolate_mesh_matches_jax():
    rng, pts, tris = _mesh(4)
    vals = rng.uniform(0.1, 0.5, pts.shape[0]).astype(np.float32)
    tri_valid = rng.random(tris.shape[0]) > 0.2
    vtx_valid = rng.random(pts.shape[0]) > 0.1
    a = np.asarray(jras.interpolate_mesh(
        jnp.asarray(pts), jnp.asarray(tris, jnp.int32), jnp.asarray(vals),
        jnp.asarray(tri_valid), jnp.asarray(vtx_valid), H, W))
    b = rasterize.interpolate_mesh(_t(pts), _t(tris), _t(vals),
                                   _t(tri_valid), _t(vtx_valid), H,
                                   W).numpy()
    np.testing.assert_array_equal(np.isnan(a), np.isnan(b))
    ok = ~np.isnan(a)
    assert 0.3 < ok.mean() < 0.95
    np.testing.assert_allclose(b[ok], a[ok], rtol=0, atol=1e-6)
    # Dropping every vertex of a triangle set empties the map.
    none = rasterize.interpolate_mesh(_t(pts), _t(tris), _t(vals),
                                      _t(tri_valid),
                                      torch.zeros(pts.shape[0], dtype=bool),
                                      H, W)
    assert torch.isnan(none).all()


def test_rasterize_auto_and_batch_auto_match_jax():
    """The plain versions the wrappers run on the CPU against the JAX
    package's CPU path (the tiled rasterizer, vmapped over the views)."""
    rng, pts, tris = _mesh(12)
    B = 3
    verts = np.stack([pts + rng.uniform(-4, 4, 2).astype(np.float32)
                      for _ in range(B)])
    vals = rng.uniform(0.1, 0.5, (B, pts.shape[0])).astype(np.float32)
    tri_valid = rng.random((B, tris.shape[0])) > 0.1
    a = np.asarray(jras.rasterize_batch_auto(
        jnp.asarray(verts), jnp.asarray(tris, jnp.int32), jnp.asarray(vals),
        jnp.asarray(tri_valid), H, W))
    b = rasterize.rasterize_batch_auto(_t(verts), _t(tris), _t(vals),
                                       _t(tri_valid), H, W).numpy()
    c = np.stack([rasterize.rasterize_auto(
        _t(verts[i]), _t(tris), _t(vals[i]), _t(tri_valid[i]), H, W).numpy()
        for i in range(B)])
    for got in (b, c):
        np.testing.assert_array_equal(np.isnan(got), np.isnan(a))
        ok = ~np.isnan(a)
        np.testing.assert_allclose(got[ok], a[ok], rtol=0, atol=1e-6)
    assert 0.3 < (~np.isnan(a)).mean() < 0.99


def _image(seed, h=37, w=53):
    return np.random.default_rng(seed).uniform(0, 255, (h, w)).astype(
        np.float32)


def test_pyramid_matches_jax():
    img = _image(5)
    np.testing.assert_allclose(pyramid._blur5(_t(img)).numpy(),
                               np.asarray(jpyr._blur5(jnp.asarray(img))),
                               rtol=0, atol=1e-4)
    np.testing.assert_allclose(pyramid.pyr_down(_t(img)).numpy(),
                               np.asarray(jpyr.pyr_down(jnp.asarray(img))),
                               rtol=0, atol=1e-4)
    jl = jpyr.gaussian_pyramid(jnp.asarray(img), 4)
    tl = pyramid.gaussian_pyramid(_t(img), 4)
    assert [tuple(x.shape) for x in tl] == [x.shape for x in jl]
    for a, b in zip(jl, tl):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=0,
                                   atol=1e-4)
    for ja, ta in zip(jpyr.gradient_pyramid(jl), pyramid.gradient_pyramid(tl)):
        for a, b in zip(ja, ta):
            np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=0,
                                       atol=1e-4)
    np.testing.assert_allclose(pyramid.montage(tl), jpyr.montage(jl),
                               rtol=0, atol=1e-4)


def test_gradient_stencils_match_jax():
    img = _image(6)
    for a, b in zip(jgrad.sobel(jnp.asarray(img)), gradients.sobel(_t(img))):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=0,
                                   atol=1e-4)
    np.testing.assert_array_equal(
        gradients.max_filter3(_t(img)).numpy(),
        np.asarray(jgrad.max_filter3(jnp.asarray(img))))
    u8 = img.astype(np.uint8)
    np.testing.assert_array_equal(
        gradients.max_filter3(_t(u8)).numpy(),
        np.asarray(jgrad.max_filter3(jnp.asarray(u8))))
    gx, gy = gradients.central_gradient(_t(img))
    np.testing.assert_allclose(
        gradients.gradient_mag_sq(gx, gy).numpy(),
        np.asarray(jgrad.gradient_mag_sq(*jgrad.central_gradient(
            jnp.asarray(img)))), rtol=1e-6, atol=1e-4)


def test_interp_nearest_and_bilinear_uv_match_jax():
    img = _image(7)
    rng = np.random.default_rng(7)
    # Half-pixel ties, out-of-range positions and interior samples.
    uv = np.concatenate([
        rng.uniform([-3, -3], [56, 40], (200, 2)),
        np.array([[0.5, 0.5], [1.5, 2.5], [-0.5, 36.5], [52.5, -0.5]])
    ]).astype(np.float32)
    np.testing.assert_array_equal(
        interp.nearest(_t(img), _t(uv[:, 0]), _t(uv[:, 1])).numpy(),
        np.asarray(jinterp.nearest(jnp.asarray(img), jnp.asarray(uv[:, 0]),
                                   jnp.asarray(uv[:, 1]))))
    uv3 = uv[:198].reshape(2, 99, 2)
    np.testing.assert_allclose(
        interp.bilinear_uv(_t(img), _t(uv3)).numpy(),
        np.asarray(jinterp.bilinear_uv(jnp.asarray(img), jnp.asarray(uv3))),
        rtol=0, atol=1e-4)


# ---------------------------------------------------------------------------
# Smoother cost, topology, normals, geometry.
# ---------------------------------------------------------------------------

def _graph_arrays(seed, V=256, E=2048):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.normal(size=s).astype(np.float32)  # noqa: E731
    edges = rng.integers(0, V, (E, 2))
    return dict(pos=rng.uniform(0, 100, (V, 2)).astype(np.float32), x=f(V),
                w1=f(V), w2=f(V), x_bar=f(V), w1_bar=f(V), w2_bar=f(V),
                data_term=f(V), data_weight=np.abs(f(V)),
                vtx_mask=rng.random(V) > 0.2, edges=edges,
                alpha=np.abs(f(E)), beta=np.ones(E, np.float32), q1=f(E),
                q2=f(E), q3=f(E), edge_mask=rng.random(E) > 0.3,
                inc_edge=np.zeros((V, 4), np.int64),
                inc_sign=np.zeros((V, 4), np.float32),
                src_slot=np.zeros(E, np.int64))


def test_total_cost_matches_jax():
    d = _graph_arrays(8)
    rp = RegularizerParams(data_factor=0.3)
    jg = jnl.GraphState(**{k: jnp.asarray(v) for k, v in d.items()})
    from flame_tpu.params import RegularizerParams as JRP
    a = float(jnl.total_cost(JRP(data_factor=0.3), jg))
    b = float(nltgv2.total_cost(rp, convert.graph_state_from_numpy(d, "cpu")))
    assert b == pytest.approx(a, rel=1e-5)
    assert a > 0


@pytest.mark.parametrize("e_cap,degree", [(512, 16), (200, 4)])
def test_from_triangles_matches_jax(e_cap, degree):
    """Carry-over between two triangulations of overlapping point sets,
    at capacities that hold every edge and at ones that drop edges past
    e_cap and slots past the degree."""
    V = 256
    rng = np.random.default_rng(9)
    pos = rng.uniform(0, 150, (V, 2)).astype(np.float32)

    def tris_of(slots):
        t = delaunay.triangulate(pos[slots]).triangles
        out = np.zeros((300, 3), np.int64)
        out[:t.shape[0]] = slots[t]
        return out, t.shape[0]
    t0, n0 = tris_of(np.arange(0, 120))
    t1, n1 = tris_of(np.arange(20, 140))
    zeros_e = np.zeros((e_cap, 2), np.int64)
    q0 = [rng.normal(size=e_cap).astype(np.float32) for _ in range(3)]
    outs = []
    for mod, arr in ((jtopo, jnp.asarray), (topology, _t)):
        prev = mod.from_triangles(arr(t0), n0, arr(pos), arr(zeros_e),
                                  arr(np.zeros(e_cap, bool)),
                                  *[arr(q) for q in q0], e_cap=e_cap,
                                  v_cap=V, degree=degree)
        # Give the first topology's edges duals to carry.
        prev_q = [arr(np.where(np.asarray(prev.edge_mask), q, 0))
                  for q in q0]
        outs.append(mod.from_triangles(arr(t1), n1, arr(pos), prev.edges,
                                       prev.edge_mask, *prev_q,
                                       e_cap=e_cap, v_cap=V, degree=degree))
    j, t = outs
    assert int(j.n_edges) == t.n_edges
    for k in ("edges", "edge_mask", "q1", "q2", "q3", "inc_edge", "inc_sign",
              "src_slot"):
        np.testing.assert_array_equal(getattr(t, k).numpy(),
                                      np.asarray(getattr(j, k)), err_msg=k)
    np.testing.assert_allclose(t.alpha.numpy(), np.asarray(j.alpha),
                               rtol=1e-6, atol=0)
    carried = t.q1.numpy()[t.edge_mask.numpy()]
    assert (carried != 0).sum() > 50 and (carried == 0).sum() > 5
    if e_cap == 200:
        assert t.n_edges == e_cap
        assert (t.src_slot.numpy() == V * degree).sum() > 0
    else:
        assert t.n_edges < e_cap
    # build_incidence=False leaves the tables empty, src_slot at V * D.
    t_noinc = topology.from_triangles(_t(t1), n1, _t(pos), t.edges,
                                      t.edge_mask, t.q1, t.q2, t.q3, e_cap,
                                      V, degree, build_incidence=False)
    assert not t_noinc.inc_edge.any()
    assert (t_noinc.src_slot == V * degree).all()


def test_plane_param_normal_backproject_and_se3_match_jax():
    K, Kinv = _K()
    rng = np.random.default_rng(10)
    uv = rng.uniform([0, 0], [W, H], (64, 2)).astype(np.float32)
    idepth = rng.uniform(0.05, 1.0, 64).astype(np.float32)
    w1, w2 = (rng.normal(0, 1e-3, 64).astype(np.float32) for _ in range(2))
    np.testing.assert_allclose(
        filters.plane_param_normal(_t(K), _t(uv), _t(idepth), _t(w1),
                                   _t(w2)).numpy(),
        np.asarray(jfilt.plane_param_normal(
            jnp.asarray(K), jnp.asarray(uv), jnp.asarray(idepth),
            jnp.asarray(w1), jnp.asarray(w2))), rtol=0, atol=1e-6)
    np.testing.assert_allclose(
        camera.backproject(_t(Kinv), _t(uv.reshape(8, 8, 2))).numpy(),
        np.asarray(jcam.backproject(jnp.asarray(Kinv),
                                    jnp.asarray(uv.reshape(8, 8, 2)))),
        rtol=0, atol=1e-6)
    qs = [_unit_quat(rng, 1.0).astype(np.float32) for _ in range(5)]
    ts = [rng.normal(size=3).astype(np.float32) for _ in range(5)]
    jT = jse3.stack([(jnp.asarray(q), jnp.asarray(t)) for q, t in zip(qs, ts)])
    tT = se3.stack([(_t(q), _t(t)) for q, t in zip(qs, ts)])
    for a, b in zip(jT, tT):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    for i in (0, 3, -1):
        for a, b in zip(jse3.index(jT, i), se3.index(tT, i)):
            np.testing.assert_array_equal(b.numpy(), np.asarray(a))


def test_filter_search_matches_jax():
    """One reference image, one geometry (a sideways camera step), a grid
    of features with their +-8 px search segments in the padded
    comparison image."""
    K, Kinv = _K()
    jp = JParams()
    tp = convert.params_from_dict(dataclasses.asdict(jp))
    pad = jp.pad
    rng = np.random.default_rng(11)
    vv, uu = np.mgrid[0:H + 2 * pad, 0:W + 2 * pad].astype(np.float64)

    def tex(shift):  # integer-valued, as u8 frames are
        X = (uu - shift) * 0.05
        v = (128 + 60 * np.sin(4.1 * X + 0.045 * vv) + 35 * np.cos(1.73 * X)
             + 10 * rng.normal(size=uu.shape))
        return np.clip(np.round(v), 0, 255).astype(np.float32)
    img_ref, img_cmp = tex(0.0), tex(3.0)
    q = np.array([1.0, 0, 0, 0], np.float32)
    t_cmp = np.array([0.15, 0, 0], np.float32)
    zero = np.zeros(3, np.float32)
    jgeo = jepi.load_relative(jnp.asarray(K), jnp.asarray(Kinv),
                              (jnp.asarray(q), jnp.asarray(zero)),
                              (jnp.asarray(q), jnp.asarray(t_cmp)))
    tgeo = epipolar.load_relative(_t(K), _t(Kinv), (_t(q), _t(zero)),
                                  (_t(q), _t(t_cmp)))
    gy, gx = np.mgrid[12:H - 12:9, 12:W - 12:9]
    u_ref = np.stack([gx.ravel(), gy.ravel()], 1).astype(np.float32)
    u_ref = u_ref + rng.uniform(0, 1, u_ref.shape).astype(np.float32)
    u_pad = u_ref + pad
    u_start = u_pad + np.array([-8.0, 0.0], np.float32)
    u_end = u_pad + np.array([8.0, 0.0], np.float32)
    resc = np.ones(u_ref.shape[0], np.float32)
    n_steps = jls.n_steps_for(jp.fparams.epilength_max,
                              jp.fparams.sparams.sample_dist)
    assert n_steps == line_stereo.n_steps_for(
        tp.fparams.epilength_max, tp.fparams.sparams.sample_dist)
    a = jfilter.search(jp.fparams, jgeo, jnp.asarray(resc),
                       jnp.asarray(img_ref), jnp.asarray(img_cmp),
                       jnp.asarray(u_ref), jnp.asarray(u_pad),
                       jnp.asarray(u_start), jnp.asarray(u_end), n_steps)
    b = tfilter.search(tp.fparams, tgeo, _t(resc), _t(img_ref),
                       _t(img_cmp), _t(u_ref), _t(u_pad), _t(u_start),
                       _t(u_end), n_steps)
    st = b.status.numpy()
    np.testing.assert_array_equal(st, np.asarray(a.status))
    assert (st == tfilter.SUCCESS).sum() > 20 and (st != 0).sum() > 0
    ok = st == tfilter.SUCCESS
    np.testing.assert_allclose(b.u_cmp.numpy()[ok], np.asarray(a.u_cmp)[ok],
                               rtol=0, atol=1e-3)
    np.testing.assert_allclose(b.residual.numpy()[ok],
                               np.asarray(a.residual)[ok], rtol=0, atol=1e-3)


def test_idepth_measurement_stacked_matches_jax():
    """Per-feature geometries (sideways steps with small rotations) and
    gradients sampled from a stack of 3 frames at each feature's index:
    the same decisions, idepths and variances within 1e-4 relative."""
    import jax
    from flame_tpu.stereo import meas_model as jmm
    from flame_tpu_torch.stereo import meas_model
    K, Kinv = _K()
    jp = JParams()
    tp = convert.params_from_dict(dataclasses.asdict(jp))
    rng = np.random.default_rng(21)
    N, F = 48, 3
    qs = np.stack([_unit_quat(rng, 0.02) for _ in range(N)]) \
        .astype(np.float32)
    ts = np.stack([rng.uniform(0.05, 0.3, N), rng.normal(0, 0.01, N),
                   rng.normal(0, 0.01, N)], 1).astype(np.float32)
    gx = rng.normal(0, 20, (F, H, W)).astype(np.float32)
    gy = rng.normal(0, 20, (F, H, W)).astype(np.float32)
    fidx = rng.integers(0, F, N).astype(np.int32)
    u_ref = rng.uniform(20, [W - 20, H - 20], (N, 2)).astype(np.float32)
    u_cmp = (u_ref + rng.uniform([-1, -0.5], [8, 0.5], (N, 2))).astype(
        np.float32)
    jgeo = jax.vmap(lambda q, t: jepi.load(jnp.asarray(K), jnp.asarray(Kinv),
                                           q, t))(jnp.asarray(qs),
                                                  jnp.asarray(ts))
    a = jmm.idepth_measurement_stacked(
        jp.zparams, jgeo, jnp.asarray(gx), jnp.asarray(gy),
        jnp.asarray(fidx), jnp.asarray(u_ref), jnp.asarray(u_cmp))
    tgeo = epipolar.load(_t(K), _t(Kinv), _t(qs), _t(ts))
    b = meas_model.idepth_measurement_stacked(
        tp.zparams, tgeo, _t(gx), _t(gy), _t(fidx), _t(u_ref), _t(u_cmp))
    ok = b[0].numpy()
    np.testing.assert_array_equal(ok, np.asarray(a[0]))
    assert 10 < ok.sum() < N  # both outcomes occur
    for k in (1, 2):
        np.testing.assert_allclose(b[k].numpy(), np.asarray(a[k]),
                                   rtol=1e-4, atol=0)


# ---------------------------------------------------------------------------
# Support: the load tracker, the Delaunay source.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("prefix", ["", "rank1/"])
def test_stats_tracker_matches_jax(prefix):
    """The port's StatsTracker against the JAX class: prefixed keys,
    timings(name), stats, ema and clear(); the port keeps its device
    argument (CUDA events on a card only)."""
    trackers = (jstats.StatsTracker(prefix),
                stats.StatsTracker(prefix, device="cpu"))
    for tr in trackers:
        assert tr.timings("stage") == 0.0 and tr.tock("stage") == 0.0
        tr.tick("stage")
        assert tr.tock("stage") >= 0.0
        with tr.timed("block"):
            pass
        tr.set("count", 3)
        tr.add("count", 2)
        tr.add("fresh", 1.5)
        tr.ema("rate", 10.0)
        tr.ema("rate", 20.0, alpha=0.5)
    (jt, tt) = (tr.snapshot() for tr in trackers)
    assert set(jt["timings_ms"]) == set(tt["timings_ms"]) == {
        prefix + "stage", prefix + "block"}
    assert jt["stats"] == tt["stats"] == {
        prefix + "count": 5.0, prefix + "fresh": 1.5, prefix + "rate": 15.0}
    for tr, snap in zip(trackers, (jt, tt)):
        assert tr.timings("stage") == snap["timings_ms"][prefix + "stage"]
        assert tr.stats("count") == 5.0 and tr.stats("missing") == 0.0
        tr.tick("open")
        tr.clear()
        assert tr.snapshot() == {"timings_ms": {}, "stats": {}}
        assert tr.tock("open") == 0.0 and tr.timings("stage") == 0.0


def test_load_tracker_on_the_cpu():
    from flame_tpu.utils import load_tracker as jlt
    lt = load_tracker.LoadTracker(device="cpu")
    first = lt.cpu()
    assert first == (0.0, 0.0)
    sum(i * i for i in range(200_000))  # some CPU time for this process
    c = lt.cpu()
    for v in c:
        assert 0.0 <= v <= 100.0
    m = lt.mem()
    assert set(jlt.MemLoad._fields) <= set(m._fields)
    assert m.sys_total_kb > 0 and m.process_rss_kb > 0
    assert m.device_free_bytes is None and m.device_total_bytes is None
    assert lt.device_memory() is None
    out = lt.get()
    assert set(jlt.LoadTracker().get()) <= set(out)
    for k in ("cpu_total_pct", "cpu_process_pct"):
        assert 0.0 <= out[k] <= 100.0
    assert not any(k.startswith("device_") for k in out)


def _parity_points(seed, n):
    """Point sets of the Delaunay parity test, by seed: uniform (0, 1),
    with a cocircular integer grid (2), on the 1/32-px grid the members
    sit on at 640x480 (3) and 752x480 (4), clustered as detected
    features are (5), and an integer grid with the midpoints of its
    edges (6). The last lies 2^20 px from the origin with float32's step
    there as the unit, where the core's jitter rounds away: later points
    fall exactly on edges of earlier triangles, so the point location's
    walk ends in one of two triangles, and the core must pick the JAX
    package's."""
    rng = np.random.default_rng(seed)
    if seed in (3, 4):
        hi = (640.0, 480.0) if seed == 3 else (752.0, 480.0)
        return (np.round(rng.uniform((0, 0), hi, (n, 2)) * 32) / 32
                ).astype(np.float32)
    if seed == 5:
        centres = rng.uniform((0, 0), (640, 480), (40, 2))
        pts = centres[rng.integers(0, 40, n)] + rng.normal(0, 6, (n, 2))
        return (np.round(pts * 32) / 32).astype(np.float32)
    if seed == 6:
        k = 16
        g = np.stack(np.meshgrid(np.arange(k), np.arange(k)), -1
                     ).reshape(-1, 2).astype(np.float64)
        mids = np.concatenate([g[g[:, 0] < k - 1] + (0.5, 0),
                               g[g[:, 1] < k - 1] + (0, 0.5)])
        pts = np.concatenate([g, mids])[:n]
        off = 2.0 ** 20
        step = float(np.spacing(np.float32(off)))
        return (off + pts * 2 * step).astype(np.float32)
    pts = rng.uniform(0, 640, (n, 2)).astype(np.float32)
    if seed == 2:  # cocircular integer grid points, the hard ties
        pts[:400] = np.stack(np.meshgrid(np.arange(20), np.arange(20)),
                             -1).reshape(-1, 2) * 16.0
    return pts


@pytest.mark.parametrize("seed,n", [(0, 50), (1, 400), (2, 1500),
                                    (3, 2048), (4, 4096), (5, 4000),
                                    (6, 736)])
def test_delaunay_matches_jax_bit_for_bit(seed, n):
    pts = _parity_points(seed, n)
    assert len(np.unique(pts, axis=0)) == n
    a, b = jdel.triangulate(pts), delaunay.triangulate(pts)
    for k in ("triangles", "edges", "neighbors"):
        np.testing.assert_array_equal(getattr(b, k), np.asarray(getattr(a, k)))


def test_delaunay_walk_steps_per_point():
    """The walk starts next to the point: on 4,096 random points of the
    1/32-px grid it visits under 8 triangles a point (the JAX package's
    walk from the last-inserted triangle visits about 50)."""
    pts = _parity_points(3, 4096)
    tri = delaunay.triangulate(pts)
    assert 1.0 <= tri.walk_steps / len(pts) < 8.0


def test_native_available_matches_jax():
    assert delaunay.native_available() is True
    assert jdel.native_available() is True


def _code_strings(path):
    """String constants of a Python file that are not docstrings."""
    tree = ast.parse(open(path).read())
    docs = set()
    for node in ast.walk(tree):
        if isinstance(node, (ast.Module, ast.ClassDef, ast.FunctionDef,
                             ast.AsyncFunctionDef)) and node.body \
                and isinstance(node.body[0], ast.Expr) \
                and isinstance(node.body[0].value, ast.Constant):
            docs.add(id(node.body[0].value))
    return [n.value for n in ast.walk(tree) if isinstance(n, ast.Constant)
            and isinstance(n.value, str) and id(n) not in docs], tree


def test_port_names_no_path_of_the_jax_package():
    """No .py or .cu file of flame_tpu_torch imports flame_tpu or names a
    path under flame_tpu/ outside comments and docstrings (the Delaunay
    source is the port's own copy)."""
    bad = []
    for root, _dirs, files in os.walk(PKG):
        if "_build" in root:
            continue
        for name in files:
            path = os.path.join(root, name)
            if name.endswith(".py"):
                strings, tree = _code_strings(path)
                for s in strings:
                    parts = re.split(r"[/\\]", s)
                    if "flame_tpu" in parts or s == "flame_tpu":
                        bad.append(f"{path}: string {s!r}")
                for node in ast.walk(tree):
                    mods = ([a.name for a in node.names]
                            if isinstance(node, ast.Import) else
                            [node.module or ""]
                            if isinstance(node, ast.ImportFrom) else [])
                    for m in mods:
                        if m == "flame_tpu" or m.startswith("flame_tpu."):
                            bad.append(f"{path}: import {m}")
            elif name.endswith((".cu", ".cpp", ".h", ".cuh")):
                src = open(path).read()
                code = re.sub(r"//[^\n]*|/\*.*?\*/", "", src, flags=re.S)
                if re.search(r"flame_tpu[/\\]", code):
                    bad.append(f"{path}: names flame_tpu/")
    assert not bad, bad
    assert delaunay.SRC.startswith(PKG + os.sep)
    assert os.path.exists(delaunay.SRC)
