"""flame_tpu_torch geometry (se3, camera, epipolar) against the JAX package
on seeded inputs (atol 1e-5: float32 rounding of the same formulas), plus
the closed-form fixtures of tests/test_se3.py and tests/test_epipolar.py."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from flame_tpu.geometry import camera as jcam  # noqa: E402
from flame_tpu.geometry import epipolar as jepi  # noqa: E402
from flame_tpu.geometry import se3 as jse3  # noqa: E402
from flame_tpu_torch.geometry import camera, epipolar, se3  # noqa: E402

ATOL = 1e-5


def _quats(rng, n):
    q = rng.normal(size=(n, 4)).astype(np.float32)
    return q / np.linalg.norm(q, axis=1, keepdims=True)


def _t(a):
    return torch.as_tensor(np.array(a, np.float32))


def _cmp(a, b, atol=ATOL, rtol=0.0):
    np.testing.assert_allclose(np.asarray(b), np.asarray(a), atol=atol,
                               rtol=rtol)


@pytest.mark.parametrize("name", ["quat_mul", "quat_rotate", "quat_to_matrix",
                                  "quat_from_matrix", "mul", "inverse",
                                  "relative", "exp", "log", "rotation_angle",
                                  "to_matrix"])
def test_se3_matches_jax(name):
    rng = np.random.default_rng(7)
    qa, qb = _quats(rng, 16), _quats(rng, 16)
    ta = rng.normal(size=(16, 3)).astype(np.float32)
    tb = rng.normal(size=(16, 3)).astype(np.float32)
    v = rng.normal(size=(16, 3)).astype(np.float32)
    xi = (0.5 * rng.normal(size=(16, 6))).astype(np.float32)
    J = lambda *a: tuple(jnp.asarray(x) for x in a)
    T = lambda *a: tuple(_t(x) for x in a)
    cases = {
        "quat_mul": lambda m, c: m.quat_mul(*c(qa, qb)),
        "quat_rotate": lambda m, c: m.quat_rotate(*c(qa, v)),
        "quat_to_matrix": lambda m, c: m.quat_to_matrix(*c(qa)),
        "quat_from_matrix": lambda m, c: m.quat_from_matrix(
            m.quat_to_matrix(*c(qa))),
        "mul": lambda m, c: m.mul(c(qa, ta), c(qb, tb)),
        "inverse": lambda m, c: m.inverse(c(qa, ta)),
        "relative": lambda m, c: m.relative(c(qa, ta), c(qb, tb)),
        "exp": lambda m, c: m.exp(*c(xi)),
        "log": lambda m, c: m.log(c(qa, ta)),
        "rotation_angle": lambda m, c: m.rotation_angle(*c(qa)),
        "to_matrix": lambda m, c: m.to_matrix(c(qa, ta)),
    }
    a = cases[name](jse3, J)
    b = cases[name](se3, T)
    for x, y in zip(a if isinstance(a, tuple) else (a,),
                    b if isinstance(b, tuple) else (b,)):
        _cmp(x, y, atol=1e-5 if name != "log" else 1e-4)


def _geo_pair(rng, batched):
    K = jcam.make_k(525.0, 520.0, 320.0, 240.0)
    Kinv = jcam.inv_k(K)
    n = 32 if batched else 1
    q = _quats(rng, n) * np.array([4, 0.1, 0.1, 0.1], np.float32)
    q = q / np.linalg.norm(q, axis=1, keepdims=True)
    t = (rng.normal(size=(n, 3)) * 0.3).astype(np.float32)
    if not batched:
        q, t = q[0], t[0]
        jg = jepi.load(K, Kinv, jnp.asarray(q), jnp.asarray(t))
    else:
        jg = jax.vmap(jepi.load, in_axes=(None, None, 0, 0))(
            K, Kinv, jnp.asarray(q), jnp.asarray(t))
    tg = epipolar.load(_t(K), _t(Kinv), _t(q), _t(t))
    return jg, tg


@pytest.mark.parametrize("batched", [False, True])
def test_epipolar_matches_jax(batched):
    rng = np.random.default_rng(11)
    jg, tg = _geo_pair(rng, batched)
    for f in ("q_ref_to_cmp", "t_ref_to_cmp", "t_cmp_to_ref", "KRKinv", "Kt"):
        _cmp(getattr(jg, f), getattr(tg, f), atol=1e-4, rtol=1e-5)
    u = rng.uniform(20, 600, (32, 2)).astype(np.float32)
    ids = rng.uniform(0.05, 1.0, 32).astype(np.float32)
    ids[:3] = 0.0
    disp = rng.uniform(1.0, 20.0, 32).astype(np.float32)
    ju, tu = jnp.asarray(u), _t(u)
    if batched:
        V = lambda f: jax.vmap(f)
    else:
        V = lambda f: f
    _cmp(V(jepi.max_depth_projection)(jg, ju),
         epipolar.max_depth_projection(tg, tu), atol=2e-3, rtol=1e-5)
    _cmp(V(jepi.min_depth_projection)(jg, ju),
         epipolar.min_depth_projection(tg, tu), atol=2e-3, rtol=1e-5)
    for a, b in zip(V(jepi.project_idepth)(jg, ju, jnp.asarray(ids)),
                    epipolar.project_idepth(tg, tu, _t(ids))):
        _cmp(a, b, atol=2e-3, rtol=1e-5)
    for a, b in zip(V(jepi.epiline)(jg, ju), epipolar.epiline(tg, tu)):
        _cmp(a, b, atol=2e-3, rtol=1e-5)
    _cmp(V(jepi.reference_epiline)(jg, ju),
         epipolar.reference_epiline(tg, tu))
    ui, ep = epipolar.epiline(tg, tu)
    jui, jep = V(jepi.epiline)(jg, ju)
    _cmp(V(jepi.disparity_to_idepth)(jg, ju, jui, jep, jnp.asarray(disp)),
         epipolar.disparity_to_idepth(tg, tu, ui, ep, _t(disp)),
         atol=ATOL, rtol=1e-4)


def test_compose_matches_jax():
    rng = np.random.default_rng(3)
    jg, tg = _geo_pair(rng, True)
    jg2, tg2 = _geo_pair(rng, False)
    a = jepi.compose(jg2, jg)
    b = epipolar.compose(tg2, tg)
    for f in ("q_ref_to_cmp", "t_ref_to_cmp", "KRKinv", "Kt", "epipole"):
        _cmp(getattr(a, f), getattr(b, f), atol=1e-3, rtol=1e-5)


# --- Closed-form fixtures (tests/test_se3.py, tests/test_epipolar.py). ---


def make_K(fx=525.0, fy=525.0, cx=320.0, cy=240.0):
    K = camera.make_k(fx, fy, cx, cy)
    return K, camera.inv_k(K)


def quat_about_y(a):
    return _t([np.cos(a / 2), 0.0, np.sin(a / 2), 0.0])


def quat_about_x(a):
    return _t([np.cos(a / 2), np.sin(a / 2), 0.0, 0.0])


def test_exp_log_round_trip():
    rng = np.random.default_rng(12345)
    xi = 0.5 * rng.normal(size=(64, 6)).astype(np.float32)
    _cmp(xi, se3.log(se3.exp(_t(xi))), atol=1e-4)


def test_log_small_angle_f32_stable():
    for eps in (1e-3, 3e-4, 1e-4, 1e-5, 1e-6):
        q = se3.quat_normalize(_t([1.0, eps, eps / 2, -eps / 3]))
        t = _t([0.1, -0.05, 0.02])
        xi = se3.log((q, t))
        assert torch.all(torch.abs(xi[:3]) < 1.0)
        _cmp(t, se3.exp(xi)[1], atol=1e-5)


@pytest.mark.parametrize("t,check", [
    ([2.0, 0, 0], lambda u: u[0] > 640 and abs(u[1] - 240) < 1e-3),
    ([-2.0, 0, 0], lambda u: u[0] < 0 and abs(u[1] - 240) < 1e-3),
    ([0.0, 2.0, 0], lambda u: u[1] > 480 and abs(u[0] - 320) < 1e-3),
])
def test_min_depth_projection_axis_translate(t, check):
    K, Kinv = make_K()
    geo = epipolar.load(K, Kinv, se3.quat_identity(), _t(t))
    assert check(epipolar.min_depth_projection(geo, _t([320.0, 240.0])))


@pytest.mark.parametrize("q,t,expected,atol", [
    ([0.999138, -0.000878, 0.041493, 0.000386],
     [-0.221092, -0.036134, 0.084099], [-1087.525391, 15.954912], 1e-2),
    ([-0.999853, 0.014856, -0.005249, -0.006822],
     [-0.258187, 0.040849, -0.054990],
     [187.65597534179688, 278.55392456054688], 1e-1),
])
def test_min_depth_projection_real_data(q, t, expected, atol):
    K = camera.make_k(535.43310546875, 539.212524414062, 320.106652814575,
                      247.632132204719)
    geo = epipolar.load(K, camera.inv_k(K), se3.quat_normalize(_t(q)), _t(t))
    _cmp(expected, epipolar.min_depth_projection(geo, _t([320.0, 240.0])),
         atol=atol)


@pytest.mark.parametrize("q,expected", [
    (quat_about_y(-np.pi / 6), [16.891090393066406, 240.0]),
    (quat_about_x(-np.pi / 6), [320.0, 543.10888671875]),
])
def test_max_depth_projection_rotation(q, expected):
    K, Kinv = make_K()
    geo = epipolar.load(K, Kinv, q, torch.zeros(3))
    _cmp(expected, epipolar.max_depth_projection(geo, _t([320.0, 240.0])),
         atol=1e-3)


@pytest.mark.parametrize("q_rl,t_rl,expected", [
    (quat_about_y(-np.pi / 3), [2.0, 0.0, 0.0], [1.0, 0.0]),
    (quat_about_x(np.pi / 3), [0.0, 2.0, 0.0], [0.0, 1.0]),
])
def test_epiline_rotated(q_rl, t_rl, expected):
    K, Kinv = make_K()
    q_lr = se3.quat_conj(q_rl)
    t_lr = -se3.quat_rotate(q_rl, _t(t_rl))
    geo = epipolar.load(K, Kinv, q_lr, t_lr)
    _cmp(expected, epipolar.epiline(geo, _t([320.0, 240.0]))[1], atol=1e-4)


def test_disparity_to_idepth_round_trip():
    K, Kinv = make_K()
    T1 = (quat_about_y(-np.pi / 12), torch.zeros(3))
    T2 = (se3.quat_identity(), _t([1.0, 0.0, 0.0]))
    p_world = _t([1.0, 0.0, 10.0])
    u1 = camera.project(K, se3.act(se3.inverse(T1), p_world))
    u2 = camera.project(K, se3.act(se3.inverse(T2), p_world))
    depth1 = float(se3.act(se3.inverse(T1), p_world)[2])
    geo = epipolar.load_relative(K, Kinv, T1, T2)
    disp, u_inf, epi = epipolar.disparity(geo, u1, u2)
    assert float(disp) > 0
    np.testing.assert_allclose(
        float(epipolar.disparity_to_idepth(geo, u1, u_inf, epi, disp)),
        1.0 / depth1, rtol=1e-3)
    np.testing.assert_allclose(
        float(epipolar.disparity_to_depth(geo, u1, u_inf, epi, disp)),
        depth1, rtol=1e-3)


def test_project_idepth_zero_maps_to_infinite():
    K, Kinv = make_K()
    geo = epipolar.load(K, Kinv, quat_about_y(0.2), _t([1.0, 0.0, 0.0]))
    u_ref = _t([100.0, 150.0])
    u_cmp, idn = epipolar.project_idepth(geo, u_ref, _t(0.0))
    _cmp(epipolar.max_depth_projection(geo, u_ref), u_cmp, atol=1e-4)
    assert float(idn) == 0.0
