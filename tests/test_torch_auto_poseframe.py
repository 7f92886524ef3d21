"""Automatic poseframes and the getters of flame_tpu_torch.Flame against
flame_tpu.Flame on tests/test_flame_e2e.py's plane (uint8 frames, 160x120,
512 features) on the CPU.

  * auto_poseframe (auto_pf_max_disparity=12, auto_pf_depth at the
    plane): update(is_poseframe=None) declares poseframes at the same
    frame ids as the JAX package, on the synchronous path and under async
    topology with frame_batch=4 (solver.deterministic=True, so both
    packages batch the same frames), where a poseframe buffered in a
    batch is the one later buffered frames compare against. Both runs
    hold test_auto_poseframe_selection's bounds.
  * The getters on the JAX run's final state given to the port through
    convert: get_filtered_inverse_depth_map covers exactly the same
    pixels, values within 1e-6; the detections and matches debug images
    have the same shape and dtype and the same count of pixels of each
    palette colour (the matches image exactly equal).
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import flame_tpu_torch  # noqa: E402
from flame_tpu.core.flame import Flame as JFlame  # noqa: E402
from flame_tpu.geometry import camera as jcam  # noqa: E402
from flame_tpu.params import (DetectionParams, Params,  # noqa: E402
                              SolverParams)
from flame_tpu_torch import convert  # noqa: E402
from flame_tpu_torch.core import frame as tframe  # noqa: E402

FX = 100.0
W, H = 160, 120
PLANE_Z = 5.0
TRUE_IDEPTH = 1.0 / PLANE_Z
N_FRAMES = 16


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this module's small CPU tensors: the test
    workers run side by side, and more threads only oversubscribe the
    cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def render(cam_x):
    vv, uu = np.mgrid[0:H, 0:W].astype(np.float64)
    X = (uu - W / 2) * PLANE_Z / FX + cam_x
    Y = (vv - H / 2) * PLANE_Z / FX
    tex = (128 + 60 * np.sin(4.1 * X + 0.9 * Y) + 35 * np.cos(1.73 * X)
           + 18 * np.sin(2.31 * Y) + 10 * np.sin(0.83 * X))
    return np.clip(tex, 0, 255).astype(np.uint8)


def make_params(batched):
    solver = (SolverParams(n_iters_per_frame=30, max_vertex_degree=16,
                           async_topology=True, frame_batch=4,
                           deterministic=True)
              if batched else
              SolverParams(n_iters_per_frame=30, max_vertex_degree=16))
    return Params(
        feature_capacity=512, edge_capacity=2048, triangle_capacity=1024,
        poseframe_capacity=8, min_height=-100.0, max_height=100.0,
        idepth_init=0.05, idepth_var_init=0.25, photo_error_num_pfs=0,
        detection=DetectionParams(win_size=16), solver=solver,
        auto_poseframe=True, auto_pf_max_disparity=12.0,
        auto_pf_depth=PLANE_Z, debug_quiet=True)


def _K():
    K = jcam.make_k(FX, FX, W / 2, H / 2)
    return K, jcam.inv_k(K)


def _run(fl, pose_arr):
    """Frame ids each update() declared a poseframe (None: the selector
    decides)."""
    declared = []
    for i in range(N_FRAMES):
        q = np.array([1.0, 0, 0, 0], np.float32)
        t = np.array([0.15 * i, 0, 0], np.float32)
        before = set(fl._pf_slot_by_id)
        fl.update(i * 0.1, i, (pose_arr(q), pose_arr(t)), render(0.15 * i),
                  None)
        declared += sorted(set(fl._pf_slot_by_id) - before)
    return declared


def _runs(batched):
    jp = make_params(batched)
    K, Kinv = _K()
    jf = JFlame(W, H, K, Kinv, jp)
    tf = flame_tpu_torch.Flame(W, H, np.array(K), np.array(Kinv),
                               convert.params_from_dict(
                                   dataclasses.asdict(jp)), device="cpu")
    return jf, tf, _run(jf, jnp.asarray), _run(tf, np.asarray)


@pytest.fixture(scope="module")
def sync_runs():
    return _runs(False)


@pytest.fixture(scope="module")
def batch4_runs():
    return _runs(True)


@pytest.mark.parametrize("mode", ["sync", "batch4"])
def test_auto_poseframes_at_the_same_frame_ids(mode, request):
    jf, tf, jpfs, tpfs = request.getfixturevalue(f"{mode}_runs")
    assert tpfs == jpfs
    # Probe at the image centre at 5 m: 3 px of disparity per frame, a
    # poseframe about every 4 frames after the first.
    assert 3 <= len(tpfs) <= 7, tpfs
    assert tpfs[0] == 0
    if mode == "batch4":
        assert tf._dispatches >= 1 and jf._dispatches == tf._dispatches
    for fl in (jf, tf):
        idm = fl.get_inverse_depth_map()
        assert np.mean(~np.isnan(idm)) > 0.3
    # Both mirrors hold the current poseframe's pose.
    np.testing.assert_array_equal(tf._curr_pf_pose_np[1],
                                  jf._curr_pf_pose_np[1])


def test_explicit_poseframes_bypass_the_selector():
    """is_poseframe given: the selector is not asked (no host copy of the
    pose is taken for it); the mirror follows the declared poseframes."""
    K, Kinv = _K()
    tf = flame_tpu_torch.Flame(W, H, np.array(K), np.array(Kinv),
                               convert.params_from_dict(dataclasses.asdict(
                                   make_params(False))), device="cpu")
    asked = []
    want = tf._want_poseframe
    tf._want_poseframe = lambda q, t: asked.append(1) or want(q, t)
    for i in range(4):
        tf.update(i * 0.1, i, (np.array([1.0, 0, 0, 0]),
                               np.array([0.15 * i, 0, 0])),
                  render(0.15 * i), i == 2)
    assert not asked and sorted(tf._pf_slot_by_id) == [2]
    np.testing.assert_allclose(tf._curr_pf_pose_np[1], [0.3, 0, 0],
                               rtol=0, atol=1e-7)


def _np(x):
    return {k: np.asarray(v) for k, v in x._asdict().items()}


@pytest.fixture(scope="module")
def given_state(sync_runs):
    """The synchronous JAX run's final state in a fresh port Flame."""
    jf = sync_runs[0]
    jf._ensure_tris()
    K, Kinv = _K()
    tp = convert.params_from_dict(dataclasses.asdict(jf.params))
    tf = flame_tpu_torch.Flame(W, H, np.array(K), np.array(Kinv), tp,
                               device="cpu")
    tf._graph = convert.graph_state_from_numpy(_np(jf._graph), "cpu")
    tf._stack = convert.frame_stack_from_numpy(_np(jf._stack), "cpu")
    tf._feats = convert.feature_state_from_numpy(_np(jf._feats), "cpu")
    tf._curr = convert.curr_features_from_numpy(_np(jf._curr), "cpu")
    tf._tris = torch.as_tensor(np.asarray(jf._tris)).long()
    tf._n_tris = jf._n_tris
    tf._tri_validity = torch.as_tensor(np.asarray(jf._tri_validity))
    tf._vtx_idepths = torch.as_tensor(np.asarray(jf._vtx_idepths))
    for name in ("_fnew", "_fprev"):
        f = getattr(jf, name)
        setattr(tf, name, tframe.create(
            int(f.frame_id), torch.as_tensor(np.asarray(f.q)),
            torch.as_tensor(np.asarray(f.t)),
            torch.as_tensor(np.asarray(f.img)), tp.pad))
    tf._pf_slot_by_id = dict(jf._pf_slot_by_id)
    tf._curr_pf_slot = jf._curr_pf_slot
    return jf, tf


def test_filtered_map_matches_jax(given_state):
    jf, tf = given_state
    a = jf.get_filtered_inverse_depth_map()
    b = tf.get_filtered_inverse_depth_map()
    np.testing.assert_array_equal(np.isnan(b), np.isnan(a))
    ok = ~np.isnan(a)
    np.testing.assert_allclose(b[ok], a[ok], rtol=0, atol=1e-6)
    assert 0.2 < ok.mean() <= np.mean(~np.isnan(
        jf.get_inverse_depth_map()))


def _colour_counts(img):
    cols, counts = np.unique(img.reshape(-1, 3), axis=0, return_counts=True)
    return {tuple(c): n for c, n in zip(cols.tolist(), counts.tolist())}


def test_debug_images_match_jax(given_state):
    jf, tf = given_state
    for name in ("detections", "matches"):
        a = getattr(jf, f"get_debug_image_{name}")()
        b = getattr(tf, f"get_debug_image_{name}")()
        assert b.shape == a.shape == (H, W, 3) and b.dtype == a.dtype \
            == np.uint8, name
    a, b = jf.get_debug_image_matches(), tf.get_debug_image_matches()
    np.testing.assert_array_equal(b, a)
    palette = [(255, 255, 255), (0, 255, 255), (255, 0, 0), (255, 255, 0)]
    counts = _colour_counts(b)
    assert sum(counts.get(c, 0) for c in palette) + sum(
        n for c, n in counts.items() if c[0] == 0 and c[1] + c[2] >= 254) \
        > 100
    a, b = jf.get_debug_image_detections(), tf.get_debug_image_detections()
    ca, cb = _colour_counts(a), _colour_counts(b)
    assert cb.get((255, 255, 255), 0) == ca.get((255, 255, 255), 0) > 0
    # The score map colours the same pixels: those where the image leaves
    # the grey of the frame.
    grey_a = (a[..., 0] == a[..., 1]) & (a[..., 1] == a[..., 2])
    grey_b = (b[..., 0] == b[..., 1]) & (b[..., 1] == b[..., 2])
    np.testing.assert_array_equal(grey_b, grey_a)
    assert (b != a).any(-1).mean() < 0.005
