"""The throughput path as a whole: the tests/test_flame_e2e.py scene
(160x120, 512 features) for 20 frames through flame_tpu.Flame and
flame_tpu_torch.Flame on the CPU with async_topology=True,
frame_batch=4, deterministic=True (every snapshot and triangulation
joined at once: the same schedule in both packages),
photo_error_num_pfs=30 and poseframe_capacity=4, so that poseframe
eviction fires. Frames go in as numpy uint8 ("host") and, in a second
pair of runs, as device-resident uint8 arrays: jax arrays for the JAX
package, CPU tensors standing in for device frames for the port.

Held per pair: the same update() booleans and the same number of
batched steps; the tests/test_flame_e2e.py bounds for both; final dense
maps covering the same pixels (IoU >= 0.95) with median |d idepth| /
idepth <= 1e-2 where both cover. Trajectories are held to bounds rather
than to bit-equality: match decisions flip on float noise."""

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
from flame_tpu_torch import _kernels, convert  # noqa: E402

FX = 100.0
W, H = 160, 120
PLANE_Z = 5.0
TRUE_IDEPTH = 1.0 / PLANE_Z
N_FRAMES = 20


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
        poseframe_capacity=4, min_height=-100.0, max_height=100.0,
        idepth_init=0.05, idepth_var_init=0.25, photo_error_num_pfs=30,
        detection=DetectionParams(win_size=16),
        solver=SolverParams(n_iters_per_frame=30, max_vertex_degree=16,
                            async_topology=True, frame_batch=4,
                            deterministic=True),
        debug_quiet=True)


def _run(mode):
    jp = make_params()
    K = jcam.make_k(FX, FX, W / 2, H / 2)
    Kinv = jcam.inv_k(K)
    jf = JFlame(W, H, K, Kinv, jp)
    tf = flame_tpu_torch.Flame(W, H, np.array(K), np.array(Kinv),
                               convert.params_from_dict(
                                   dataclasses.asdict(jp)), device="cpu")
    launches = dict(_kernels.LAUNCHES)
    jr, tr = [], []
    for i in range(N_FRAMES):
        q = np.array([1.0, 0, 0, 0], np.float32)
        t = np.array([0.15 * i, 0, 0], np.float32)
        img = render(0.15 * i)
        jimg = img if mode == "host" else jnp.asarray(img)
        timg = img if mode == "host" else torch.as_tensor(img)
        jr.append(jf.update(i * 0.1, i, (jnp.asarray(q), jnp.asarray(t)),
                            jimg, i % 2 == 0))
        tr.append(tf.update(i * 0.1, i, (q, t), timg, i % 2 == 0))
    assert _kernels.LAUNCHES == launches  # CPU tensors never launch
    return jf, tf, jr, tr


@pytest.fixture(scope="module", params=["host", "resident"])
def runs(request):
    return _run(request.param)


def test_same_booleans_and_schedule(runs):
    jf, tf, jr, tr = runs
    assert jr == tr
    assert all(tr[6:])
    assert tf._dispatches == jf._dispatches >= 3  # batches ran
    # Poseframes 0, 2, .., 16 through four slots (18 is still buffered):
    # both packages evicted the same ones.
    assert sorted(tf._pf_slot_by_id) == sorted(jf._pf_slot_by_id)
    assert tf.stats.stats("pf_evictions") == 5
    assert tf.latency_percentiles() is not None


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
    assert not tf._batch_pending and not jf._batch_pending  # flushed


def test_stack_maps_are_per_frame(runs):
    """Each resident poseframe holds its own dense map, as in the JAX
    package (frames of one batch see the scene from different places)."""
    jf, tf, _, _ = runs
    for fid, slot in tf._pf_slot_by_id.items():
        jm = np.asarray(jf._stack.idepthmap[jf._pf_slot_by_id[fid]])
        tm = tf._stack.idepthmap[slot].numpy()
        cj, ct = ~np.isnan(jm), ~np.isnan(tm)
        if cj.sum() == 0:
            assert ct.sum() == 0
            continue
        assert (cj & ct).sum() / (cj | ct).sum() >= 0.9, fid


def test_pose_update_and_prune(runs):
    """The external hooks on both final states (the last test of the
    module: it changes the state): a nudged poseframe pose lands in the
    stack, and pruning all but the newest two poseframes leaves the same
    survivors in both packages with re-anchored features alive."""
    jf, tf, _, _ = runs
    ids = sorted(tf._pf_slot_by_id)
    assert ids == sorted(jf._pf_slot_by_id) and len(ids) >= 3
    q = np.array([1.0, 0, 0, 0], np.float32)
    t = np.array([0.15 * ids[0], 0.0, 1e-4], np.float32)
    jf.update_poseframe_poses({ids[0]: (jnp.asarray(q), jnp.asarray(t))})
    tf.update_poseframe_poses({ids[0]: (q, t), 10 ** 6: (q, t)})  # unknown
    slot = tf._pf_slot_by_id[ids[0]]
    np.testing.assert_array_equal(tf._stack.t[slot].numpy(), t)
    np.testing.assert_array_equal(
        np.asarray(jf._stack.t[jf._pf_slot_by_id[ids[0]]]), t)
    with pytest.raises(ValueError):  # the current poseframe must stay
        tf.prune_poseframes(ids[:2])
    jf.prune_poseframes(ids[-2:])
    tf.prune_poseframes(ids[-2:])
    assert sorted(tf._pf_slot_by_id) == sorted(jf._pf_slot_by_id) == ids[-2:]
    assert sorted(tf._pf_free) == sorted(jf._pf_free)
    n_valid = int(tf._feats.valid.sum())
    assert n_valid == tf._n_valid > 10  # the mirror refreshed
    assert bool(torch.all(tf._stack.valid[tf._feats.pf_slot[
        tf._feats.valid]]))  # every live feature anchors in a live slot
