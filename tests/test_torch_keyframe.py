"""Comparison-poseframe scoring of flame_tpu_torch (core/keyframe.py)
against flame_tpu.core.keyframe on the same seeded poses.

score_batch against score_jax over relative poses that include every
hard rejection (orientation past 60 degrees, image corners behind the
candidate, no overlap, a non-convex projected frustum) and plenty of
live scores; best_comparison_pose against the JAX one on seeded
poseframe stacks (8 slots, invalid and free slots, recency caps below
the number of candidates, tied scores).

Tolerance: the accept/reject decisions and the winning slot are exactly
equal; live scores agree to atol 1e-5 (float32 sums taken in another
order).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from flame_tpu.core import keyframe as jkf  # noqa: E402
from flame_tpu.geometry import camera as jcam  # noqa: E402
from flame_tpu_torch.core import keyframe  # noqa: E402

W, H = 160, 120
FX = 100.0
ATOL = 1e-5


def _K():
    K = np.array(jcam.make_k(FX, FX, W / 2, H / 2), np.float32)
    return K, np.array(jcam.inv_k(K), np.float32)


def _quat(axis, ang):
    axis = np.asarray(axis, np.float64)
    axis = axis / np.linalg.norm(axis)
    return np.array([np.cos(ang / 2), *(np.sin(ang / 2) * axis)])


def _poses(seed, n=64):
    """Crafted rejections first, then seeded poses from a broad range."""
    qs = [_quat([0, 1, 0], np.pi / 2),  # 90 deg yaw: orientation
          _quat([0, 1, 0], 0.0),  # camera 60 m back: corners behind
          _quat([0, 1, 0], 0.0),  # 200 m sideways: no overlap
          _quat([0, 1, 0], 0.9)]  # 52 deg yaw, 45 m back: non-convex
    ts = [np.zeros(3), np.array([0, 0, -60.0]), np.array([200.0, 0, 0]),
          np.array([0, 0, -45.0])]
    rng = np.random.default_rng(seed)
    for _ in range(n - len(qs)):
        qs.append(_quat(rng.normal(size=3), rng.uniform(-1.6, 1.6)))
        ts.append(rng.normal(size=3) * rng.choice([0.3, 5.0, 40.0]))
    return (np.asarray(qs, np.float32), np.asarray(ts, np.float32))


def _jax_scores(K, Kinv, qs, ts):
    return np.asarray(jax.vmap(lambda q, t: jkf.score_jax(
        W, H, jnp.asarray(K), jnp.asarray(Kinv), q, t))(
            jnp.asarray(qs), jnp.asarray(ts)))


def _corners_cam(K, Kinv, q, t):
    """Image corners at depth 50 in the candidate camera (numpy, f64)."""
    c = np.array([[0, 0, 1], [0, H - 1, 1], [W - 1, H - 1, 1], [W - 1, 0, 1]],
                 np.float64)
    w, x, y, z = q.astype(np.float64)
    R = np.array([[1 - 2 * (y * y + z * z), 2 * (x * y - w * z),
                   2 * (x * z + w * y)],
                  [2 * (x * y + w * z), 1 - 2 * (x * x + z * z),
                   2 * (y * z - w * x)],
                  [2 * (x * z - w * y), 2 * (y * z + w * x),
                   1 - 2 * (x * x + y * y)]])
    return (50.0 * c @ Kinv.T.astype(np.float64)) @ R.T + t


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_score_batch_matches_score_jax(seed):
    K, Kinv = _K()
    qs, ts = _poses(seed)
    want = _jax_scores(K, Kinv, qs, ts)
    got = keyframe.score_batch(
        W, H, torch.as_tensor(K), torch.as_tensor(Kinv), torch.as_tensor(qs),
        torch.as_tensor(ts)).numpy()
    low = keyframe.SCORE_LOWEST / 2
    np.testing.assert_array_equal(got <= low, want <= low)
    live = want > low
    assert live.sum() >= 10 and (~live).sum() >= 8
    np.testing.assert_allclose(got[live], want[live], rtol=0, atol=ATOL)

    # Every kind of rejection is in the sample.
    cos30 = np.cos(np.radians(30.0))
    orient = np.abs(qs[:, 0]) < cos30 - 1e-4
    behind = np.array([(_corners_cam(K, Kinv, q, t)[:, 2] <= 0).any()
                       for q, t in zip(qs, ts)])
    assert orient.any() and behind.any()
    assert not live[2]  # in front, upright, no overlap
    p = _corners_cam(K, Kinv, qs[3], ts[3]) @ K.T.astype(np.float64)
    poly = p[:, :2] / p[:, 2:3]
    e1 = np.roll(poly, -1, 0) - poly
    e2 = np.roll(poly, -2, 0) - np.roll(poly, -1, 0)
    cr = e1[:, 0] * e2[:, 1] - e1[:, 1] * e2[:, 0]
    assert (cr > 0).any() and (cr < 0).any()  # non-convex
    assert not live[3]


def _stack(seed):
    rng = np.random.default_rng(seed)
    F = 8
    qs, ts = _poses(seed + 10, n=F + 4)
    q = qs[4:].copy()
    t = (ts[4:] * 0.02).astype(np.float32)  # mostly overlapping views
    fid = rng.permutation(40)[:F].astype(np.int32)
    valid = rng.uniform(size=F) > 0.2
    fid[rng.integers(F)] = -1  # a free slot
    if seed % 2:  # two slots with the same pose: a tie
        q[5], t[5] = q[6], t[6]
        valid[5] = valid[6] = True
    ref = int(rng.integers(F))
    valid[ref] = True
    return q, t, fid, valid, ref


@pytest.mark.parametrize("seed", [0, 1, 2, 3, 4, 5])
@pytest.mark.parametrize("max_pfs", [2, 3, 30])
def test_best_comparison_pose_matches_jax(seed, max_pfs):
    K, Kinv = _K()
    q, t, fid, valid, ref = _stack(seed)
    jq, jt, jok = jkf.best_comparison_pose(
        W, H, jnp.asarray(K), jnp.asarray(Kinv), jnp.asarray(q),
        jnp.asarray(t), jnp.asarray(fid), jnp.asarray(valid), ref, max_pfs)
    tq, tt, tok = keyframe.best_comparison_pose(
        W, H, torch.as_tensor(K), torch.as_tensor(Kinv), torch.as_tensor(q),
        torch.as_tensor(t), torch.as_tensor(fid), torch.as_tensor(valid),
        ref, max_pfs)
    assert bool(tok) == bool(jok)
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))


def test_best_comparison_pose_without_candidates():
    K, Kinv = _K()
    q, t, fid, valid, ref = _stack(0)
    valid[:] = False
    valid[ref] = True
    _, _, ok = keyframe.best_comparison_pose(
        W, H, torch.as_tensor(K), torch.as_tensor(Kinv), torch.as_tensor(q),
        torch.as_tensor(t), torch.as_tensor(fid), torch.as_tensor(valid),
        ref, 30)
    assert not bool(ok)
