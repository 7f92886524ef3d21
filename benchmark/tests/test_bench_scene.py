"""The scene generator is deterministic in the seed, and its ray-cast
inverse depth matches values computed by hand."""

import copy
import json
import os

import numpy as np
import pytest
import torch

import bench_tiny
from scenes import box_room

ZERO_TRAJ = dict(center=[0.0, 0.0, 0.0], amp_m=[0.0, 0.0, 0.0],
                 cycles=[1, 1, 1], phase=[0.0, 0.0, 0.0], yaw_amp_deg=0.0,
                 yaw_cycles=1, yaw_phase=0.0, pitch_amp_deg=0.0,
                 pitch_cycles=1, pitch_phase=0.0)


def _cfg(name="tum_fr1_vga"):
    with open(os.path.join(bench_tiny.BENCH_DIR, "configs",
                           name + ".json")) as f:
        return json.load(f)


def _small(cfg):
    c = copy.deepcopy(cfg)
    c["camera"].update(bench_tiny.TINY_CAMERA)
    return c


@pytest.mark.parametrize("name", ["tum_fr1_vga"])
def test_deterministic_in_seed(name):
    cfg = _small(_cfg(name))
    seed = 2 ** 31 + 123
    a, da = box_room.Scene(cfg, "cpu").render([0, 5])
    b, db = box_room.Scene(cfg, "cpu").render([0, 5])
    other = copy.deepcopy(cfg)
    other["scene"]["texture"]["seed"] += 1
    c, _ = box_room.Scene(other, "cpu").render([0, 5])
    assert torch.equal(a, b) and torch.equal(da, db)
    assert not torch.equal(a, c)
    assert a.dtype == torch.uint8 and 20 < float(a.float().std()) < 60
    start = box_room.start_frame(cfg, seed)
    assert start == box_room.start_frame(cfg, seed)
    assert 0 <= start < box_room.period_frames(cfg)
    pa = box_room.noisy_poses(cfg, 6, 0.015, 0.3, seed, start)
    pb = box_room.noisy_poses(cfg, 6, 0.015, 0.3, seed, start)
    assert all(np.array_equal(x[1], y[1]) for x, y in zip(pa, pb))
    p0 = box_room.noisy_poses(cfg, 6, 0.0, 0.0, seed, start)
    assert np.array_equal(p0[3][1], box_room.true_pose(cfg, start + 3)[1])


def test_period_and_motion():
    cfg = _cfg()
    assert box_room.period_frames(cfg) == 300
    q0, t0 = box_room.true_pose(cfg, 0)
    q1, t1 = box_room.true_pose(cfg, 300)
    assert np.allclose(t0, t1) and np.allclose(q0, q1)
    speed, rate = box_room.motion_stats(cfg)
    assert 0.38 < speed < 0.44 and 20 < rate < 26  # fr1/desk's motion


def test_depth_by_hand():
    """Camera at the origin looking down +z in the box x [-1, 1], y
    [-0.5, 0.5], z [-10, 5]; fx = fy = 4, principal point (4, 3)."""
    cfg = _cfg()
    cfg["camera"].update(width=8, height=6, fx=4.0, fy=4.0, cx=4.0, cy=3.0)
    cfg["scene"]["box"] = {"x": [-1.0, 1.0], "y": [-0.5, 0.5],
                           "z": [-10.0, 5.0]}
    cfg["scene"]["trajectory"] = ZERO_TRAJ
    _, idepth = box_room.Scene(cfg, "cpu").render([0])
    d = idepth[0].double()
    # (4, 3): ray (0, 0, 1) meets the far wall z = 5.
    assert d[3, 4] == pytest.approx(1 / 5.0, rel=1e-6)
    # (0, 3): ray (-1, 0, 1) meets the wall x = -1 at depth 1.
    assert d[3, 0] == pytest.approx(1.0, rel=1e-6)
    # (4, 0): ray (0, -0.75, 1) meets the ceiling y = -0.5 at 0.5 / 0.75.
    assert d[0, 4] == pytest.approx(0.75 / 0.5, rel=1e-6)
    # (7, 5): ray (0.75, 0.5, 1) meets x = 1 at depth 4/3 before y = 0.5
    # at depth 1: the floor first.
    assert d[5, 7] == pytest.approx(1.0, rel=1e-6)
