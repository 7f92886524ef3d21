"""flame_tpu_torch.utils.checkpoint on the CPU: tests/test_checkpoint.py's
three tests on the port (tests/test_flame_e2e.py's plane, 160x120, 512
features).

  * round trip: the restored instance gives identical maps and raw
    idepths and keeps processing;
  * save mid-batch under frame_batch=4 with BA (a solve cadence of 3 new
    poseframes) and solver.deterministic=True, after a prune that leaves
    the free poseframe slots out of order, at a point where the cadence
    counter and the snapshot's dirty flag decide when the next solve
    stages: the saved-and-continued run and the restored-and-continued
    run stay bit-equal through that solve;
  * load over an instance with transfers in flight keeps them as zombies.
"""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import flame_tpu_torch  # noqa: E402
from flame_tpu_torch import (BAParams, DetectionParams, Params,  # noqa: E402
                             SolverParams)
from flame_tpu_torch.utils import checkpoint  # noqa: E402

FX = 100.0
W, H = 160, 120
PLANE_Z = 5.0
K = np.array([[FX, 0, W / 2], [0, FX, H / 2], [0, 0, 1]], np.float32)
KINV = np.linalg.inv(K.astype(np.float64)).astype(np.float32)


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


def make_params(**kw):
    return Params(
        feature_capacity=512, edge_capacity=2048, triangle_capacity=1024,
        poseframe_capacity=8, min_height=-100.0, max_height=100.0,
        idepth_init=0.05, idepth_var_init=0.25,
        detection=DetectionParams(win_size=16),
        solver=SolverParams(n_iters_per_frame=30, max_vertex_degree=16,
                            **kw.pop("solver", {})),
        debug_quiet=True, **kw)


def flame(params):
    return flame_tpu_torch.Flame(W, H, K, KINV, params, device="cpu")


def run_frames(fl, start, stop, pf=lambda i: i % 2 == 0):
    for i in range(start, stop):
        fl.update(i * 0.1, i, (np.array([1.0, 0, 0, 0], np.float32),
                               np.array([0.15 * i, 0, 0], np.float32)),
                  render(0.15 * i), pf(i))


def test_checkpoint_round_trip(tmp_path):
    params = make_params()
    fl = flame(params)
    run_frames(fl, 0, 8)
    path = os.path.join(tmp_path, "ckpt.npz")
    checkpoint.save(path, fl)

    fl2 = flame(params)
    checkpoint.load(path, fl2)
    np.testing.assert_array_equal(fl2.get_inverse_depth_map(),
                                  fl.get_inverse_depth_map())
    for a, b in zip(fl.get_raw_idepths(), fl2.get_raw_idepths()):
        np.testing.assert_array_equal(a, b)
    assert fl2.num_data_updates == fl.num_data_updates
    assert fl2._pf_slot_by_id == fl._pf_slot_by_id
    assert fl2.failure_stats() == fl.failure_stats()

    run_frames(fl2, 8, 11)
    assert fl2.num_data_updates > fl.num_data_updates
    assert np.mean(~np.isnan(fl2.get_inverse_depth_map())) > 0.2

    # A Flame of another size or capacity refuses the checkpoint.
    with pytest.raises(ValueError):
        checkpoint.load(path, flame(params.replace(feature_capacity=256)))


def _state(fl):
    """Every array of the state that a continued run computes from."""
    g, f = fl._graph, fl._feats
    return [fl.get_inverse_depth_map(), f.idepth_mu.numpy(),
            f.idepth_var.numpy(), f.xy.numpy(), g.x.numpy(), g.q1.numpy(),
            fl._stack.q.numpy(), fl._stack.t.numpy()]


def test_checkpoint_midbatch_ba_bit_equal_resume(tmp_path):
    params = make_params(
        do_ba=True,
        ba=BAParams(window_size=8, n_gn_iters=2, obs_capacity=2048,
                    max_landmarks=256, max_obs=512, solve_min_new_pfs=3),
        solver=dict(frame_batch=4, async_topology=True, deterministic=True))
    fl = flame(params)
    run_frames(fl, 0, 13)  # one frame buffered mid-batch
    assert fl._batch_pending
    # The free slots' order feeds later allocations: prune several
    # poseframes (which flushes frame 12, the current poseframe).
    fl.prune_poseframes(sorted(fl._pf_slot_by_id)[-3:] + [12])
    assert len(fl._pf_free) >= 2 and fl._pf_free != sorted(fl._pf_free)
    run_frames(fl, 13, 17)
    # A second prune just before the save leaves the free list out of
    # order there (the allocations since the first consumed its tail).
    fl.prune_poseframes(sorted(fl._pf_slot_by_id)[-3:])
    run_frames(fl, 17, 19)
    assert fl._batch_pending and fl._dispatches > 0
    path = os.path.join(tmp_path, "ckpt_mid.npz")
    checkpoint.save(path, fl)
    assert not fl._batch_pending and not fl._packed_queue
    assert fl._ba._inflight is None and len(fl._ba.store) > 0
    assert 0 < fl._ba._new_pf_count < 3 and fl._ba._snap_dirty
    assert len(fl._pf_free) >= 2 and fl._pf_free != sorted(fl._pf_free)
    n_solves = fl.stats.stats("ba_single_solves")
    assert n_solves >= 1

    fl2 = flame(params)
    checkpoint.load(path, fl2)
    assert len(fl2._ba.store) == len(fl._ba.store)
    assert fl2._pf_free == fl._pf_free
    for a, b in zip(_state(fl), _state(fl2)):
        np.testing.assert_array_equal(a, b)

    run_frames(fl, 19, 28)
    run_frames(fl2, 19, 28)
    for a, b in zip(_state(fl), _state(fl2)):
        np.testing.assert_array_equal(a, b)
    assert len(fl._ba.store) == len(fl2._ba.store)
    assert fl.stats.stats("ba_single_solves") > n_solves
    assert fl2.stats.stats("ba_single_solves") \
        == fl.stats.stats("ba_single_solves")
    assert np.mean(~np.isnan(fl2.get_inverse_depth_map())) > 0.2


def test_restore_tracks_inflight_transfers_as_zombies(tmp_path):
    params = make_params()
    fl = flame(params)
    run_frames(fl, 0, 8)
    path = os.path.join(tmp_path, "ckpt.npz")
    checkpoint.save(path, fl)

    fl2 = flame(params)

    class StuckFetch:
        t_done = None

        def ready(self):
            return False

    fl2._packed_queue.append((StuckFetch(), 3, ([3], [False]), [None]))
    fl2._packed_queue.append((StuckFetch(), 4, ([4], [False]), [None]))
    fl2._sheds_since_consume = 7
    # A latency sample of fl2's own run: frame 99's update span and its
    # snapshot's landing.
    with fl2.stats.span("update", frames=(99,)):
        pass

    class Landed:
        t_start = t_done = 1e-9 * fl2.stats.spans.spans()[-1].end_ns

    fl2._note_latency(Landed(), [99])
    assert fl2.latency_percentiles() is not None
    checkpoint.load(path, fl2)

    assert not fl2._packed_queue
    assert len(fl2._zombie_fetches) == 2
    assert fl2._in_flight_fetches() == 2
    assert fl2._sheds_since_consume == 0
    assert fl2.latency_percentiles() is None
    run_frames(fl2, 8, 10)
    assert fl2.num_data_updates == fl.num_data_updates + 2
