"""The dataset path as a whole: mini-TUM (24 frames, 256x192, fx=210, pose
noise 15 mm / 0.3 deg, the configuration of tests/test_dataset_accuracy.py
that DATASETS.md measures) through io.datasets.load_tum + run_sequence
into flame_tpu.Flame and flame_tpu_torch.Flame on the CPU.

- First-frame stages with eager JAX: the state of the JAX run after
  frames 0-4 goes through one tracking step (frame 5, BA's widened
  transfer included) in both packages; held as the stage tests hold
  tracking (a few flipped decisions, values within 1e-4 elsewhere), and
  the decoded BA snapshots agree.
- Whole runs are held to bounds, not to bit-equality (match decisions
  flip on float noise): true poses meet DATASETS.md's bounds (coverage >
  0.35, median relative error < 0.04); on the noisy poses the port's BA
  cuts its ATE below 0.8x its no-BA ATE and stays within 1.25x of the JAX
  package's BA ATE; BA on exact poses skips write-backs and keeps the map
  within 1.5x of the BA-off error.
- run_dataset (python -m flame_tpu_torch.run_dataset --cpu --ba) writes
  its two renders."""

import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import flame_tpu_torch  # noqa: E402
from flame_tpu.ba import window as jwindow  # noqa: E402
from flame_tpu.core import frame as jframe  # noqa: E402
from flame_tpu.core.flame import Flame as JFlame  # noqa: E402
from flame_tpu.core import pipeline as jpipe  # noqa: E402
from flame_tpu_torch import convert  # noqa: E402
from flame_tpu_torch.ba import window  # noqa: E402
from flame_tpu_torch.core import frame as tframe  # noqa: E402
from flame_tpu_torch.core import pipeline  # noqa: E402
from flame_tpu_torch.geometry import camera  # noqa: E402
from flame_tpu_torch.io import datasets, synthetic  # noqa: E402
from flame_tpu_torch.utils import evaluation  # noqa: E402

from test_dataset_accuracy import (FX, H, N_FRAMES, W,  # noqa: E402
                                   make_params, pf_poses, run_tum)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MAX_FLIPS = 0.05


@pytest.fixture(scope="module")
def mini_tum(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("mini_tum"))
    meta = synthetic.generate_mini_tum(
        root, n_frames=N_FRAMES, width=W, height=H, fx=FX,
        pose_noise_t=0.015, pose_noise_deg=0.3, noise_seed=1)
    _, gt_idm = synthetic.render_frame(
        meta["K"], *synthetic.trajectory(N_FRAMES - 1), W, H)
    return root, meta, gt_idm


def run_port(root, poses=None, do_ba=False):
    frames = datasets.load_tum(root, max_frames=N_FRAMES)
    assert len(frames) == N_FRAMES
    if poses is not None:
        for fr, (q, t) in zip(frames, poses):
            fr.q = np.asarray(q, np.float32)
            fr.t = np.asarray(t, np.float32)
    K = camera.make_k(FX, FX, W / 2, H / 2)
    fl = flame_tpu_torch.Flame(
        W, H, K, camera.inv_k(K),
        convert.params_from_dict(dataclasses.asdict(make_params(do_ba))),
        device="cpu")
    datasets.run_sequence(fl, frames, poseframe_every=2)
    return fl


def port_ate(fl, gt):
    ids = sorted(fl._pf_slot_by_id)
    t = fl._stack.t[[fl._pf_slot_by_id[i] for i in ids]].numpy()
    return ids, evaluation.ate_rmse(t, np.asarray([gt[i][1] for i in ids]))


@pytest.fixture(scope="module")
def runs(mini_tum):
    root, meta, _ = mini_tum
    noisy = meta["noisy"]
    return dict(true=run_port(root), true_ba=run_port(root, do_ba=True),
                noisy=run_port(root, noisy), noisy_ba=run_port(root, noisy,
                                                               True),
                jax_noisy_ba=run_tum(root, poses=noisy, do_ba=True))


def _np(x):
    return {k: np.asarray(v) for k, v in x._asdict().items()}


def test_first_tracking_step_matches_eager_jax(mini_tum):
    root, meta, _ = mini_tum
    frames = datasets.load_tum(root, max_frames=6)
    for fr, (q, t) in zip(frames, meta["noisy"]):
        fr.q, fr.t = np.asarray(q, np.float32), np.asarray(t, np.float32)
    jp = make_params(do_ba=True)
    K = np.array(camera.make_k(FX, FX, W / 2, H / 2))
    Kinv = np.array(camera.inv_k(torch.as_tensor(K)))
    jf = JFlame(W, H, jnp.asarray(K), jnp.asarray(Kinv), jp)
    for i, fr in enumerate(frames[:5]):
        jf.update(fr.time, fr.frame_id, (fr.q, fr.t), fr.load_image(),
                  i % 2 == 0)
    assert jf._n_valid > 50
    fr = frames[5]
    img = fr.load_image()
    slot = jf._curr_pf_slot
    jfn = jframe.create(5, jnp.asarray(fr.q), jnp.asarray(fr.t),
                        jnp.asarray(img), jp.pad)
    with jax.disable_jit():
        jout = jpipe.track_step(jp, jnp.asarray(K), jnp.asarray(Kinv),
                                jf._stack, jf._feats, jfn, slot,
                                jf._fnew.q, jf._fnew.t, False, 0,
                                jf._idepthmap)
    tp = convert.params_from_dict(dataclasses.asdict(jp))
    tstack = convert.frame_stack_from_numpy(_np(jf._stack), "cpu")
    tfn = tframe.create(5, torch.as_tensor(fr.q), torch.as_tensor(fr.t),
                        torch.as_tensor(img), tp.pad)
    tout = pipeline.track_step(
        tp, torch.as_tensor(K), torch.as_tensor(Kinv), tstack,
        convert.feature_state_from_numpy(_np(jf._feats), "cpu"), tfn, slot,
        torch.tensor(np.asarray(jf._fnew.q)),
        torch.tensor(np.asarray(jf._fnew.t)), False, 0,
        torch.tensor(np.asarray(jf._idepthmap)))
    jfe, tfe = jout[0], tout[0]
    jv, tv = np.asarray(jfe.valid), tfe.valid.numpy()
    assert (jv != tv).mean() <= MAX_FLIPS
    jmu, tmu = np.asarray(jfe.idepth_mu), tfe.idepth_mu.numpy()
    close = np.isclose(tmu, jmu, rtol=1e-4, atol=1e-6)
    assert (~close[jv & tv]).mean() <= MAX_FLIPS

    # BA's widened transfer: the same layout, the same snapshot.
    jarr, tarr = np.asarray(jout[5]), tout[5].numpy()
    assert tarr.shape == jarr.shape and tarr.dtype == jarr.dtype
    jpk, js = jwindow.split_packed(jp, jarr)
    tpk, ts = window.split_packed(tp, tarr)
    assert js["uo"].shape[0] == ts["uo"].shape[0] == 1
    for k in ("stack_fid", "stack_q", "stack_t"):
        np.testing.assert_array_equal(ts[k], js[k])
    both = jv & tv
    for k in ("feat_id", "pf_slot"):
        np.testing.assert_array_equal(ts[k][both], js[k][both])
    jok = js["uo"][0, :, 0] != jpipe.PACK_BA_FAIL
    tok = ts["uo"][0, :, 0] != pipeline.PACK_BA_FAIL
    assert jok.sum() > 50 and (jok != tok).mean() <= MAX_FLIPS
    agree = jok & tok & close
    assert np.abs(ts["uo"][0][agree].astype(int)
                  - js["uo"][0][agree].astype(int)).max() <= 1
    assert np.abs(ts["xy"][both].astype(int)
                  - js["xy"][both].astype(int)).max() <= 1
    assert (np.abs(tpk[:, 2].astype(int) - jpk[:, 2].astype(int)) > 0) \
        .mean() <= MAX_FLIPS


def test_true_poses_meet_dataset_bounds(runs, mini_tum):
    stats = evaluation.depth_error_stats(
        runs["true"].get_inverse_depth_map(), mini_tum[2])
    assert stats["coverage"] > 0.35, stats
    assert stats["median_rel"] < 0.04, stats


def test_ba_cuts_ate_and_tracks_jax(runs, mini_tum):
    gt = mini_tum[1]["gt"]
    ids_n, ate_noisy = port_ate(runs["noisy"], gt)
    ids_b, ate_ba = port_ate(runs["noisy_ba"], gt)
    jids, _, jt = pf_poses(runs["jax_noisy_ba"])
    ate_jax = evaluation.ate_rmse(jt, np.asarray([gt[i][1] for i in jids]))
    assert ids_b == ids_n == jids
    assert ate_noisy > 0.005, ate_noisy
    assert ate_ba < 0.8 * ate_noisy, (ate_ba, ate_noisy)
    assert ate_ba < 1.25 * ate_jax, (ate_ba, ate_jax)
    st = runs["noisy_ba"].stats
    assert st.stats("ba_solves_applied") >= 1
    assert st.stats("ba_single_solves") == \
        runs["jax_noisy_ba"].stats.stats("ba_single_solves")


def test_ba_on_exact_poses_keeps_depth_quality(runs, mini_tum):
    s_off = evaluation.depth_error_stats(
        runs["true"].get_inverse_depth_map(), mini_tum[2])
    s_ba = evaluation.depth_error_stats(
        runs["true_ba"].get_inverse_depth_map(), mini_tum[2])
    assert runs["true_ba"].stats.stats("ba_writeback_skips") > 0
    assert s_ba["median_rel"] < max(1.5 * s_off["median_rel"], 0.005), \
        (s_ba, s_off)


def test_quiesce_drains_the_solve_in_flight(mini_tum):
    """quiesce() applies the solve in flight and any it stages next, so
    nothing is left in flight (what a checkpoint needs)."""
    root, meta, _ = mini_tum
    frames = datasets.load_tum(root, max_frames=12)
    K = camera.make_k(FX, FX, W / 2, H / 2)
    fl = flame_tpu_torch.Flame(
        W, H, K, camera.inv_k(K),
        convert.params_from_dict(dataclasses.asdict(make_params(True))),
        device="cpu")
    staged = fl._ba._stage_solve
    fl._ba._stage_solve = lambda f: None  # hold new solves back ...
    datasets.run_sequence(fl, frames, poseframe_every=2)
    fl._ba._stage_solve = staged
    assert fl._ba._snap_dirty and fl._ba._inflight is None
    fl._ba.step(fl)  # ... then stage one, left in flight
    assert fl._ba._inflight is not None
    fl._ba.quiesce(fl)
    assert fl._ba._inflight is None
    assert fl.stats.stats("ba_single_solves") >= 1
    assert fl.stats.stats("ba_solves_applied") >= 1


def test_debug_images(runs):
    fl = runs["noisy_ba"]
    idm = fl.get_inverse_depth_map()
    for name in ("wireframe", "features", "idepthmap", "normals"):
        img = getattr(fl, f"get_debug_image_{name}")()
        assert img.shape == (H, W, 3) and img.dtype == np.uint8, name
    over = fl.get_debug_image_idepthmap()
    gray = fl._gray()
    ok = np.isfinite(idm) & (idm > 0)
    assert (over[ok] != gray[ok][:, None]).any(axis=1).mean() > 0.9
    np.testing.assert_array_equal(over[~ok], np.repeat(gray[~ok, None], 3, 1))


def test_run_dataset_writes_renders(mini_tum, tmp_path):
    out = tmp_path / "out"
    env = dict(os.environ, PYTHONPATH=REPO)
    subprocess.run(
        [sys.executable, "-m", "flame_tpu_torch.run_dataset", "--format",
         "tum", "--root", mini_tum[0], "--fx", str(FX), "--fy", str(FX),
         "--cx", str(W / 2), "--cy", str(H / 2), "--frames", "8",
         "--poseframe-every", "2", "--cpu", "--ba", "--out", str(out)],
        check=True, cwd=REPO, env=env, timeout=300, capture_output=True)
    for name in ("idepthmap.ppm", "wireframe.ppm"):
        data = (out / name).read_bytes()
        header = b"P6\n%d %d\n255\n" % (W, H)
        assert data.startswith(header) and len(data) == len(header) \
            + 3 * W * H


@pytest.mark.parametrize("fx,radius", [(210.0, 3), (517.3, 8), (458.65, 7),
                                       (100.0, 3)])
def test_run_dataset_params(fx, radius):
    """run_dataset's Params are examples/run_dataset.py's, except that the
    re-match radius grows with fx from 3 px at mini-TUM's fx=210."""
    from flame_tpu import Params as JParams
    from flame_tpu.params import SolverParams as JSolverParams
    from flame_tpu_torch import run_dataset
    got = run_dataset.make_params(True, fx)
    assert got.ba.rematch_radius == radius
    want = JParams(min_height=-1e6, max_height=1e6, do_ba=True,
                   solver=JSolverParams(n_iters_per_frame=60,
                                        async_topology=True),
                   debug_quiet=True)
    want = dataclasses.replace(want, ba=dataclasses.replace(
        want.ba, rematch_radius=radius))
    assert got == convert.params_from_dict(dataclasses.asdict(want))
