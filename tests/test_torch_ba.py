"""Bundle adjustment's stages against the JAX package on the CPU.

A seeded window (P=6 poses on the mini-TUM trajectory, L=256 landmarks,
M=1024 observations of which 1000 are live, 5% of those marked invalid)
goes through flame_tpu.ba and flame_tpu_torch.ba:

- residuals within 1e-4 px, Jacobian blocks within rtol 1e-4 (atol 1e-4
  of the block's largest entry), Huber weights within 1e-5, with and
  without the structure-tensor whitening;
- one solve_window (5 Gauss-Newton iterations from poses perturbed by
  1 cm / 0.5 deg): poses within 1e-5 m / 1e-5 rad, idepths within 1e-4
  relative, the cost within 1e-4 relative; window_cost likewise;
- rematch_observations and observation_weights on mini-TUM images
  against JAX's img_pack=None route: the same refined set but for 1% of
  the rows, refined pixels within 1e-3 px, weights within 1e-5;
- pack_ba_outputs -> split_packed bit-equal for one frame and for a
  batch of three; build_window and ingest_snapshot equal; the guarded
  idepth write-back equal;
- ba.do_rematch off and ba.aniso_weights on (and both): the port's
  _rematch_and_weigh against the JAX package's same two steps, then the
  whole packed window solve (window._solve_packed) against the JAX
  package's at solve_window's tolerances."""

import dataclasses
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from flame_tpu.ba import rematch as jrematch  # noqa: E402
from flame_tpu.ba import residuals as jresid  # noqa: E402
from flame_tpu.ba import schur as jschur  # noqa: E402
from flame_tpu.ba import window as jwindow  # noqa: E402
from flame_tpu.core import pipeline as jpipe  # noqa: E402
from flame_tpu.io import synthetic as jsynthetic  # noqa: E402
from flame_tpu.params import BAParams as JBAParams  # noqa: E402
from flame_tpu.params import Params as JParams  # noqa: E402
from flame_tpu_torch import convert  # noqa: E402
from flame_tpu_torch.ba import rematch, residuals, schur, window  # noqa: E402
from flame_tpu_torch.core import pipeline  # noqa: E402
from flame_tpu_torch.geometry import se3  # noqa: E402

P, L, M, M_LIVE = 6, 256, 1024, 1000
W, H, FX = 160, 120, 131.25
PAD = 5


def _K():
    K = np.array([[FX, 0, W / 2], [0, FX, H / 2], [0, 0, 1]], np.float32)
    return K, np.linalg.inv(K.astype(np.float64)).astype(np.float32)


def _quat_mul(a, b):
    w1, x1, y1, z1 = a
    w2, x2, y2, z2 = b
    return np.array([w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
                     w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
                     w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
                     w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2])


def _rot(q, v):
    w, x, y, z = q
    R = np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)]])
    return v @ R.T


@pytest.fixture(scope="module")
def window_np():
    """True poses (frames 0, 2, .., 10 of the mini-TUM trajectory), their
    images and idepth maps, landmarks at rendered idepths, observations
    projected with 0.3 px noise, and the problem with poses perturbed by
    1 cm / 0.5 deg."""
    rng = np.random.default_rng(2024)
    K, Kinv = _K()
    poses = [jsynthetic.trajectory(2 * i) for i in range(P)]
    renders = [jsynthetic.render_frame(K.astype(np.float64), q, t, W, H)
               for q, t in poses]
    anchor = rng.integers(0, P, L)
    u_lm = np.stack([rng.uniform(8, W - 8, L), rng.uniform(8, H - 8, L)], 1)
    idm = np.stack([r[1] for r in renders])
    lm_true = idm[anchor, u_lm[:, 1].astype(int), u_lm[:, 0].astype(int)]
    lm_true = np.where(np.isfinite(lm_true), lm_true, 0.3)
    rows = []
    for m in range(M_LIVE):
        li = m % L
        a = anchor[li]
        o = (a + 1 + rng.integers(0, P - 1)) % P
        ray = np.array([(u_lm[li, 0] - W / 2) / FX,
                        (u_lm[li, 1] - H / 2) / FX, 1.0]) / lm_true[li]
        qa, ta = poses[a]
        qo, to = poses[o]
        p_w = _rot(qa, ray) + ta
        p_o = _rot(qo * [1, -1, -1, -1], p_w - to)
        u = FX * p_o[:2] / p_o[2] + [W / 2, H / 2] + rng.normal(0, 0.3, 2)
        rows.append((a, o, li, u))
    a, o, li, uo = (np.array(x) for x in zip(*rows))
    pad = M - M_LIVE
    valid = np.arange(M) < M_LIVE
    valid[rng.uniform(size=M) < 0.05] = False
    obs = dict(anchor_idx=np.pad(a, (0, pad)).astype(np.int32),
               obs_idx=np.pad(o, (0, pad)).astype(np.int32),
               lm_idx=np.pad(li, (0, pad)).astype(np.int32),
               u_ref=np.pad(u_lm[li], ((0, pad), (0, 0))).astype(np.float32),
               u_obs=np.pad(uo, ((0, pad), (0, 0))).astype(np.float32),
               valid=valid)
    q = np.stack([p[0] for p in poses])
    t = np.stack([p[1] for p in poses])
    qn, tn = q.copy(), t.copy()
    for i in range(P):
        ax = rng.normal(size=3)
        ang = np.deg2rad(0.5) * rng.uniform(0.5, 1.0)
        qn[i] = _quat_mul(np.r_[np.cos(ang / 2),
                                np.sin(ang / 2) * ax / np.linalg.norm(ax)],
                          q[i])
        tn[i] = t[i] + rng.normal(0, 0.01, 3)
    lm_valid = np.arange(L) < L - 6  # a few padded landmarks
    problem = dict(q=qn.astype(np.float32), t=tn.astype(np.float32),
                   lm_idepth=np.where(lm_valid, lm_true * rng.uniform(
                       0.95, 1.05, L), 0).astype(np.float32),
                   lm_valid=lm_valid, obs=obs,
                   prior_q=q.astype(np.float32), prior_t=t.astype(np.float32))
    imgs = np.stack([np.pad(r[0].astype(np.float32), PAD, mode="reflect")
                     for r in renders])
    return dict(K=K, Kinv=Kinv, problem=problem, imgs_pad=imgs)


def _jax_problem(d):
    p = d["problem"]
    obs = jresid.BAObservations(**{k: jnp.asarray(v)
                                   for k, v in p["obs"].items()})
    return jschur.BAProblem(**{k: jnp.asarray(v) for k, v in p.items()
                               if k != "obs"}, obs=obs)


def _sqrtw(d):
    obs = d["problem"]["obs"]
    anchor_slot = obs["anchor_idx"]
    return (jrematch.observation_weights(jnp.asarray(d["imgs_pad"]), PAD,
                                         jnp.asarray(anchor_slot),
                                         jnp.asarray(obs["u_ref"])),
            rematch.observation_weights(torch.as_tensor(d["imgs_pad"]), PAD,
                                        torch.as_tensor(anchor_slot).long(),
                                        torch.as_tensor(obs["u_ref"])))


@pytest.mark.parametrize("whiten", [False, True])
def test_residuals_and_jacobians_match_jax(window_np, whiten):
    d = window_np
    jp = _jax_problem(d)
    tp = convert.ba_problem_from_numpy(d["problem"], "cpu")
    jw, tw = _sqrtw(d) if whiten else (None, None)
    jout = jresid.residuals_and_jacobians(
        jnp.asarray(d["K"]), jnp.asarray(d["Kinv"]), jp.q, jp.t, jp.obs,
        jp.lm_idepth, 2.0, sqrtW=jw)
    tout = residuals.residuals_and_jacobians(
        torch.as_tensor(d["K"]), torch.as_tensor(d["Kinv"]), tp.q, tp.t,
        tp.obs, tp.lm_idepth, 2.0, sqrtW=tw)
    (jr, jJa, jJo, jJd, jwt), (tr, tJa, tJo, tJd, twt) = \
        [[np.asarray(x) for x in o] for o in (jout, tout)]
    live = np.asarray(d["problem"]["obs"]["valid"])
    assert (jwt > 0).sum() > 800
    np.testing.assert_array_equal(twt > 0, jwt > 0)
    np.testing.assert_allclose(tr[live], jr[live], atol=1e-4)
    np.testing.assert_allclose(twt, jwt, atol=1e-5)
    for tj, jj in ((tJa, jJa), (tJo, jJo), (tJd, jJd)):
        np.testing.assert_allclose(tj[live], jj[live], rtol=1e-4,
                                   atol=1e-4 * np.abs(jj[live]).max())


@pytest.fixture(scope="module")
def solved(window_np):
    d = window_np
    bp = JBAParams(window_size=P)
    tbp = convert.params_from_dict(
        {"ba": dataclasses.asdict(bp)}).ba
    jp = _jax_problem(d)
    tp = convert.ba_problem_from_numpy(d["problem"], "cpu")
    jout = jschur.solve_window(bp, jnp.asarray(d["K"]), jnp.asarray(d["Kinv"]),
                               jp, n_fixed=2)
    tout = schur.solve_window(tbp, torch.as_tensor(d["K"]),
                              torch.as_tensor(d["Kinv"]), tp, n_fixed=2)
    return d, bp, tbp, jout, tout


def test_solve_window_matches_jax(solved):
    d, _, _, jout, tout = solved
    jq, jt, jlm, jcost = (np.asarray(x) for x in jout)
    tq, tt, tlm, tcost = (x.numpy() for x in tout)
    # The solve moves the perturbed poses toward the true ones.
    p = d["problem"]
    assert np.abs(jt - p["prior_t"]).max() < np.abs(p["t"] - p["prior_t"]) \
        .max()
    np.testing.assert_allclose(tt, jt, atol=1e-5)
    rot = se3.log((torch.tensor(tq), torch.zeros(P, 3)))
    jrot = se3.log((torch.tensor(jq), torch.zeros(P, 3)))
    np.testing.assert_allclose(rot[:, 3:].numpy(), jrot[:, 3:].numpy(),
                               atol=1e-5)
    lv = p["lm_valid"]
    np.testing.assert_allclose(tlm[lv], jlm[lv], rtol=1e-4)
    np.testing.assert_array_equal(tlm[~lv], jlm[~lv])
    np.testing.assert_allclose(tcost, jcost, rtol=1e-4)


def test_window_cost_matches_jax(solved):
    d, bp, tbp, _, _ = solved
    jc = jschur.window_cost(bp, jnp.asarray(d["K"]), jnp.asarray(d["Kinv"]),
                            _jax_problem(d))
    tc = schur.window_cost(tbp, torch.as_tensor(d["K"]),
                           torch.as_tensor(d["Kinv"]),
                           convert.ba_problem_from_numpy(d["problem"], "cpu"))
    np.testing.assert_allclose(float(tc), float(jc), rtol=1e-4)


@pytest.mark.parametrize("min_eig", [0.0, 25.0])
def test_rematch_observations_matches_jax(window_np, min_eig):
    d = window_np
    p, o = d["problem"], d["problem"]["obs"]
    args = [d["K"], d["Kinv"], d["imgs_pad"], PAD, p["q"], p["t"],
            o["anchor_idx"], o["obs_idx"], o["anchor_idx"], o["obs_idx"],
            o["u_ref"], o["u_obs"], o["lm_idx"], p["lm_idepth"], o["valid"]]
    ju, jref = jrematch.rematch_observations(
        *[jnp.asarray(a) if isinstance(a, np.ndarray) else a for a in args],
        min_eig=min_eig)
    targs = [torch.as_tensor(a) if isinstance(a, np.ndarray) else a
             for a in args]
    for i in (6, 7, 8, 9, 12):
        targs[i] = targs[i].long()
    tu, tref = rematch.rematch_observations(*targs, min_eig=min_eig)
    jref, ju = np.asarray(jref), np.asarray(ju)
    tref, tu = tref.numpy(), tu.numpy()
    assert jref.sum() > 50
    assert (jref != tref).mean() <= 0.01
    both = jref & tref
    np.testing.assert_allclose(tu[both], ju[both], atol=1e-3)
    np.testing.assert_array_equal(tu[~jref & ~tref], o["u_obs"][~jref & ~tref])


def test_observation_weights_match_jax(window_np):
    jw, tw = _sqrtw(window_np)
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), atol=1e-5)


def _tracked_state(rng, N=64, Pc=8, B=1):
    """A random tracked state: features (ids past 2^24, anchor slots up to
    Pc-1), B frames of matches (some failed, some out of the packed
    range), the stack's ids and poses, and the (N, 3) snapshot."""
    q = rng.normal(size=(Pc, 4)).astype(np.float32)
    st = dict(frame_id=np.where(rng.uniform(size=Pc) < 0.8,
                                rng.integers(0, 1000, Pc), -1)
              .astype(np.int32),
              q=q / np.linalg.norm(q, axis=1, keepdims=True),
              t=rng.normal(size=(Pc, 3)).astype(np.float32))
    fe = dict(xy=rng.uniform(-3, 700, (N, 2)).astype(np.float32),
              pf_slot=rng.integers(0, Pc, N).astype(np.int32),
              feat_id=rng.integers(0, 2 ** 26, N).astype(np.int32),
              idepth_mu=rng.uniform(0, 2, N).astype(np.float32))
    ob = dict(success=rng.uniform(size=(B, N)) < 0.7,
              u_obs=rng.uniform(-5, 2100, (B, N, 2)).astype(np.float32),
              u_ref=fe["xy"][None].repeat(B, 0),
              idepth=fe["idepth_mu"][None].repeat(B, 0),
              var=np.ones((B, N), np.float32))
    if B == 1:
        ob = {k: v[0] for k, v in ob.items()}
    packed = rng.integers(0, 65536, (N, 3)).astype(np.uint16)
    return st, fe, ob, packed


@pytest.mark.parametrize("B", [1, 3])
def test_pack_ba_outputs_and_split_match_jax(B):
    rng = np.random.default_rng(B)
    N, Pc = 64, 8
    st, fe, ob, packed = _tracked_state(rng, N, Pc, B)
    jparams = JParams(feature_capacity=N, poseframe_capacity=Pc)
    tparams = convert.params_from_dict(dataclasses.asdict(jparams))
    jns = lambda d: SimpleNamespace(**{k: jnp.asarray(v)  # noqa: E731
                                       for k, v in d.items()})
    tns = lambda d: SimpleNamespace(**{k: torch.as_tensor(v)  # noqa: E731
                                       for k, v in d.items()})
    jarr = np.asarray(jpipe.pack_ba_outputs(
        jparams, jnp.asarray(packed), jpipe.TrackObs(**{
            k: jnp.asarray(v) for k, v in ob.items()}), jns(fe), jns(st)))
    tobs = pipeline.TrackObs(**{k: torch.as_tensor(v) for k, v in ob.items()})
    tfe = tns(fe)
    tfe.pf_slot = tfe.pf_slot.long()
    tarr = pipeline.pack_ba_outputs(tparams, torch.as_tensor(
        packed.astype(np.int32)), tobs, tfe, tns(st)).numpy()
    assert tarr.dtype == jarr.dtype == np.int32
    np.testing.assert_array_equal(tarr, jarr)
    jpk, jsnap = jwindow.split_packed(jparams, jarr)
    tpk, tsnap = window.split_packed(tparams, tarr)
    np.testing.assert_array_equal(tpk, packed)
    np.testing.assert_array_equal(tpk, jpk)
    assert tsnap["uo"].shape[0] == B and sorted(tsnap) == sorted(jsnap)
    for k in jsnap:
        np.testing.assert_array_equal(tsnap[k], jsnap[k])
    np.testing.assert_array_equal(tsnap["feat_id"], fe["feat_id"] & 0xFFFFFF)
    np.testing.assert_array_equal(tsnap["pf_slot"], fe["pf_slot"])


def _fill_stores(rng, stores):
    for i in range(8):
        n = int(rng.integers(20, 80))
        args = (rng.integers(0, 8, n), 10 + i, rng.integers(0, 60, n),
                rng.uniform(0, 100, (n, 2)), rng.uniform(0, 100, (n, 2)))
        for s in stores:
            s.add_frame(*args)
    for s in stores:
        s.drop_frames([11, 3])


def test_build_window_matches_jax():
    rng = np.random.default_rng(5)
    js, ts = jwindow.ObservationStore(300), window.ObservationStore(300)
    _fill_stores(rng, (js, ts))
    assert len(ts) == len(js) > 0
    frame_ids = [0, 1, 2, 4, 5, 6, 7, 12, 14, 15]
    pose = {f: (rng.normal(size=4), rng.normal(size=3)) for f in frame_ids}
    prior = {f: (rng.normal(size=4), rng.normal(size=3))
             for f in frame_ids[::2]}
    lm = {(int(f), int(a)): float(rng.uniform(0.1, 1))
          for f in range(0, 60, 2) for a in range(8)}
    for cap in ((40, 600), (1000, 150)):
        jb = js.build_window(frame_ids, pose, lm, *cap, prior_by_id=prior)
        tb = ts.build_window(frame_ids, pose, lm, *cap, prior_by_id=prior)
        assert jb is not None and tb is not None
        (jpr, jord, jkeys, jn), (tpr, tord, tkeys, tn) = jb, tb
        assert (tord, tkeys, tn) == (jord, jkeys, jn)
        for k in ("q", "t", "lm_idepth", "lm_valid", "prior_q", "prior_t"):
            np.testing.assert_array_equal(getattr(tpr, k), getattr(jpr, k))
        for k in jpr.obs._fields:
            np.testing.assert_array_equal(getattr(tpr.obs, k),
                                          getattr(jpr.obs, k))
    assert ts.build_window(frame_ids, pose, {}, 40, 600) is None


def test_ingest_snapshot_matches_jax():
    rng = np.random.default_rng(9)
    N, Pc = 64, 8
    st, fe, ob, packed = _tracked_state(rng, N, Pc, B=3)
    st["frame_id"][:] = np.arange(100, 100 + Pc)
    ob["u_obs"] = np.clip(ob["u_obs"], 0, 600)
    jparams = JParams(feature_capacity=N, poseframe_capacity=Pc)
    tparams = convert.params_from_dict(dataclasses.asdict(jparams))
    tfe = SimpleNamespace(**{k: torch.as_tensor(v) for k, v in fe.items()})
    tfe.pf_slot = tfe.pf_slot.long()
    arr = pipeline.pack_ba_outputs(
        tparams, torch.as_tensor(packed.astype(np.int32)),
        pipeline.TrackObs(**{k: torch.as_tensor(v) for k, v in ob.items()}),
        tfe, SimpleNamespace(**{k: torch.as_tensor(v)
                                for k, v in st.items()})).numpy()
    jb = jwindow.BundleAdjuster(jparams.ba, None, None)
    tb = window.BundleAdjuster(tparams.ba, None, None)
    fids, flags = [200, 201, 107], [True, False, True]
    jb.ingest_snapshot(jwindow.split_packed(jparams, arr)[1], fids, flags)
    tb.ingest_snapshot(window.split_packed(tparams, arr)[1], fids, flags)
    assert (tb._new_pf_count, tb._snap_dirty) == (jb._new_pf_count,
                                                 jb._snap_dirty) == (2, True)
    for a, b in zip(tb.store._ordered(), jb.store._ordered()):
        np.testing.assert_array_equal(a, b)
    assert sorted(tb._input_pose_by_id) == sorted(jb._input_pose_by_id)
    for f, (q, t) in jb._input_pose_by_id.items():
        np.testing.assert_array_equal(tb._input_pose_by_id[f][0], q)
        np.testing.assert_array_equal(tb._input_pose_by_id[f][1], t)
    valid = rng.uniform(size=N) < 0.8
    assert tb._snapshot_landmarks(valid) == jb._snapshot_landmarks(valid)


def test_apply_idepths_matches_jax():
    rng = np.random.default_rng(21)
    N, Lr = 64, 40
    fe = dict(xy=np.zeros((N, 2), np.float32),
              pf_slot=rng.integers(0, 4, N).astype(np.int32),
              idepth_mu=rng.uniform(0.1, 1, N).astype(np.float32),
              idepth_var=np.ones(N, np.float32),
              valid=rng.uniform(size=N) < 0.9,
              num_updates=np.zeros(N, np.int32),
              num_dropouts=np.zeros(N, np.int32),
              search_status=np.zeros(N, np.int32),
              feat_id=(rng.integers(0, 2 ** 20, N)
                       + (rng.integers(0, 2, N) << 24)).astype(np.int32))
    slots = (rng.permutation(N + 1)[:Lr] - 1).astype(np.int32)  # unique
    sl = np.clip(slots, 0, N - 1)
    ids = np.where(rng.uniform(size=Lr) < 0.8, fe["feat_id"][sl] & 0xFFFFFF,
                   fe["feat_id"][sl] + 1)
    aslots = np.where(rng.uniform(size=Lr) < 0.8, fe["pf_slot"][sl], 5)
    mus = rng.uniform(0.1, 1, Lr).astype(np.float32)
    trip = np.stack([slots, ids, aslots, mus.view(np.int32)], 1) \
        .astype(np.int32)
    jfe = jpipe.FeatureState(**{k: jnp.asarray(v) for k, v in fe.items()})
    jout = np.asarray(jwindow._apply_idepths(jfe, jnp.asarray(trip))
                      .idepth_mu)
    tout = window._apply_idepths(convert.feature_state_from_numpy(fe, "cpu"),
                                 torch.as_tensor(trip)).idepth_mu.numpy()
    np.testing.assert_array_equal(tout, jout)
    assert (tout != fe["idepth_mu"]).sum() > 10


BA_BRANCHES = {"default": {}, "no_rematch": dict(do_rematch=False),
               "aniso_weights": dict(aniso_weights=True),
               "no_rematch_aniso_weights": dict(do_rematch=False,
                                                aniso_weights=True)}


def _branch_solve(d, branch):
    """window._solve_packed (decode, _rematch_and_weigh, the Schur
    solve) with the branch's BAParams in both packages on one packed
    upload of window_np, n_fixed=2; JAX through its img_pack=None
    route. Returns (jax flat, port flat, port BAParams, buf)."""
    bp = JBAParams(window_size=P, **BA_BRANCHES[branch])
    tbp = convert.params_from_dict({"ba": dataclasses.asdict(bp)}).ba
    slot_w = np.arange(P, dtype=np.int32)
    buf = jwindow._pack_problem(_jax_problem(d), slot_w)
    tbuf = window._pack_problem(
        convert.ba_problem_from_numpy(d["problem"], "cpu"), slot_w)
    np.testing.assert_array_equal(tbuf, buf)
    jout = jwindow._solve_packed(bp, jnp.asarray(d["K"]),
                                 jnp.asarray(d["Kinv"]), jnp.asarray(buf),
                                 jnp.asarray(d["imgs_pad"]), None, PAD, 2,
                                 P, L, M)
    tout = window._solve_packed(tbp, torch.as_tensor(d["K"]),
                                torch.as_tensor(d["Kinv"]),
                                torch.as_tensor(buf),
                                torch.as_tensor(d["imgs_pad"]), PAD, 2, P, L,
                                M)
    return np.asarray(jout), tout.numpy(), tbp, buf


@pytest.fixture(scope="module")
def default_branch_solve(window_np):
    """The port's packed solve at the default do_rematch / aniso_weights."""
    return _branch_solve(window_np, "default")[1]


@pytest.mark.parametrize("branch", ["no_rematch", "aniso_weights",
                                    "no_rematch_aniso_weights"])
def test_rematch_and_weigh_branch_matches_jax(window_np, default_branch_solve,
                                              branch):
    """ba.do_rematch off and ba.aniso_weights on: the port's whole
    _rematch_and_weigh against the JAX package's same two steps of its
    _solve_packed (ba/window.py's do_rematch and aniso_weights blocks),
    then the whole packed window solve against JAX's at
    test_solve_window_matches_jax's tolerances (poses within 1e-5,
    quaternion entries and metres; landmark idepths and the cost within
    1e-4 relative); and the branch changes the port's own solve."""
    d = window_np
    jflat, tflat, tbp, buf = _branch_solve(d, branch)
    problem, slot_w = window._decode_packed(torch.as_tensor(buf), P, L, M)
    tprob, tsqrt = window._rematch_and_weigh(
        tbp, torch.as_tensor(d["K"]), torch.as_tensor(d["Kinv"]), problem,
        slot_w, torch.as_tensor(d["imgs_pad"]), PAD)
    p, o = d["problem"], d["problem"]["obs"]
    ju = o["u_obs"]
    if tbp.do_rematch:
        ju = np.asarray(jrematch.rematch_observations(
            *[jnp.asarray(a) for a in (
                d["K"], d["Kinv"], d["imgs_pad"])], PAD,
            *[jnp.asarray(a) for a in (
                p["q"], p["t"], o["anchor_idx"], o["obs_idx"],
                o["anchor_idx"], o["obs_idx"], o["u_ref"], o["u_obs"],
                o["lm_idx"], p["lm_idepth"], o["valid"])],
            radius=tbp.rematch_radius, max_cost=tbp.rematch_max_cost,
            min_eig=tbp.rematch_min_eig)[0])
    tu = tprob.obs.u_obs.numpy()
    moved_j, moved_t = (ju != o["u_obs"]).any(1), (tu != o["u_obs"]).any(1)
    assert (moved_j != moved_t).mean() <= 0.01
    np.testing.assert_allclose(tu[moved_j & moved_t],
                               ju[moved_j & moved_t], atol=1e-3)
    if tbp.aniso_weights:
        jw, _ = _sqrtw(d)
        np.testing.assert_allclose(tsqrt.numpy(), np.asarray(jw), atol=1e-5)
    else:
        assert tsqrt is None
    if not tbp.do_rematch:
        np.testing.assert_array_equal(tu, o["u_obs"])

    # The whole solve, against JAX's and against the port's default.
    assert np.abs(tflat - default_branch_solve).max() > 1e-3
    np.testing.assert_allclose(tflat[4 * P:7 * P], jflat[4 * P:7 * P],
                               atol=1e-5)
    np.testing.assert_allclose(tflat[:4 * P], jflat[:4 * P], atol=1e-5)
    lv = p["lm_valid"]
    lm_t, lm_j = tflat[7 * P:7 * P + L], jflat[7 * P:7 * P + L]
    np.testing.assert_allclose(lm_t[lv], lm_j[lv], rtol=1e-4)
    np.testing.assert_allclose(tflat[-1], jflat[-1], rtol=1e-4)
