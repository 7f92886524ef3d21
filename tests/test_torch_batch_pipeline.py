"""Throughput-path stages of flame_tpu_torch against the JAX package, given
the same input state: the dual carry of a re-applied or fresh topology,
reanchor_features (poseframe eviction) and batch_step.

A JAX Flame runs the tests/test_flame_e2e.py scene (160x120, 512
features, photo_error_num_pfs=30, uint8 frames) for 7 frames on its
synchronous path; its state is carried into the port through convert.py.

Tolerances:
  * dual carry: exactly equal (a pure gather);
  * reanchor_features, against JAX's run eagerly (XLA's compiled form
    fuses the projection and lands a few ulp away): validity and anchor
    slots exactly equal, the rest atol 1e-5;
  * batch_step at B = 2 and 4, against JAX's batch_step run eagerly under
    jax.disable_jit() (its jitted form rounds differently and moves the
    measured idepth of about a tenth of the features, ROADMAP.md s3):
    decision masks may differ on at most 0.5% of entries, floats agree to
    rtol 1e-4 / atol 1e-4 where the decisions agree, as in
    tests/test_torch_stereo_pipeline.py.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from flame_tpu.core import pipeline as jpipe  # noqa: E402
from flame_tpu.core.flame import Flame as JFlame  # noqa: E402
from flame_tpu.geometry import camera as jcam  # noqa: E402
from flame_tpu.optimize import topology as jtopo  # noqa: E402
from flame_tpu.params import (DetectionParams, Params,  # noqa: E402
                              SolverParams)
from flame_tpu_torch import convert  # noqa: E402
from flame_tpu_torch.core import pipeline  # noqa: E402
from flame_tpu_torch.mesh import delaunay  # noqa: E402
from flame_tpu_torch.optimize import topology  # noqa: E402

FX = 100.0
W, H = 160, 120
PLANE_Z = 5.0
RTOL = ATOL = 1e-4
MAX_FLIPS = 0.005


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
        poseframe_capacity=8, min_height=-100.0, max_height=100.0,
        idepth_init=0.05, idepth_var_init=0.25, photo_error_num_pfs=30,
        detection=DetectionParams(win_size=16),
        solver=SolverParams(n_iters_per_frame=30, max_vertex_degree=16),
        debug_quiet=True)


def _pose(i):
    return (np.array([1.0, 0, 0, 0], np.float32),
            np.array([0.15 * i, 0, 0], np.float32))


def _np(x):
    return {k: np.asarray(v) for k, v in x._asdict().items()}


def _t(a, dtype=None):
    t = torch.as_tensor(np.array(a))
    return t if dtype is None else t.to(dtype)


@pytest.fixture(scope="module")
def state():
    jp = make_params()
    K = jcam.make_k(FX, FX, W / 2, H / 2)
    Kinv = jcam.inv_k(K)
    jf = JFlame(W, H, K, Kinv, jp)
    for i in range(7):
        q, t = _pose(i)
        jf.update(i * 0.1, i, (jnp.asarray(q), jnp.asarray(t)),
                  render(0.15 * i), i % 2 == 0)
    assert jf._last_topo_host is not None and jf._n_valid > 50
    tp = convert.params_from_dict(dataclasses.asdict(jp))
    return dict(jp=jp, tp=tp, K=K, Kinv=Kinv, tK=_t(K), tKinv=_t(Kinv),
                jf=jf)


def _flips(a, b):
    a, b = np.asarray(a), np.asarray(b)
    bad = a != b
    assert bad.mean() <= MAX_FLIPS, (int(bad.sum()), a.size)
    return ~bad


def _close(a, b, where=None, rtol=RTOL, atol=ATOL):
    a = np.asarray(a)
    b = b.numpy() if isinstance(b, torch.Tensor) else np.asarray(b)
    if where is not None:
        a, b = a[where], b[where]
    np.testing.assert_allclose(b, a, rtol=rtol, atol=atol)


# ---------------------------------------------------------------------------
# Dual carry: re-applying the same edges passes the duals through, as the
# JAX package's carry_fresh=False does; a fresh topology carries them by
# vertex pair, as its host-computed carry index does.
# ---------------------------------------------------------------------------

V, E, D = 512, 2048, 16


def _mesh_edges(pts):
    edges = delaunay.triangulate(pts).edges.astype(np.int64)
    full = np.zeros((E, 2), np.int64)
    full[:edges.shape[0]] = edges
    return full, edges.shape[0]


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("fresh", [False, True])
def test_dual_carry_matches_jax(seed, fresh):
    rng = np.random.default_rng(seed)
    pts = rng.uniform([2, 2], [158, 118], (300, 2)).astype(np.float32)
    prev, n_prev = _mesh_edges(pts)
    pos = np.zeros((V, 2), np.float32)
    pos[:300] = pts
    # Edges that lost a member vertex are masked out of the applied graph
    # (holes in its edge mask); the smoother leaves their duals at zero.
    live = np.arange(E) < n_prev
    pmask = live & (rng.uniform(size=E) > 0.1)
    q = [np.where(pmask, rng.uniform(-1, 1, E), 0).astype(np.float32)
         for _ in range(3)]
    if fresh:  # retriangulate with some points moved and some dropped
        pts2 = pts.copy()
        pts2[:40] += rng.normal(0, 6, (40, 2)).astype(np.float32)
        keep = np.ones(300, bool)
        keep[rng.integers(0, 300, 30)] = False
        sub, n_new = _mesh_edges(pts2[keep])
        new = np.zeros_like(sub)
        new[:n_new] = np.nonzero(keep)[0][sub[:n_new]]
        pos[:300] = pts2
        # JAX's host carry index (flame.Flame._fill_carry): the slot of
        # the same pair in the previously applied edge list.
        pc = prev[:n_prev, 0] * V + prev[:n_prev, 1]
        nc = new[:n_new, 0] * V + new[:n_new, 1]
        at = np.minimum(np.searchsorted(pc, nc), n_prev - 1)
        carry = np.full(E, 0xFFFF, np.int64)
        carry[:n_new] = np.where(pc[at] == nc, at, 0xFFFF)
    else:
        new, n_new, carry = prev, n_prev, np.arange(E)
    ranks = topology.build_edge_ranks(new[:n_new], V, E)
    jt = jtopo.from_edges(
        jnp.asarray(new), n_new, jnp.asarray(pos), jnp.asarray(prev),
        jnp.asarray(pmask), *map(jnp.asarray, q), E, V, D,
        build_incidence=True, ranks=jnp.asarray(ranks),
        carry_idx=jnp.asarray(carry), carry_fresh=jnp.asarray(fresh))
    tt = topology.from_edges(_t(new), n_new, _t(pos), _t(prev), _t(pmask),
                             *map(_t, q), E, V, D, ranks=_t(ranks))
    n_carried = 0
    for a, b in ((jt.q1, tt.q1), (jt.q2, tt.q2), (jt.q3, tt.q3)):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))
        n_carried = int((np.asarray(a) != 0).sum())
    assert n_carried > n_new // 3


# ---------------------------------------------------------------------------
# reanchor_features: evict the two oldest poseframes onto the newest.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shift", [0.0, 1.2])
def test_reanchor_features_matches_jax(state, shift):
    """shift: the target poseframe's pose is moved sideways by this many
    metres, so that part of the moved features leave the border."""
    s = state
    jf = s["jf"]
    ids = sorted(jf._pf_slot_by_id)
    kill = np.zeros(s["jp"].poseframe_capacity, bool)
    for fid in ids[:2]:
        kill[jf._pf_slot_by_id[fid]] = True
    target = jf._pf_slot_by_id[ids[-1]]
    stack = _np(jf._stack)
    stack["t"] = stack["t"].copy()
    stack["t"][target, 0] += shift
    b = float(s["jp"].border)
    jfe = jf._feats
    moved = np.asarray(jfe.valid) & kill[np.asarray(jfe.pf_slot)]
    assert moved.sum() > 20
    with jax.disable_jit():
        j = jpipe.reanchor_features(
            jfe, s["K"], s["Kinv"],
            jf._stack._replace(t=jnp.asarray(stack["t"])),
            jnp.asarray(kill), target, b, W - b, H - b)
    t = pipeline.reanchor_features(
        convert.feature_state_from_numpy(_np(jfe), "cpu"), s["tK"],
        s["tKinv"], convert.frame_stack_from_numpy(stack, "cpu"), _t(kill),
        target, b, W - b, H - b)
    jv = np.asarray(j.valid)
    np.testing.assert_array_equal(t.valid.numpy(), jv)
    np.testing.assert_array_equal(t.pf_slot.numpy(), np.asarray(j.pf_slot))
    lost = int(np.asarray(jfe.valid).sum() - jv.sum())
    assert (lost > 0) == (shift > 0)
    for name in ("xy", "idepth_mu", "idepth_var"):
        _close(getattr(j, name), getattr(t, name), rtol=0, atol=1e-5)


# ---------------------------------------------------------------------------
# batch_step: frames 7.. in one step of B = 2 (frame 8 a poseframe) or 4
# (8 and 10).
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module", params=[2, 4], ids=lambda b: f"B{b}")
def batched(state, request):
    s = state
    B = request.param
    jf, jp = s["jf"], s["jp"]
    fids = list(range(7, 7 + B))
    pf_flags = [i % 2 == 0 for i in fids]
    free = list(jf._pf_free)
    slot = jf._curr_pf_slot
    pf_slots, id_bases = [], []
    counter = jf._feat_id_counter
    for is_pf in pf_flags:
        if is_pf:
            slot = free.pop()
        pf_slots.append(slot)
        id_bases.append(counter)
        if is_pf:
            counter += jf._add_cap
    poses = [_pose(i) for i in fids]
    imgs = [render(0.15 * i) for i in fids]
    words = np.asarray(jf._last_topo_host)
    sync_q, sync_t = jf._last_sync_pose
    prev = jf._fnew
    with jax.disable_jit():
        jout = jpipe.batch_step(
            jp, s["K"], s["Kinv"], jf._stack, jf._feats, jf._graph,
            jf._graph_scale_dev, jnp.asarray(words),
            np.asarray(fids, np.int32),
            tuple(jnp.asarray(p[0]) for p in poses),
            tuple(jnp.asarray(p[1]) for p in poses),
            np.asarray(pf_flags), np.asarray(pf_flags),
            np.asarray(pf_slots, np.int32), np.asarray(id_bases, np.int32),
            prev.q, prev.t, sync_q, sync_t, jf._idepthmap,
            jnp.asarray(False), n_frames=B, height=H, width=W,
            imgs=tuple(jnp.asarray(im) for im in imgs))
    tout = pipeline.batch_step(
        s["tp"], s["tK"], s["tKinv"],
        convert.frame_stack_from_numpy(_np(jf._stack), "cpu"),
        convert.feature_state_from_numpy(_np(jf._feats), "cpu"),
        convert.graph_state_from_numpy(_np(jf._graph), "cpu"),
        _t(jf._graph_scale_dev), [_t(im) for im in imgs], fids,
        [_t(p[0]) for p in poses], [_t(p[1]) for p in poses], pf_flags,
        pf_flags, pf_slots, id_bases, _t(prev.q), _t(prev.t), _t(sync_q),
        _t(sync_t), _t(jf._idepthmap),
        convert.topology_from_words(words, jp.triangle_capacity,
                                    jp.edge_capacity, "cpu"), W, H)
    return jout, tout, pf_slots, pf_flags


def test_batch_step_tracking_matches_eager_jax(batched):
    jout, tout, _, pf_flags = batched
    B = len(pf_flags)
    (_, _, jfe, jcu, jmem, jst, _, jpk) = jout[:8]
    (_, _, tfe, tcu, tmem, tst, tpk) = tout[:7]
    assert int(np.asarray(jfe.valid).sum()) > 50
    ok = _flips(jfe.valid, tfe.valid.numpy())
    ok &= _flips(jfe.search_status, tfe.search_status.numpy())
    ok &= _flips(jmem, tmem.numpy())
    ok &= _flips(jfe.pf_slot, tfe.pf_slot.numpy())
    ok &= _flips(jfe.feat_id, tfe.feat_id.numpy())
    v = ok & np.asarray(jfe.valid)
    for name in ("xy", "idepth_mu", "idepth_var"):
        _close(getattr(jfe, name), getattr(tfe, name), v)
    for name in ("xy", "idepth", "var"):
        _close(getattr(jcu, name), getattr(tcu, name), v)
    np.testing.assert_allclose(tst.numpy(), np.asarray(jst),
                               atol=max(2, 0.005 * 512 * B))
    _flips(np.asarray(jpk)[:, 2], tpk[:, 2].numpy())


def test_batch_step_stack_and_maps_match_eager_jax(batched):
    jout, tout, pf_slots, pf_flags = batched
    jstack, tstack = jout[1], tout[1]
    np.testing.assert_array_equal(tstack.frame_id.numpy(),
                                  np.asarray(jstack.frame_id))
    np.testing.assert_array_equal(tstack.valid.numpy(),
                                  np.asarray(jstack.valid))
    _close(jstack.q, tstack.q, rtol=0, atol=0)
    # Each poseframe of the batch stashed its own per-frame dense map.
    for b in np.nonzero(pf_flags)[0]:
        jm = np.asarray(jstack.idepthmap[pf_slots[b]])
        tm = tstack.idepthmap[pf_slots[b]].numpy()
        both = _flips(np.isnan(jm), np.isnan(tm)) & ~np.isnan(jm)
        assert both.mean() > 0.3
        _close(jm, tm, both)
    jg, tg = jout[8], tout[7]
    jmem = np.asarray(jout[4])
    np.testing.assert_array_equal(tg.vtx_mask.numpy(), jmem)
    for name in ("x", "w1", "w2", "data_term"):
        _close(getattr(jg, name), getattr(tg, name), jmem)
    em = np.asarray(jg.edge_mask) & tg.edge_mask.numpy()
    for name in ("q1", "q2", "q3"):
        _close(getattr(jg, name), getattr(tg, name), em)
    jidm, tidm = np.asarray(jout[12]), tout[11].numpy()
    both = _flips(np.isnan(jidm), np.isnan(tidm)) & ~np.isnan(jidm)
    assert both.mean() > 0.3
    _close(jidm, tidm, both)
    assert abs(float(jout[14]) - float(tout[13])) <= MAX_FLIPS


def test_frame_pose_writes_and_remove_match_jax(state):
    """frame.set_pose, set_poses and remove against the JAX package's."""
    from flame_tpu.core import frame as jframe
    from flame_tpu_torch.core import frame as tframe
    jf = state["jf"]
    slots = sorted(jf._pf_slot_by_id.values())[:2]
    rng = np.random.default_rng(3)
    qs = rng.normal(size=(2, 4)).astype(np.float32)
    ts = rng.normal(size=(2, 3)).astype(np.float32)
    j = jframe.set_pose(jf._stack, slots[0], jnp.asarray(qs[1]),
                        jnp.asarray(ts[1]))
    j = jframe.set_poses(j, jnp.asarray(slots), jnp.asarray(qs),
                         jnp.asarray(ts))
    j = jframe.remove(j, slots[1])
    t = convert.frame_stack_from_numpy(_np(jf._stack), "cpu")
    tframe.set_pose(t, slots[0], _t(qs[1]), _t(ts[1]))
    tframe.set_poses(t, slots, _t(qs), _t(ts))
    tframe.remove(t, slots[1])
    for name in ("q", "t", "frame_id", "valid"):
        np.testing.assert_array_equal(getattr(t, name).numpy(),
                                      np.asarray(getattr(j, name)), name)
    with pytest.raises(IndexError):
        tframe.remove(t, len(t.valid))
