"""flame_tpu_torch pipeline stages against the JAX package, given the same
input state.

A JAX Flame runs the tests/test_flame_e2e.py scene (uint8 frames) for a
few frames; its state is carried into the port through convert.py and
both packages run the next stage on it: track_project_sync,
detect_packed, insert_detections, _graph_sync_inner (with its
rescale_data / init_with_prediction / check_sticky_obstacles /
adaptive_data_weights branches),
_post_delaunay_inner and mesh_outputs.

Tolerances: decision masks (status, member, valid, covered pixels) may
differ on at most 0.5% of entries, because float sums are taken in
another order and the flips sit at thresholds; float outputs agree to
rtol 1e-4 / atol 1e-4 where the decisions agree.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from flame_tpu.core import detection as jdet  # noqa: E402
from flame_tpu.core import frame as jframe  # noqa: E402
from flame_tpu.core import pipeline as jpipe  # noqa: E402
from flame_tpu.core.flame import Flame as JFlame  # noqa: E402
from flame_tpu.geometry import camera as jcam  # noqa: E402
from flame_tpu.geometry import epipolar as jepi  # noqa: E402
from flame_tpu.optimize import topology as jtopo  # noqa: E402
from flame_tpu.params import (DetectionParams, Params,  # noqa: E402
                              SolverParams)
from flame_tpu_torch import convert  # noqa: E402
from flame_tpu_torch.core import detection, pipeline  # noqa: E402
from flame_tpu_torch.core import frame as tframe  # noqa: E402
from flame_tpu_torch.geometry import epipolar  # noqa: E402
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


def make_params(**kw):
    return Params(
        feature_capacity=512, edge_capacity=2048, triangle_capacity=1024,
        poseframe_capacity=8, min_height=-100.0, max_height=100.0,
        idepth_init=0.05, idepth_var_init=0.25, photo_error_num_pfs=0,
        detection=DetectionParams(win_size=16),
        solver=SolverParams(n_iters_per_frame=30, max_vertex_degree=16),
        debug_quiet=True, **kw)


def _np(x):
    return {k: np.asarray(v) for k, v in x._asdict().items()}


def _pose(i):
    return (np.array([1.0, 0, 0, 0], np.float32),
            np.array([0.15 * i, 0, 0], np.float32))


@pytest.fixture(scope="module")
def state():
    """JAX Flame after 7 frames; the inputs of frame 7 for both packages."""
    jp = make_params()
    K = jcam.make_k(FX, FX, W / 2, H / 2)
    Kinv = jcam.inv_k(K)
    jf = JFlame(W, H, K, Kinv, jp)
    for i in range(7):
        q, t = _pose(i)
        jf.update(i * 0.1, i, (jnp.asarray(q), jnp.asarray(t)), render(0.15 * i),
                  i % 2 == 0)
    q, t = _pose(7)
    jfn = jframe.create(7, jnp.asarray(q), jnp.asarray(t),
                        jnp.asarray(render(0.15 * 7)), jp.pad)
    dev = "cpu"
    tp = convert.params_from_dict(dataclasses.asdict(jp))
    tK = torch.as_tensor(np.array(K))
    tKinv = torch.as_tensor(np.array(Kinv))
    tstack = convert.frame_stack_from_numpy(_np(jf._stack), dev)
    tfn = tframe.create(7, torch.as_tensor(q), torch.as_tensor(t),
                        torch.as_tensor(render(0.15 * 7)), tp.pad)
    return dict(jp=jp, tp=tp, K=K, Kinv=Kinv, tK=tK, tKinv=tKinv, jf=jf,
                jfn=jfn, tfn=tfn, tstack=tstack,
                tfeats=convert.feature_state_from_numpy(_np(jf._feats), dev),
                tgraph=convert.graph_state_from_numpy(_np(jf._graph), dev))


def _flips(a, b):
    a, b = np.asarray(a), np.asarray(b)
    bad = a != b
    assert bad.mean() <= MAX_FLIPS, (int(bad.sum()), a.size)
    return ~bad


def _close(a, b, where=None):
    a = np.asarray(a)
    b = b.numpy() if isinstance(b, torch.Tensor) else np.asarray(b)
    if where is not None:
        a, b = a[where], b[where]
    np.testing.assert_allclose(b, a, rtol=RTOL, atol=ATOL)


def test_frame_create_matches_jax(state):
    jfn, tfn = state["jfn"], state["tfn"]
    for name in ("img", "img_pad", "gradx", "grady"):
        np.testing.assert_array_equal(getattr(tfn, name).numpy(),
                                      np.asarray(getattr(jfn, name)))


@pytest.fixture(scope="module")
def tracked(state):
    """Frame 7's tracking step in both packages. The JAX side runs
    eagerly: its XLA-compiled form rounds differently and moves the
    measured idepth of about a tenth of the features here (by up to 7%)
    away from its own eager result, which the port reproduces."""
    s = state
    slot = s["jf"]._curr_pf_slot
    with jax.disable_jit():
        ja = jpipe.track_project_sync(s["jp"], s["K"], s["Kinv"],
                                      s["jf"]._stack, s["jf"]._feats,
                                      s["jfn"], slot)
    ta = pipeline.track_project_sync(s["tp"], s["tK"], s["tKinv"],
                                     s["tstack"], s["tfeats"], s["tfn"], slot)
    return ja, ta


def test_track_project_sync_matches_jax(tracked):
    (jfe, jcu, jmem, jst, _), (tfe, tcu, tmem, tst, _) = tracked
    assert int(np.asarray(jfe.valid).sum()) > 50
    ok = _flips(jfe.valid, tfe.valid.numpy())
    ok &= _flips(jfe.search_status, tfe.search_status.numpy())
    ok &= _flips(jmem, tmem.numpy())
    ok &= _flips(jfe.num_updates, tfe.num_updates.numpy())
    ok &= _flips(jfe.pf_slot, tfe.pf_slot.numpy())
    v = ok & np.asarray(jfe.valid)
    for name in ("xy", "idepth_mu", "idepth_var"):
        _close(getattr(jfe, name), getattr(tfe, name), v)
    for name in ("xy", "idepth", "var"):
        _close(getattr(jcu, name), getattr(tcu, name), v)
    np.testing.assert_allclose(tst.numpy(), np.asarray(jst),
                               atol=max(2, 0.005 * 512))


@pytest.fixture(scope="module")
def detected(state, tracked):
    s = state
    jfe, jcu = tracked[0][0], tracked[0][1]
    slot = s["jf"]._curr_pf_slot
    prev = s["jfn"]  # frame 7 against the frame-6 poseframe
    geo = jepi.load_relative(s["K"], s["Kinv"], (s["jf"]._stack.q[slot],
                                                 s["jf"]._stack.t[slot]),
                             (prev.q, prev.t))
    jout = jdet.detect_packed(geo, s["jf"]._stack.gradx[slot],
                              s["jf"]._stack.grady[slot], jcu.xy, jcu.valid,
                              5.0, 16, s["jp"].border)
    tgeo = epipolar.load_relative(
        s["tK"], s["tKinv"], (s["tstack"].q[slot], s["tstack"].t[slot]),
        (s["tfn"].q, s["tfn"].t))
    tout = detection.detect_packed(
        tgeo, s["tstack"].gradx[slot], s["tstack"].grady[slot],
        torch.as_tensor(np.asarray(jcu.xy)),
        torch.as_tensor(np.asarray(jcu.valid)), 5.0, 16, s["tp"].border)
    return jout, tout


def test_detect_packed_matches_jax(detected):
    jout, tout = detected
    jout = np.asarray(jout)
    assert jout[:, 2].sum() > 0
    np.testing.assert_array_equal(tout.numpy(), jout)


def test_insert_detections_matches_jax(state, tracked, detected):
    s = state
    jfe = tracked[0][0]
    jout = detected[0]
    seed = np.full((H, W), np.nan, np.float32)
    seed[40:80, 50:110] = 0.21
    j = jpipe.insert_detections(s["jp"], jfe, jout, 3, jnp.asarray(seed),
                                1000)
    t = pipeline.insert_detections(
        s["tp"], convert.feature_state_from_numpy(_np(jfe), "cpu"),
        torch.as_tensor(np.asarray(jout)), 3, torch.as_tensor(seed), 1000)
    for name, a in _np(j).items():
        np.testing.assert_array_equal(getattr(t, name).numpy(), a,
                                      err_msg=name)


def _topology(state, jcu, jmem):
    """Host Delaunay of the tracked members, through the JAX Flame's own
    host code; returns the separate tris/edges/ranks both packages take."""
    s = state
    jf = s["jf"]
    packed = np.asarray(jpipe.pack_track_outputs(tracked_feats(state),
                                                 jcu, jmem))
    buf, n_tris, tris_slots, edges_sorted, n_edges = \
        jf._host_triangulate(packed)
    T, E = s["jp"].triangle_capacity, s["jp"].edge_capacity
    rk = buf[2 + 3 * T + E: 2 + 3 * T + 2 * E].astype(np.int64)
    ranks = np.stack([rk & 0xFF, rk >> 8], axis=1).astype(np.uint8)
    tris = np.zeros((T, 3), np.int32)
    tris[:n_tris] = tris_slots
    edges = np.zeros((E, 2), np.int32)
    edges[:n_edges] = edges_sorted
    return tris, n_tris, edges, n_edges, ranks


def tracked_feats(state):
    return state["_tracked"][0][0]


@pytest.fixture(scope="module")
def post_inputs(state, tracked):
    state["_tracked"] = tracked
    jfe, jcu, jmem = tracked[0][:3]
    return _topology(state, jcu, jmem)


def _graph_close(jg, tg, member):
    m = np.asarray(member)
    for name in ("x", "w1", "w2", "x_bar", "w1_bar", "w2_bar", "data_term",
                 "data_weight"):
        _close(getattr(jg, name), getattr(tg, name), m)
    np.testing.assert_array_equal(tg.vtx_mask.numpy(), m)
    em = np.asarray(jg.edge_mask)
    np.testing.assert_array_equal(tg.edge_mask.numpy(), em)
    for name in ("q1", "q2", "q3", "alpha"):
        _close(getattr(jg, name), getattr(tg, name), em)


@pytest.mark.parametrize("variant", ["default", "rescale_data",
                                     "init_with_prediction",
                                     "check_sticky_obstacles",
                                     "adaptive_data_weights"])
def test_graph_sync_matches_jax(state, tracked, post_inputs, variant):
    s = state
    kw = {} if variant == "default" else {variant: True}
    jp = make_params(**kw)
    tp = convert.params_from_dict(dataclasses.asdict(jp))
    jfe, jcu, jmem = tracked[0][:3]
    tris, n_tris, edges, n_edges, ranks = post_inputs
    g = s["jf"]._graph
    V, E, D = 512, 2048, 16
    jt = jtopo.from_edges(jnp.asarray(edges), n_edges, jcu.xy, g.edges,
                          g.edge_mask, g.q1, g.q2, g.q3, E, V, D,
                          build_incidence=True, ranks=jnp.asarray(ranks))
    tt = topology.Topology(**{
        k: (int(v) if k == "n_edges" else torch.as_tensor(np.array(v)).to(
            torch.int64 if k in ("edges", "inc_edge", "src_slot")
            else None))
        for k, v in jt._asdict().items()})
    prev = s["jf"]._fnew
    q6, t6 = np.asarray(prev.q), np.asarray(prev.t)
    q7, t7 = _pose(7)
    jgeo = jepi.load_relative(s["K"], s["Kinv"], (prev.q, prev.t),
                              (jnp.asarray(q7), jnp.asarray(t7)))
    tgeo = epipolar.load_relative(s["tK"], s["tKinv"],
                                  (torch.as_tensor(q6), torch.as_tensor(t6)),
                                  (torch.as_tensor(q7), torch.as_tensor(t7)))
    idm = np.asarray(s["jf"]._idepthmap)
    scale = 0.8 if variant == "rescale_data" else 1.0
    jg = jpipe._graph_sync_inner(jp, g, g.vtx_mask, jmem, jcu, jgeo,
                                 jnp.float32(scale), jt, jnp.asarray(idm))
    tg = pipeline._graph_sync_inner(
        tp, s["tgraph"], s["tgraph"].vtx_mask, torch.as_tensor(
            np.asarray(jmem)),
        convert.curr_features_from_numpy(_np(jcu), "cpu"), tgeo,
        torch.tensor(scale), tt, torch.as_tensor(idm))
    _graph_close(jg, tg, jmem)
    if variant == "adaptive_data_weights":  # 1/var, not the default 1
        w = tg.data_weight.numpy()[np.asarray(jmem)]
        assert w.size > 50 and (np.abs(w - 1.0) > 0.5).all()


def test_post_delaunay_matches_jax(state, tracked, post_inputs):
    s = state
    jfe, jcu, jmem = tracked[0][:3]
    tris, n_tris, edges, n_edges, ranks = post_inputs
    prev = s["jf"]._fnew
    q7, t7 = _pose(7)
    jout = jpipe._post_delaunay_inner(
        s["jp"], s["K"], s["Kinv"], s["jf"]._graph, jmem, jcu,
        (prev.q, prev.t), (jnp.asarray(q7), jnp.asarray(t7)),
        jnp.float32(1.0), W, H, tris=jnp.asarray(tris), n_tris=n_tris,
        edges=jnp.asarray(edges), n_edges=n_edges,
        edge_ranks=jnp.asarray(ranks))
    tout = pipeline._post_delaunay_inner(
        s["tp"], s["tK"], s["tKinv"], s["tgraph"],
        torch.as_tensor(np.asarray(jmem)),
        convert.curr_features_from_numpy(_np(jcu), "cpu"),
        (torch.as_tensor(np.asarray(prev.q)),
         torch.as_tensor(np.asarray(prev.t))),
        (torch.as_tensor(q7), torch.as_tensor(t7)), torch.tensor(1.0), W, H,
        tris=torch.as_tensor(tris), n_tris=n_tris,
        edges=torch.as_tensor(edges), n_edges=n_edges,
        edge_ranks=torch.as_tensor(ranks))
    jg, jvi, jn, jtv, jidm, jscale, jcov = jout
    tg, tvi, tn, ttv, tidm, tscale, tcov = tout
    _graph_close(jg, tg, jmem)
    _close(jvi, tvi)
    _close(jn, tn)
    _flips(jtv, ttv.numpy())
    jidm, tidm = np.asarray(jidm), tidm.numpy()
    both = _flips(np.isnan(jidm), np.isnan(tidm)) & ~np.isnan(jidm)
    _close(jidm, tidm, both)
    assert abs(float(jcov) - float(tcov)) <= MAX_FLIPS
    assert float(tcov) > 0.3


def test_mesh_outputs_matches_jax(state):
    s = state
    jf = s["jf"]
    T = s["jp"].triangle_capacity
    tris = np.zeros((T, 3), np.int32)
    tris[:jf._n_tris] = jf._tris_np[:jf._n_tris]
    g = jf._graph
    tri_mask = (np.arange(T) < jf._n_tris) \
        & np.asarray(g.vtx_mask)[tris].all(1)
    jo = jpipe.mesh_outputs(s["jp"], s["K"], s["Kinv"], W, H, g,
                            jnp.asarray(tris), jnp.asarray(tri_mask),
                            jnp.float32(1.0))
    to = pipeline.mesh_outputs(s["tp"], s["tK"], s["tKinv"], W, H,
                               s["tgraph"], torch.as_tensor(tris).long(),
                               torch.as_tensor(tri_mask), 1.0)
    _close(jo[0], to[0])
    _close(jo[1], to[1])
    _flips(jo[2], to[2].numpy())
    jidm, tidm = np.asarray(jo[3]), to[3].numpy()
    both = _flips(np.isnan(jidm), np.isnan(tidm)) & ~np.isnan(jidm)
    assert both.mean() > 0.3
    _close(jidm, tidm, both)


def test_frame_track_step_fuses_create_insert_and_track(state):
    """frame_track_step == create + poseframe insert + track_step."""
    s = state
    q, t = (torch.as_tensor(a) for a in _pose(7))
    img = torch.as_tensor(render(0.15 * 7))
    slot = s["jf"]._curr_pf_slot
    seed = torch.full((H, W), float("nan"))

    def fresh_stack():
        return convert.frame_stack_from_numpy(_np(s["jf"]._stack), "cpu")
    fused_stack = fresh_stack()
    fused = pipeline.frame_track_step(
        s["tp"], s["tK"], s["tKinv"], fused_stack, s["tfeats"], img, 7, q,
        t, slot, q, t, 0, seed, do_detect=True, do_insert=True)
    stack = fresh_stack()
    fnew = tframe.create(7, q, t, img, s["tp"].pad)
    tframe.insert(stack, slot, fnew)
    ref = pipeline.track_step(s["tp"], s["tK"], s["tKinv"], stack,
                              s["tfeats"], fnew, slot, q, t, True, 0, seed)
    assert torch.equal(fused_stack.img_pad, stack.img_pad)
    assert torch.equal(fused[-1], ref[-1])  # packed snapshot
    assert torch.equal(fused[1].valid, ref[0].valid)
