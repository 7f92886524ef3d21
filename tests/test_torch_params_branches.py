"""Params branches that no default run switches on, held stage by stage
against the JAX package on the CPU.

Each case takes the module-scoped state of
tests/test_torch_stereo_pipeline.py (the tests/test_flame_e2e.py scene,
160x120, 512 features, a JAX Flame after 7 frames carried into the port
through convert.py), switches one Params branch on in both packages and
runs the stage that reads it:

- tracking, pipeline.track_project_sync against eager JAX
  (jax.disable_jit(): its compiled form rounds differently, see that
  file): detection.do_letterbox (the valid-region gate), do_meas_fusion
  off, fparams.sparams.do_subpixel off and do_grad_check_after_projection;
- detection, detection.do_letterbox through the poseframe detection of a
  tracking step (pipeline._detect_and_insert) and through the
  first-poseframe detection (pipeline.bootstrap_detect);
- the mesh filters, tri_filter.do_oblique_filter /
  do_edge_length_filter / do_idepth_filter off one at a time and all
  three off, through pipeline.mesh_outputs on the state's mesh with its
  vertex idepths perturbed (seeded) so that every filter drops
  triangles.

(adaptive_data_weights is a case of
tests/test_torch_stereo_pipeline.py::test_graph_sync_matches_jax; the BA
branches are in tests/test_torch_ba.py; detection.continuous and
solver.fetch_stride in tests/test_torch_flame_branches.py.)

Every case first checks that the branch changes the port's own output on
this state, so a branch whose `if` were inverted in the port would fail
the comparison. Tolerances are test_torch_stereo_pipeline.py's: decision
masks may differ on at most 0.5% of entries, floats agree to rtol 1e-4 /
atol 1e-4 where the decisions agree; detections and insertions are equal
exactly.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import test_torch_stereo_pipeline as sp  # noqa: E402
from flame_tpu.core import pipeline as jpipe  # noqa: E402
from flame_tpu_torch import convert  # noqa: E402
from flame_tpu_torch.core import pipeline  # noqa: E402

state = sp.state  # the module-scoped JAX Flame state and its port copy
W, H = sp.W, sp.H
GRAD_CHECK_MIN = 11.5  # Params.min_grad_mag for the projection check


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this module's small CPU tensors: the test
    workers run side by side, and more threads only oversubscribe the
    cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _sub(obj, **kw):
    return dataclasses.replace(obj, **kw)


def _branch_params(branch):
    """The JAX package's Params with one branch switched on, and the
    port's copy."""
    p = sp.make_params()
    if branch == "default":
        jp = p
    elif branch == "letterbox":
        jp = _sub(p, detection=_sub(p.detection, do_letterbox=True))
    elif branch == "no_meas_fusion":
        jp = _sub(p, do_meas_fusion=False)
    elif branch == "no_subpixel":
        jp = _sub(p, fparams=_sub(p.fparams, sparams=_sub(
            p.fparams.sparams, do_subpixel=False)))
    elif branch == "grad_check_after_projection":
        # Every member of this state sees a gradient of at least 9 (median
        # 13.7): at the default min_grad_mag of 5 the check drops none, at
        # GRAD_CHECK_MIN about a quarter.
        jp = _sub(p, do_grad_check_after_projection=True,
                  min_grad_mag=GRAD_CHECK_MIN)
    elif branch.endswith("_off"):
        f = p.tri_filter
        names = ("do_oblique_filter", "do_edge_length_filter",
                 "do_idepth_filter")
        if branch == "all_filters_off":
            off = names
        else:
            off = [n for n in names if n == f"do_{branch[:-4]}_filter"]
            assert len(off) == 1, branch
        jp = _sub(p, tri_filter=_sub(f, **{n: False for n in off}))
    else:
        raise ValueError(branch)
    return jp, convert.params_from_dict(dataclasses.asdict(jp))


def _port_track(s, tp):
    return pipeline.track_project_sync(tp, s["tK"], s["tKinv"], s["tstack"],
                                       s["tfeats"], s["tfn"],
                                       s["jf"]._curr_pf_slot)


@pytest.fixture(scope="module")
def port_default_track(state):
    return _port_track(state, _branch_params("default")[1])


@pytest.mark.parametrize("branch", ["letterbox", "no_meas_fusion",
                                    "no_subpixel",
                                    "grad_check_after_projection"])
def test_track_project_sync_branch_matches_jax(state, port_default_track,
                                               branch):
    s = state
    jp, tp = _branch_params(branch)
    with jax.disable_jit():
        jfe, jcu, jmem, jst, _ = jpipe.track_project_sync(
            jp, s["K"], s["Kinv"], s["jf"]._stack, s["jf"]._feats, s["jfn"],
            s["jf"]._curr_pf_slot)
    tfe, tcu, tmem, tst, _ = _port_track(s, tp)

    # The branch bites on this state.
    dfe, _, dmem, _, _ = port_default_track
    if branch == "letterbox":
        assert int((dfe.valid & ~tfe.valid).sum()) > 20
        rows = tcu.xy[tcu.valid, 1]
        assert bool(((rows >= H // 3 + tp.border)
                     & (rows < H - H // 3 - tp.border)).all())
    elif branch == "grad_check_after_projection":
        assert int((dmem & ~tmem).sum()) > 0
        assert not bool((tmem & ~dmem).any())
    else:
        both = dfe.valid & tfe.valid
        assert int((dfe.idepth_mu[both] != tfe.idepth_mu[both]).sum()) > 20

    assert int(np.asarray(jfe.valid).sum()) > 20
    ok = sp._flips(jfe.valid, tfe.valid.numpy())
    ok &= sp._flips(jfe.search_status, tfe.search_status.numpy())
    ok &= sp._flips(jmem, tmem.numpy())
    ok &= sp._flips(jfe.num_updates, tfe.num_updates.numpy())
    ok &= sp._flips(jfe.pf_slot, tfe.pf_slot.numpy())
    v = ok & np.asarray(jfe.valid)
    for name in ("xy", "idepth_mu", "idepth_var"):
        sp._close(getattr(jfe, name), getattr(tfe, name), v)
    for name in ("xy", "idepth", "var"):
        sp._close(getattr(jcu, name), getattr(tcu, name), v)
    np.testing.assert_allclose(tst.numpy(), np.asarray(jst),
                               atol=max(2, sp.MAX_FLIPS * 512))


def _detect_inputs(s):
    """tracked_default's state of frame 7 for both packages' detection:
    the JAX and the port feature state and projected features."""
    jfe, jcu = s["_branch_tracked"]
    return jfe, jcu, convert.feature_state_from_numpy(sp._np(jfe), "cpu"), \
        convert.curr_features_from_numpy(sp._np(jcu), "cpu")


@pytest.fixture(scope="module")
def tracked_default(state):
    """Frame 7 tracked by eager JAX with half of the features dropped
    (seeded), so that detection finds free cells in every band of rows."""
    s = state
    with jax.disable_jit():
        jfe, jcu = jpipe.track_project_sync(
            s["jp"], s["K"], s["Kinv"], s["jf"]._stack, s["jf"]._feats,
            s["jfn"], s["jf"]._curr_pf_slot)[:2]
    keep = jnp.asarray(np.random.default_rng(14).uniform(
        size=jfe.valid.shape) < 0.5)
    s["_branch_tracked"] = (jfe._replace(valid=jfe.valid & keep),
                            jcu._replace(valid=jcu.valid & keep))
    return s


def _seed_map():
    seed = np.full((H, W), np.nan, np.float32)
    seed[40:80, 50:110] = 0.21
    return seed


def _run_detection(s, jp, tp, where):
    """Detection + insertion at `where` in both packages; returns the
    JAX and the port FeatureState as dicts of numpy arrays."""
    jfe, jcu, tfe, tcu = _detect_inputs(s)
    slot = s["jf"]._curr_pf_slot
    seed = _seed_map()
    # The poseframe is frame 6; frame 7 gives the epipolar direction (as
    # in test_torch_stereo_pipeline.py's detection case).
    prev = s["jfn"]
    pq, pt = np.asarray(prev.q), np.asarray(prev.t)
    if where == "track_step":
        j = jpipe._detect_and_insert(
            jp, s["K"], s["Kinv"], s["jf"]._stack, slot, jfe, jcu, s["jfn"],
            prev.q, prev.t, 1000, jnp.asarray(seed))
        t = pipeline._detect_and_insert(
            tp, s["tK"], s["tKinv"], s["tstack"], slot, tfe, tcu,
            torch.as_tensor(pq), torch.as_tensor(pt), 1000,
            torch.as_tensor(seed))
    else:  # the first poseframe: nothing tracked yet
        jempty = jpipe.empty_features(jfe.valid.shape[0])
        tempty = pipeline.empty_features(jfe.valid.shape[0], "cpu")
        nxy = np.zeros((jfe.valid.shape[0], 2), np.float32)
        nval = np.zeros(jfe.valid.shape[0], bool)
        j, _ = jpipe.bootstrap_detect(
            jp, s["K"], s["Kinv"], s["jf"]._stack, jempty, prev.q, prev.t,
            slot, jnp.asarray(seed), 0, jnp.asarray(nxy), jnp.asarray(nval))
        t, _ = pipeline.bootstrap_detect(
            tp, s["tK"], s["tKinv"], s["tstack"], tempty,
            torch.as_tensor(pq), torch.as_tensor(pt), slot,
            torch.as_tensor(seed), 0, torch.as_tensor(nxy),
            torch.as_tensor(nval))
    return sp._np(j), {k: v.numpy() for k, v in dataclasses.asdict(
        t).items()}


@pytest.mark.parametrize("where", ["track_step", "bootstrap"])
def test_letterbox_detection_matches_jax(tracked_default, where):
    s = tracked_default
    jp, tp = _branch_params("letterbox")
    j, t = _run_detection(s, jp, tp, where)
    _, d = _run_detection(s, *_branch_params("default"), where)
    for name, a in j.items():
        np.testing.assert_array_equal(t[name], a, err_msg=name)
    # New features (the ones the default run adds too) lie in the middle
    # third of the rows only, and the band removes some of the default's.
    jfe = s["_branch_tracked"][0]
    before = np.asarray(jfe.valid) if where == "track_step" else \
        np.zeros_like(t["valid"])
    new = t["valid"] & ~before
    d_new = d["valid"] & ~before
    assert 0 < new.sum() < d_new.sum()
    y = t["xy"][new, 1]
    assert ((y >= H // 3 + tp.border) & (y < H - H // 3 - tp.border)).all()


@pytest.fixture(scope="module")
def filter_mesh(state):
    """The JAX Flame's mesh with its vertex idepths perturbed (seeded):
    a tenth of the vertices far away (idepth 0.005) and the rest within
    +-40%, so the oblique, edge-length and idepth filters all drop
    triangles."""
    s = state
    jf = s["jf"]
    T = s["jp"].triangle_capacity
    tris = np.zeros((T, 3), np.int32)
    tris[:jf._n_tris] = jf._tris_np[:jf._n_tris]
    g = jf._graph
    tri_mask = (np.arange(T) < jf._n_tris) \
        & np.asarray(g.vtx_mask)[tris].all(1)
    rng = np.random.default_rng(14)
    x = np.asarray(g.x).copy()
    x *= rng.uniform(0.6, 1.4, x.shape).astype(np.float32)
    x[rng.uniform(size=x.shape) < 0.1] = 0.005
    jg = g._replace(x=jnp.asarray(x))
    tg = convert.graph_state_from_numpy(sp._np(jg), "cpu")
    return jg, tg, tris, tri_mask


def _mesh_outputs(s, jp, tp, filter_mesh):
    jg, tg, tris, tri_mask = filter_mesh
    jo = jpipe.mesh_outputs(jp, s["K"], s["Kinv"], W, H, jg,
                            jnp.asarray(tris), jnp.asarray(tri_mask),
                            jnp.float32(1.0))
    to = pipeline.mesh_outputs(tp, s["tK"], s["tKinv"], W, H, tg,
                               torch.as_tensor(tris).long(),
                               torch.as_tensor(tri_mask), 1.0)
    return jo, to


@pytest.mark.parametrize("branch", ["oblique_off", "edge_length_off",
                                    "idepth_off", "all_filters_off"])
def test_mesh_filters_branch_matches_jax(state, filter_mesh, branch):
    s = state
    jp, tp = _branch_params(branch)
    jo, to = _mesh_outputs(s, jp, tp, filter_mesh)
    _, dto = _mesh_outputs(s, *_branch_params("default"), filter_mesh)
    tri_mask = filter_mesh[3]
    on, off = dto[2].numpy(), to[2].numpy()
    # Every filter drops triangles here, so switching it off keeps more.
    assert not (on & ~off).any()
    assert (off & ~on).sum() >= 1
    if branch == "all_filters_off":
        np.testing.assert_array_equal(off, tri_mask)
    np.testing.assert_array_equal(off, np.asarray(jo[2]))
    sp._close(jo[0], to[0])
    sp._close(jo[1], to[1])
    jidm, tidm = np.asarray(jo[3]), to[3].numpy()
    both = sp._flips(np.isnan(jidm), np.isnan(tidm)) & ~np.isnan(jidm)
    sp._close(jidm, tidm, both)
