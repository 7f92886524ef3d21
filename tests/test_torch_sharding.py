"""flame_tpu_torch's multi-chip layer against the JAX package on the CPU.

The JAX side runs on the 8 virtual CPU devices of tests/conftest.py; the
port's mesh is n partitions of the CPU. Inputs: tests/test_nltgv2.py's
grid graph (n=6, V=64, E=256, D=12, noise 0.3, seed 21), tests/test_ba.py's
window (build_problem(rng=77)) and the state of
__graft_entry__.dryrun_multichip (capacities 1024/1024, the 32-vertex
ring graph, 64x96), carried into the port through convert.py.

Tolerances: one iteration (nltgv2.step) atol 1e-6; 25 iterations of
every smooth mode and of sharded_smooth at 1, 2, 4 and 8 partitions atol
1e-5 (the JAX test's: the same arithmetic, float sums in another order);
the BA solves atol 1e-4 on q, t and lm (the JAX test's); the host tables
and the traffic model exactly. The sharded step's tracking is held to
the port's unsharded track_project_sync bit for bit and to eager JAX as
tests/test_torch_stereo_pipeline.py holds it; only its graph is held to
JAX's sharded step, since JAX's jitted tracking rounds otherwise.
"""

import dataclasses
import os
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from flame_tpu.core import pipeline as jpipe  # noqa: E402
from flame_tpu.optimize import nltgv2 as jnl  # noqa: E402
from flame_tpu.optimize import pallas_smoother as jps  # noqa: E402
from flame_tpu.parallel import distributed_ba as jdba  # noqa: E402
from flame_tpu.parallel import sharding as jsh  # noqa: E402
from flame_tpu.params import BAParams as JBAParams  # noqa: E402
from flame_tpu.params import RegularizerParams as JRegParams  # noqa: E402
from flame_tpu_torch import convert  # noqa: E402
from flame_tpu_torch.ba import schur  # noqa: E402
from flame_tpu_torch.core import frame as tframe  # noqa: E402
from flame_tpu_torch.core import pipeline  # noqa: E402
from flame_tpu_torch.optimize import nltgv2  # noqa: E402
from flame_tpu_torch.parallel import distributed_ba, sharding  # noqa: E402
from flame_tpu_torch.params import BAParams, RegularizerParams  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)
sys.path.insert(0, os.path.dirname(HERE))

from test_ba import build_problem  # noqa: E402
from test_nltgv2 import make_grid_graph  # noqa: E402

pytestmark = pytest.mark.skipif(
    len(jax.devices()) < 8, reason="needs 8 (virtual) devices")

# The dry run's frames are a smooth periodic image and its features see a
# 2 px disparity: there the SSD subpixel step is ill-conditioned, and the
# two packages' matches (the same arithmetic, patch sums in another
# order) differ by up to 0.013 px, moving fused idepths and variances by
# up to 0.35% (the stage tests' textured scene agrees to 1e-4).
TRACK_RTOL = 1e-2
TRACK_PX = 0.02
FIELDS = ("x", "w1", "w2", "x_bar", "w1_bar", "w2_bar", "q1", "q2", "q3")
N_ITERS = 25
PARTS = (1, 2, 4, 8)


def _np(tree):
    return {k: (None if v is None else np.asarray(v))
            for k, v in tree._asdict().items()}


def _port_graph(jg):
    return convert.graph_state_from_numpy(_np(jg), "cpu")


def _assert_fields(tg, jg, atol, fields=FIELDS):
    for name in fields:
        np.testing.assert_allclose(getattr(tg, name).numpy(),
                                   np.asarray(getattr(jg, name)), atol=atol,
                                   rtol=0, err_msg=name)


@pytest.fixture(scope="module")
def grid():
    jg, _, _ = make_grid_graph(n=6, v_cap=64, e_cap=256, degree=12,
                               noise=0.3, seed=21)
    return jg, _port_graph(jg)


@pytest.fixture(scope="module")
def jax_sharded(grid):
    """JAX's sharded_smooth on 8 devices, and its LAST_TRAFFIC."""
    jg, _ = grid
    mesh = jsh.make_mesh(jax.devices()[:8])
    out = jsh.sharded_smooth(JRegParams(), jg, N_ITERS, mesh)
    return jax.tree.map(np.asarray, out), dict(jsh.LAST_TRAFFIC)


def test_build_incidence_and_src_slot_match_jax(grid):
    jg, _ = grid
    edges = np.asarray(jg.edges)
    em = np.asarray(jg.edge_mask)
    for degree in (3, 12):  # with and without dropped entries
        je, js = jnl.build_incidence(edges, em, 64, degree)
        te, ts = nltgv2.build_incidence(edges, em, 64, degree)
        np.testing.assert_array_equal(te, je)
        np.testing.assert_array_equal(ts, js)
        assert te.dtype == je.dtype and ts.dtype == js.dtype
        np.testing.assert_array_equal(nltgv2.build_src_slot(te, ts, 256),
                                      jnl.build_src_slot(je, js, 256))


@pytest.mark.parametrize("use_incidence", [False, True])
def test_step_matches_jax(grid, use_incidence):
    jg, tg = grid
    # From a state with nonzero duals, so that every term is exercised.
    jg = jnl.smooth(JRegParams(), jg, 5)
    tg = _port_graph(jg)
    j1 = jnl.step(JRegParams(), jg, use_incidence=use_incidence)
    t1 = nltgv2.step(RegularizerParams(), tg, use_incidence=use_incidence)
    _assert_fields(t1, j1, 1e-6)


@pytest.mark.parametrize("name", [
    "_dual_step", "_primal_step_segment", "_primal_step_incidence",
    "_extragradient_step", "_primal_edge_terms"])
def test_field_functions_match_jax(grid, name):
    """Each piece of the field-per-field iteration on a state with nonzero
    duals and bars (5 iterations in), atol 1e-6."""
    jg = jnl.smooth(JRegParams(), grid[0], 5)
    tg = _port_graph(jg)
    jp, tp = JRegParams(), RegularizerParams()
    if name == "_extragradient_step":
        prev = (0.9 * jg.x, 0.5 * jg.w1, -jg.w2)
        j = jnl._extragradient_step(jp, jg, *prev)
        t = nltgv2._extragradient_step(
            tp, tg, *(torch.as_tensor(np.array(a)) for a in prev))
    else:
        j = getattr(jnl, name)(jp, jg)
        t = getattr(nltgv2, name)(tp, tg)
    if name == "_primal_edge_terms":
        for a, b in zip(t, j):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-6,
                                       rtol=0)
    else:
        _assert_fields(t, j, 1e-6)


@pytest.mark.parametrize("mode,use_incidence", [
    ("vertex", False), ("stacked", False), ("step", False), ("step", True)])
def test_smooth_matches_jax(grid, mode, use_incidence):
    jg, tg = grid
    j = jnl.smooth(JRegParams(), jg, N_ITERS, use_incidence=use_incidence,
                   mode=mode)
    t = nltgv2.smooth(RegularizerParams(), tg, N_ITERS,
                      use_incidence=use_incidence, mode=mode)
    _assert_fields(t, j, 1e-5)


def test_smooth_legacy_flags_and_unknown_mode(grid):
    _, tg = grid
    p = RegularizerParams()
    a = nltgv2.smooth(p, tg, 3, stacked=False)
    b = nltgv2.smooth(p, tg, 3, mode="step")
    for name in FIELDS:
        assert torch.equal(getattr(a, name), getattr(b, name)), name
    with pytest.raises(ValueError):
        nltgv2.smooth(p, tg, 3, mode="no_such_mode")


@pytest.mark.parametrize("n", PARTS)
def test_sharded_smooth_matches_jax(grid, jax_sharded, n):
    _, tg = grid
    out = sharding.sharded_smooth(RegularizerParams(), tg, N_ITERS,
                                  sharding.make_mesh(n, "cpu"))
    _assert_fields(out, jax_sharded[0], 1e-5)
    # The graph's other fields pass through.
    assert out.edges is tg.edges and out.inc_edge is tg.inc_edge


def test_sharded_smooth_energy_decreases():
    p = RegularizerParams(step_x=0.01, step_q=12.5)
    jg, _, _ = make_grid_graph(n=6, v_cap=64, e_cap=256, degree=12,
                               noise=0.4, seed=23)
    g = _port_graph(jg)
    e0 = float(nltgv2.energy(p, g))
    g1 = sharding.sharded_smooth(p, g, 200, sharding.make_mesh(8, "cpu"))
    assert float(nltgv2.energy(p, g1)) < e0


def test_psum_traffic_model_matches_jax(grid, jax_sharded):
    for V, n, iters in ((4096, 1, 40), (4096, 4, 40), (16384, 8, 25),
                        (100, 3, 1)):
        assert sharding.psum_traffic_model(V, n, iters) == \
            jsh.psum_traffic_model(V, n, iters)
    sharding.sharded_smooth(RegularizerParams(), grid[1], N_ITERS,
                            sharding.make_mesh(8, "cpu"))
    assert sharding.LAST_TRAFFIC == jax_sharded[1]


def test_psum_sums_in_partition_order():
    parts = torch.tensor([[1e8], [1.0], [-1e8]], dtype=torch.float32)
    mesh = sharding.make_mesh(3, "cpu")
    # ((1e8 + 1) - 1e8) in float32 is 0: left to right, not pairwise.
    assert float(sharding.psum(parts, mesh)) == 0.0
    assert float(sharding.psum([torch.ones(2)] * 3, mesh)[1]) == 3.0


def test_divisibility_errors(grid):
    _, tg = grid
    with pytest.raises(ValueError):  # 256 edges over 3 partitions
        sharding.sharded_smooth(RegularizerParams(), tg, 1,
                                sharding.make_mesh(3, "cpu"))
    p = _dryrun_params()
    for bad in (dict(feature_capacity=1020), dict(edge_capacity=1022)):
        with pytest.raises(ValueError):
            sharding.sharded_update_step(p.replace(**bad),
                                         sharding.make_mesh(8, "cpu"))
    with pytest.raises(ValueError):
        sharding.sharded_update_step(p, sharding.make_mesh(4, "cpu"),
                                     smoother="vertex")


# ---------------------------------------------------------------------------
# The sharded update step on the dry run's state.
# ---------------------------------------------------------------------------


def _dryrun_jax_params():
    import __graft_entry__ as ge
    return ge._small_params(feature_capacity=1024, edge_capacity=1024)


def _dryrun_params():
    return convert.params_from_dict(dataclasses.asdict(_dryrun_jax_params()))


@pytest.fixture(scope="module")
def dryrun():
    return dryrun_state()


def dryrun_state():
    """__graft_entry__.dryrun_multichip's state for 4 devices in both
    packages, with the RCM order and ranks of its ring graph
    (tests/test_torch_multihost.py runs it over a process group)."""
    import __graft_entry__ as ge
    jp = _dryrun_jax_params()
    fc, ec = jp.feature_capacity, jp.edge_capacity
    K, Kinv, stack, feats, fnew, graph = ge._synthetic_state(jp, 64, 96)
    nv = 32
    edges = np.zeros((ec, 2), np.int64)
    edges[:nv, 0] = np.arange(nv)
    edges[:nv, 1] = (np.arange(nv) + 1) % nv
    emask = np.arange(ec) < nv
    vmask = np.arange(fc) < nv
    rng = np.random.default_rng(0)
    x = rng.uniform(0.1, 0.3, fc).astype(np.float32)
    graph = graph._replace(
        pos=jnp.asarray(rng.uniform(0, 60, (fc, 2)).astype(np.float32)),
        x=jnp.asarray(x), x_bar=jnp.asarray(x),
        data_term=jnp.full((fc,), 0.2, jnp.float32),
        data_weight=jnp.asarray(vmask.astype(np.float32)),
        vtx_mask=jnp.asarray(vmask),
        edges=jnp.asarray(edges.astype(np.int32)),
        alpha=jnp.asarray(emask.astype(np.float32) * 0.2),
        beta=jnp.asarray(emask.astype(np.float32)),
        edge_mask=jnp.asarray(emask))
    reach = jp.solver.pallas_reach
    perm = jps.rcm_order(edges[:nv], nv, fc, vmask)
    inv = np.empty(fc, np.int32)
    inv[perm] = np.arange(fc, dtype=np.int32)
    ranks = jps.perm_edge_ranks(edges[:nv], nv, inv, ec,
                                jp.solver.max_vertex_degree, reach)
    dev = "cpu"
    tfn = tframe.Frame(frame_id=1, **{
        k: torch.as_tensor(np.array(getattr(fnew, k)))
        for k in ("q", "t", "img", "img_pad", "gradx", "grady")})
    return dict(
        jp=jp, jargs=(K, Kinv, stack, feats, fnew, 0, graph),
        jrcm=(jnp.asarray(perm), jnp.asarray(inv), jnp.asarray(ranks)),
        tp=_dryrun_params(),
        targs=(torch.as_tensor(np.array(K)),
               torch.as_tensor(np.array(Kinv)),
               convert.frame_stack_from_numpy(_np(stack), dev),
               convert.feature_state_from_numpy(_np(feats), dev), tfn, 0,
               _port_graph(graph)),
        trcm=tuple(torch.as_tensor(a.astype(np.int64))
                   for a in (perm, inv, ranks)))


@pytest.fixture(scope="module")
def eager_jax_tracking(dryrun):
    K, Kinv, stack, feats, fnew, slot, _ = dryrun["jargs"]
    with jax.disable_jit():
        return jpipe.track_project_sync(dryrun["jp"], K, Kinv, stack, feats,
                                        fnew, slot)


def _track_fields(feats, curr):
    return ([getattr(feats, f.name) for f in dataclasses.fields(feats)]
            + [getattr(curr, f.name) for f in dataclasses.fields(curr)])


@pytest.mark.parametrize("smoother", ["edge", "halo", "pallas_halo"])
def test_sharded_update_step_matches(dryrun, eager_jax_tracking, smoother):
    mesh = sharding.make_mesh(4, "cpu")
    targs = dryrun["targs"]
    extra = dryrun["trcm"] if smoother != "edge" else ()
    step = sharding.sharded_update_step(dryrun["tp"], mesh, smoother)
    feats2, curr, member, graph2, stats = step(*targs, *extra)

    # Tracking: bit for bit the port's unsharded step.
    ufe, ucu, umem, ust, _ = pipeline.track_project_sync(dryrun["tp"],
                                                         *targs[:6])
    for a, b in zip(_track_fields(feats2, curr), _track_fields(ufe, ucu)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert torch.equal(member, umem)
    assert stats.dtype == ust.dtype and torch.equal(stats, ust)

    # ... and eager JAX, as the stage tests hold it.
    jfe, jcu, jmem, jst, _ = eager_jax_tracking
    assert int(np.asarray(jfe.valid).sum()) > 10
    for name in ("valid", "pf_slot", "num_updates", "search_status"):
        np.testing.assert_array_equal(getattr(feats2, name).numpy(),
                                      np.asarray(getattr(jfe, name)))
    np.testing.assert_array_equal(member.numpy(), np.asarray(jmem))
    np.testing.assert_array_equal(stats.numpy(), np.asarray(jst))
    v = np.asarray(jfe.valid)
    np.testing.assert_array_equal(feats2.xy.numpy(), np.asarray(jfe.xy))
    for got, want in ((feats2.idepth_mu, jfe.idepth_mu),
                      (feats2.idepth_var, jfe.idepth_var),
                      (curr.idepth, jcu.idepth), (curr.var, jcu.var)):
        np.testing.assert_allclose(got.numpy()[v], np.asarray(want)[v],
                                   rtol=TRACK_RTOL)
    np.testing.assert_allclose(curr.xy.numpy()[v], np.asarray(jcu.xy)[v],
                               atol=TRACK_PX)

    # The graph: JAX's sharded step on 4 devices.
    jmesh = jsh.make_mesh(jax.devices()[:4])
    jstep = jsh.sharded_update_step(dryrun["jp"], jmesh, smoother=smoother)
    jout = jstep(*dryrun["jargs"],
                 *(dryrun["jrcm"] if smoother != "edge" else ()))
    _assert_fields(graph2, jout[3], 1e-5)


# ---------------------------------------------------------------------------
# The observation-sharded BA solve.
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def window():
    K, Kinv, problem, _ = build_problem(np.random.default_rng(77))
    return np.array(K), np.array(Kinv), problem


@pytest.mark.parametrize("rows,whiten", [
    ("all", False), ("ragged", False), ("ragged", True)])
def test_solve_window_sharded_matches(window, rows, whiten):
    Kn, Kinvn, jproblem = window
    M = jproblem.obs.u_ref.shape[0]
    if rows == "ragged":  # M not divisible by the 8 partitions
        keep = M - 5 if M % 8 == 0 else M
        jproblem = jproblem._replace(obs=jax.tree.map(
            lambda a: a[:keep], jproblem.obs))
        assert keep % 8
    sw = None
    if whiten:
        r = np.random.default_rng(5).normal(
            0, 0.2, (jproblem.obs.u_ref.shape[0], 2, 2))
        sw = (np.eye(2) + r).astype(np.float32)
    jp = JBAParams(n_gn_iters=5, damping=1e-6, pose_prior_weight=0.0)
    tp = BAParams(n_gn_iters=5, damping=1e-6, pose_prior_weight=0.0)
    jmesh = jsh.make_mesh(jax.devices()[:8])
    jout = jdba.solve_window_sharded(
        jp, jnp.asarray(Kn), jnp.asarray(Kinvn), jproblem, jmesh, n_fixed=2,
        sqrtW=None if sw is None else jnp.asarray(sw))
    tproblem = convert.ba_problem_from_numpy(
        dict(q=jproblem.q, t=jproblem.t, lm_idepth=jproblem.lm_idepth,
             lm_valid=jproblem.lm_valid, obs=jax.tree.map(np.asarray,
                                                          jproblem.obs)),
        "cpu")
    K, Kinv = torch.as_tensor(Kn), torch.as_tensor(Kinvn)
    tsw = None if sw is None else torch.as_tensor(sw)
    tout = distributed_ba.solve_window_sharded(
        tp, K, Kinv, tproblem, sharding.make_mesh(8, "cpu"), n_fixed=2,
        sqrtW=tsw)
    single = schur.solve_window(tp, K, Kinv, tproblem, n_fixed=2, sqrtW=tsw)
    for k in range(3):
        np.testing.assert_allclose(tout[k].numpy(), np.asarray(jout[k]),
                                   atol=1e-4, rtol=0)
        np.testing.assert_allclose(tout[k].numpy(), single[k].numpy(),
                                   atol=1e-4, rtol=0)
    assert abs(float(tout[3]) - float(jout[3])) <= \
        1e-2 * max(float(jout[3]), 1.0)
