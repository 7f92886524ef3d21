"""flame_tpu_torch's NLTGV2 smoother (the module of the nltgv2_smoother CUDA
kernel; its plain version runs here) against the JAX package on a seeded
Delaunay graph: nltgv2.smooth(mode="vertex") and the Pallas kernel in
interpret mode. Tolerances are tests/test_pallas_smoother.py's: rtol
2e-5 / atol 2e-6 after one iteration, rtol 2e-4 / atol 5e-5 after ten
(float sums over a vertex's slots are taken in another order)."""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from flame_tpu.mesh import delaunay as jdelaunay  # noqa: E402
from flame_tpu.optimize import nltgv2 as jnl  # noqa: E402
from flame_tpu.optimize import pallas_smoother  # noqa: E402
from flame_tpu.optimize import topology as jtopo  # noqa: E402
from flame_tpu.params import RegularizerParams as JRegParams  # noqa: E402
from flame_tpu_torch import convert  # noqa: E402
from flame_tpu_torch.optimize import nltgv2, smoother_kernel  # noqa: E402
from flame_tpu_torch.optimize import topology  # noqa: E402
from flame_tpu_torch.params import RegularizerParams  # noqa: E402

V_CAP = 256
E_CAP = 1024


def _make_graph(degree, seed=0, n_pts=200):
    """The tests/test_pallas_smoother.py graph, with incidence tables from
    the JAX topology (ranks ordered by edge length)."""
    rng = np.random.default_rng(seed)
    pts = rng.uniform(5, 250, (n_pts, 2)).astype(np.float32)
    tri = jdelaunay.triangulate(pts)
    slots = rng.permutation(V_CAP)[:n_pts].astype(np.int32)
    es = np.sort(slots[tri.edges], axis=1).astype(np.int64)
    es = es[np.argsort(es[:, 0] * V_CAP + es[:, 1])]
    n_e = es.shape[0]
    pos = np.zeros((V_CAP, 2), np.float32)
    pos[slots] = pts
    member = np.zeros(V_CAP, bool)
    member[slots] = True
    d = pos[es[:, 0]] - pos[es[:, 1]]
    ranks = jtopo.build_edge_ranks(es, V_CAP, E_CAP,
                                   tie=np.sqrt((d * d).sum(1)))
    edges_full = np.zeros((E_CAP, 2), np.int32)
    edges_full[:n_e] = es
    g = jnl.empty(V_CAP, E_CAP, degree)
    topo = jtopo.from_edges(
        jnp.asarray(edges_full), n_e, jnp.asarray(pos), g.edges, g.edge_mask,
        g.q1, g.q2, g.q3, E_CAP, V_CAP, degree, build_incidence=True,
        ranks=jnp.asarray(ranks))
    em = np.arange(E_CAP) < n_e

    def f(a):
        return jnp.asarray(a, jnp.float32)
    g = g._replace(
        pos=jnp.asarray(pos),
        x=f(np.where(member, rng.uniform(0.5, 2.0, V_CAP), 0.0)),
        w1=f(np.where(member, rng.normal(0, 0.01, V_CAP), 0.0)),
        w2=f(np.where(member, rng.normal(0, 0.01, V_CAP), 0.0)),
        data_term=f(np.where(member, rng.uniform(0.5, 2.0, V_CAP), 0.0)),
        data_weight=f(member), vtx_mask=jnp.asarray(member),
        edges=topo.edges, alpha=topo.alpha, beta=f(em),
        q1=f(np.where(em, rng.uniform(-0.5, 0.5, E_CAP), 0.0)),
        q2=f(np.where(em, rng.uniform(-0.5, 0.5, E_CAP), 0.0)),
        q3=f(np.where(em, rng.uniform(-0.5, 0.5, E_CAP), 0.0)),
        edge_mask=topo.edge_mask, inc_edge=topo.inc_edge,
        inc_sign=topo.inc_sign, src_slot=topo.src_slot)
    g = g._replace(x_bar=g.x, w1_bar=g.w1, w2_bar=g.w2)
    tg = convert.graph_state_from_numpy(
        {k: np.asarray(v) for k, v in g._asdict().items()}, "cpu")
    return g, tg, es, n_e, member


@pytest.fixture(scope="module")
def graph16():
    return _make_graph(16)


def _assert_graph_close(jg, tg, rtol, atol):
    vm = np.asarray(jg.vtx_mask)
    em = np.asarray(jg.edge_mask)
    for name in ("x", "w1", "w2", "x_bar", "w1_bar", "w2_bar"):
        np.testing.assert_allclose(getattr(tg, name).numpy()[vm],
                                   np.asarray(getattr(jg, name))[vm],
                                   rtol=rtol, atol=atol, err_msg=name)
    for name in ("q1", "q2", "q3"):
        np.testing.assert_allclose(getattr(tg, name).numpy()[em],
                                   np.asarray(getattr(jg, name))[em],
                                   rtol=rtol, atol=atol, err_msg=name)


TOLS = {1: dict(rtol=2e-5, atol=2e-6), 10: dict(rtol=2e-4, atol=5e-5)}


@pytest.mark.parametrize("n_iters", [1, 10])
def test_matches_jax_vertex_smoother(graph16, n_iters):
    jg, tg, *_ = graph16
    ref = jnl.smooth(JRegParams(), jg, n_iters, mode="vertex")
    out = smoother_kernel.smooth(RegularizerParams(), tg, n_iters)
    _assert_graph_close(ref, out, **TOLS[n_iters])


@pytest.mark.parametrize("n_iters", [1, 10])
def test_matches_jax_pallas_kernel(graph16, n_iters):
    jg, tg, es, n_e, member = graph16
    perm = pallas_smoother.rcm_order(es, n_e, V_CAP, member)
    inv = np.empty(V_CAP, np.int32)
    inv[perm] = np.arange(V_CAP, dtype=np.int32)
    ranks = pallas_smoother.perm_edge_ranks(es, n_e, inv, E_CAP, 16)
    assert (ranks[:n_e] < 255).all()  # nothing dropped: exact comparison
    ref = pallas_smoother.smooth(JRegParams(), jg, jnp.asarray(perm),
                                 jnp.asarray(inv), jnp.asarray(ranks),
                                 n_iters, 16, interpret=True)
    out = nltgv2._smooth_vertex_centric(RegularizerParams(), tg, n_iters)
    _assert_graph_close(ref, out, **TOLS[n_iters])


def test_zero_iters_identity(graph16):
    _, tg, *_ = graph16
    out = smoother_kernel.smooth(RegularizerParams(), tg, 0)
    for name in ("x", "w1", "w2", "x_bar", "q1", "q2", "q3"):
        torch.testing.assert_close(getattr(out, name), getattr(tg, name),
                                   rtol=0, atol=0)


def test_energy_decreases(graph16):
    _, tg, *_ = graph16
    p = RegularizerParams()
    e0 = float(nltgv2.energy(p, tg))
    out = smoother_kernel.smooth(p, tg, 50)
    assert float(nltgv2.energy(p, out)) < e0


def test_dropped_edges_keep_carried_duals():
    """With max degree 4 some edges overflow both incidence blocks: they
    are not iterated, and their carried duals pass through unchanged, as
    in the JAX vertex smoother."""
    jg, tg, *_ = _make_graph(4)
    V, D = tg.inc_edge.shape
    dropped = (tg.src_slot >= V * D) & tg.edge_mask
    assert int(dropped.sum()) > 0
    out = smoother_kernel.smooth(RegularizerParams(), tg, 5)
    for name in ("q1", "q2", "q3"):
        torch.testing.assert_close(getattr(out, name)[dropped],
                                   getattr(tg, name)[dropped], rtol=0,
                                   atol=0)
    ref = jnl.smooth(JRegParams(), jg, 5, mode="vertex")
    _assert_graph_close(ref, out, **TOLS[10])


def test_dual_copies_stay_bit_equal(graph16):
    """Both endpoints' copies of an edge's duals stay bit-equal."""
    _, tg, *_ = graph16
    p = RegularizerParams()
    tables, state = nltgv2.slot_prologue(tg)
    s = nltgv2.iterate_plain(p, tables, tg.data_term,
                             p.data_factor * tg.data_weight, tg.vtx_mask,
                             state, 10)
    src = tables.srcf > 0
    dst = (tables.sgn < 0)
    for q in s[6:]:
        a = torch.zeros(tg.q1.shape[0])
        b = torch.zeros(tg.q1.shape[0])
        a[tg.inc_edge[src]] = q[src]
        b[tg.inc_edge[dst]] = q[dst]
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_topology_from_edges_matches_jax(graph16):
    """The port's topology (carry, alpha, incidence) equals the JAX one."""
    jg, tg, es, n_e, _ = graph16
    ranks = jtopo.build_edge_ranks(es, V_CAP, E_CAP)
    np.testing.assert_array_equal(
        topology.build_edge_ranks(es, V_CAP, E_CAP), ranks)
    edges = np.zeros((E_CAP, 2), np.int64)
    edges[:n_e - 7] = np.delete(es, [3, 10, 20, 30, 40, 50, 60], axis=0)
    a = jtopo.from_edges(jnp.asarray(edges, jnp.int32), n_e - 7, jg.pos,
                         jg.edges, jg.edge_mask, jg.q1, jg.q2, jg.q3, E_CAP,
                         V_CAP, 16, build_incidence=True,
                         ranks=jnp.asarray(ranks))
    b = topology.from_edges(torch.as_tensor(edges), n_e - 7, tg.pos,
                            tg.edges, tg.edge_mask, tg.q1, tg.q2, tg.q3,
                            E_CAP, V_CAP, 16, ranks=torch.as_tensor(ranks))
    # alpha = 1/length: XLA rounds sqrt and the reciprocal within 1 ulp.
    np.testing.assert_allclose(b.alpha.numpy(), np.asarray(a.alpha),
                               rtol=1e-6)
    for name in ("edges", "edge_mask", "q1", "q2", "q3", "inc_edge",
                 "inc_sign", "src_slot"):
        np.testing.assert_array_equal(getattr(b, name).numpy(),
                                      np.asarray(getattr(a, name)),
                                      err_msg=name)


def test_params_round_trip():
    from flame_tpu.params import Params as JParams
    jp = JParams()
    tp = convert.params_from_dict(dataclasses.asdict(jp))
    assert tp.rparams == RegularizerParams()
    assert tp.solver.n_iters_per_frame == jp.solver.n_iters_per_frame
    assert tp.solver.pallas_reach == jp.solver.pallas_reach
    assert tp.solver.smoother == jp.solver.smoother
    with pytest.raises(ValueError):
        convert.params_from_dict({"no_such_field": 1})
