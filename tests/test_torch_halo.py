"""flame_tpu_torch's banded layout and partitioned smoothers against the
JAX package, on the tests/test_pallas_halo.py graph (V=1024, E=4096,
D=16, 700 seeded Delaunay points in random slots).

The host order (rcm_order), the RCM-order ranks (perm_edge_ranks) and the
banded tables (build_layout) must be exactly the JAX package's. The plain
version of the halo kernel K3 (halo_kernel.iterate_plain, through
smooth_sharded) is held to pallas_smoother.smooth (one partition) and
pallas_halo.smooth_sharded (2 and 4 partitions, interpret mode on the
virtual CPU devices), and the plain "halo" smoother to halo.halo_smooth,
at atol 1e-5 after 7 iterations: the same arithmetic in the same order,
apart from the order of the sums over a vertex's slots.
"""

import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import Mesh as JMesh  # noqa: E402

from flame_tpu.mesh import delaunay as jdelaunay  # noqa: E402
from flame_tpu.optimize import nltgv2 as jnl  # noqa: E402
from flame_tpu.optimize import pallas_smoother  # noqa: E402
from flame_tpu.parallel import halo as jhalo  # noqa: E402
from flame_tpu.parallel import pallas_halo  # noqa: E402
from flame_tpu.params import RegularizerParams as JRegParams  # noqa: E402
from flame_tpu_torch import _kernels, convert  # noqa: E402
from flame_tpu_torch.optimize import nltgv2, smoother_kernel  # noqa: E402
from flame_tpu_torch.parallel import halo, halo_kernel  # noqa: E402
from flame_tpu_torch.parallel import sharding  # noqa: E402
from flame_tpu_torch.params import RegularizerParams  # noqa: E402

V_CAP = 1024
E_CAP = 4096
DEGREE = 16
N_ITERS = 7
ATOL = 1e-5
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIELDS = ("x", "w1", "w2", "x_bar", "w1_bar", "w2_bar", "q1", "q2", "q3")


def _make_graph(seed, n_pts=700):
    """tests/test_pallas_halo.py::_make_graph for both packages, plus the
    edge lengths (the host's rank tie)."""
    rng = np.random.default_rng(seed)
    pts = rng.uniform(5, 500, (n_pts, 2)).astype(np.float32)
    tri = jdelaunay.triangulate(pts)
    slots = rng.permutation(V_CAP)[:n_pts].astype(np.int32)
    es = np.sort(slots[tri.edges], axis=1)
    es = es[np.argsort(es[:, 0].astype(np.int64) * V_CAP + es[:, 1])]
    n_e = es.shape[0]
    pos = np.zeros((V_CAP, 2), np.float32)
    pos[slots] = pts
    member = np.zeros(V_CAP, bool)
    member[slots] = True
    edges_full = np.zeros((E_CAP, 2), np.int64)
    edges_full[:n_e] = es
    em = np.arange(E_CAP) < n_e
    d = pos[edges_full[:, 0]] - pos[edges_full[:, 1]]
    length = np.sqrt((d * d).sum(1))
    alpha = np.where(em & (length > 1e-6), 1.0 / np.maximum(length, 1e-6),
                     0.0)

    def f(a):
        return jnp.asarray(a, jnp.float32)
    g = jnl.empty(V_CAP, E_CAP, DEGREE)._replace(
        pos=jnp.asarray(pos),
        x=f(np.where(member, rng.uniform(0.5, 2.0, V_CAP), 0.0)),
        w1=f(np.where(member, rng.normal(0, 0.01, V_CAP), 0.0)),
        w2=f(np.where(member, rng.normal(0, 0.01, V_CAP), 0.0)),
        data_term=f(np.where(member, rng.uniform(0.5, 2.0, V_CAP), 0.0)),
        data_weight=f(member), vtx_mask=jnp.asarray(member),
        edges=jnp.asarray(edges_full, jnp.int32), alpha=f(alpha),
        beta=f(em), q1=f(np.where(em, rng.uniform(-0.5, 0.5, E_CAP), 0.0)),
        q2=f(np.where(em, rng.uniform(-0.5, 0.5, E_CAP), 0.0)),
        q3=f(np.where(em, rng.uniform(-0.5, 0.5, E_CAP), 0.0)),
        edge_mask=jnp.asarray(em))
    g = g._replace(x_bar=g.x, w1_bar=g.w1, w2_bar=g.w2)
    tg = convert.graph_state_from_numpy(
        {k: np.asarray(v) for k, v in g._asdict().items()}, "cpu")
    return g, tg, es, n_e, member, length[:n_e]


@pytest.fixture(scope="module", params=[3, 5])
def graph(request):
    return _make_graph(request.param)


def _perm(es, n_e, member, reach=2, tie=None):
    perm = smoother_kernel.rcm_order(es, n_e, V_CAP, member)
    inv = np.empty(V_CAP, np.int32)
    inv[perm] = np.arange(V_CAP, dtype=np.int32)
    ranks = smoother_kernel.perm_edge_ranks(es, n_e, inv, E_CAP, DEGREE,
                                            reach, tie=tie)
    return perm, inv, ranks


def _assert_close(ref, out, atol=ATOL):
    for name in FIELDS:
        np.testing.assert_allclose(getattr(out, name).numpy(),
                                   np.asarray(getattr(ref, name)), rtol=0,
                                   atol=atol, err_msg=name)


def test_rcm_order_matches_jax(graph):
    _, _, es, n_e, member, _ = graph
    np.testing.assert_array_equal(
        smoother_kernel.rcm_order(es, n_e, V_CAP, member),
        pallas_smoother.rcm_order(es, n_e, V_CAP, member))


@pytest.mark.parametrize("reach,degree,use_tie", [
    (2, DEGREE, False), (2, DEGREE, True), (0, DEGREE, True), (2, 5, True)])
def test_perm_edge_ranks_match_jax(graph, reach, degree, use_tie):
    """Band and degree drops included (reach 0 and degree 5 drop edges)."""
    _, _, es, n_e, member, elen = graph
    perm = smoother_kernel.rcm_order(es, n_e, V_CAP, member)
    inv = np.empty(V_CAP, np.int32)
    inv[perm] = np.arange(V_CAP, dtype=np.int32)
    tie = elen if use_tie else None
    a = smoother_kernel.perm_edge_ranks(es, n_e, inv, E_CAP, degree, reach,
                                        tie=tie)
    b = pallas_smoother.perm_edge_ranks(es, n_e, inv, E_CAP, degree, reach,
                                        tie=tie)
    np.testing.assert_array_equal(a, b)
    if reach == 0 or degree == 5:
        assert (a[:n_e, 0] == 255).any()


@pytest.mark.parametrize("reach", [0, 2])
def test_build_layout_matches_jax(graph, reach):
    jg, tg, es, n_e, member, elen = graph
    perm, inv, ranks = _perm(es, n_e, member, reach, tie=elen)
    jv, js, jsrc, jalive = pallas_smoother.build_layout(
        jg, jnp.asarray(perm), jnp.asarray(inv), jnp.asarray(ranks), DEGREE,
        reach)
    lay = smoother_kernel.build_layout(
        tg, torch.as_tensor(perm), torch.as_tensor(inv),
        torch.as_tensor(ranks), DEGREE, reach)
    for k, (a, b) in enumerate(zip(lay.vtx + lay.slots, jv + js)):
        assert a.dtype == (torch.int32 if k in (9, 10) else torch.float32)
        np.testing.assert_array_equal(a.numpy(), np.asarray(b),
                                      err_msg=f"table {k}")
    np.testing.assert_array_equal(lay.src_slot.numpy(), np.asarray(jsrc))
    np.testing.assert_array_equal(lay.alive.numpy(), np.asarray(jalive))


def test_one_partition_matches_pallas_smoother(graph):
    """smoother="pallas": the banded path at n=1 computes what
    pallas_smoother.smooth computes."""
    jg, tg, es, n_e, member, elen = graph
    perm, inv, ranks = _perm(es, n_e, member, tie=elen)
    ref = pallas_smoother.smooth(JRegParams(), jg, jnp.asarray(perm),
                                 jnp.asarray(inv), jnp.asarray(ranks),
                                 N_ITERS, DEGREE, interpret=True)
    out = halo_kernel.smooth_sharded(
        RegularizerParams(), tg, torch.as_tensor(perm), torch.as_tensor(inv),
        torch.as_tensor(ranks), N_ITERS, DEGREE,
        sharding.make_mesh(1, "cpu"))
    _assert_close(ref, out)


@pytest.mark.parametrize("n", [2, 4])
def test_partitions_match_jax_pallas_halo(graph, n):
    jg, tg, es, n_e, member, elen = graph
    perm, inv, ranks = _perm(es, n_e, member, tie=elen)
    mesh = JMesh(np.array(jax.devices()[:n]), ("graph",))
    ref = pallas_halo.smooth_sharded(
        JRegParams(), jg, jnp.asarray(perm), jnp.asarray(inv),
        jnp.asarray(ranks), N_ITERS, DEGREE, mesh, axis="graph",
        interpret=True)
    launches = dict(_kernels.LAUNCHES)
    out = halo_kernel.smooth_sharded(
        RegularizerParams(), tg, torch.as_tensor(perm), torch.as_tensor(inv),
        torch.as_tensor(ranks), N_ITERS, DEGREE,
        sharding.make_mesh(n, "cpu"))
    assert _kernels.LAUNCHES == launches  # CPU tensors never launch
    _assert_close(ref, out)


def test_band_drops_keep_carried_duals(graph):
    """At reach 0 edges between rows drop: they keep their carried duals,
    as in pallas_smoother.smooth."""
    jg, tg, es, n_e, member, elen = graph
    perm, inv, ranks = _perm(es, n_e, member, reach=0, tie=elen)
    dropped = torch.as_tensor(ranks[:, 0] == 255) & tg.edge_mask
    assert int(dropped.sum()) > 0
    ref = pallas_smoother.smooth(JRegParams(), jg, jnp.asarray(perm),
                                 jnp.asarray(inv), jnp.asarray(ranks),
                                 N_ITERS, DEGREE, reach=0, interpret=True)
    out = halo_kernel.smooth_sharded(
        RegularizerParams(), tg, torch.as_tensor(perm), torch.as_tensor(inv),
        torch.as_tensor(ranks), N_ITERS, DEGREE,
        sharding.make_mesh(1, "cpu"), reach=0)
    # Dual steps multiply the rounding of the slot sums by step_q = 125;
    # with most edges dropped one dual of seed 5 lands 1.8e-5 away.
    _assert_close(ref, out, atol=5e-5)
    for name in ("q1", "q2", "q3"):
        torch.testing.assert_close(getattr(out, name)[dropped],
                                   getattr(tg, name)[dropped], rtol=0, atol=0)


@pytest.mark.parametrize("n", [1, 2, 4])
def test_halo_smooth_matches_jax(graph, n):
    jg, tg, es, n_e, member, elen = graph
    reach = 2
    perm, inv, ranks = _perm(es, n_e, member, reach, tie=elen)
    width = halo.strip_width(V_CAP, n, reach)
    assert width == jhalo.strip_width(V_CAP, n, reach)
    mesh = JMesh(np.array(jax.devices()[:n]), (jhalo.AXIS,))
    ref = jhalo.halo_smooth(JRegParams(), jg, jnp.asarray(perm),
                            jnp.asarray(inv), jnp.asarray(ranks), N_ITERS,
                            DEGREE, mesh, halo=width)
    out = halo.halo_smooth(RegularizerParams(), tg, torch.as_tensor(perm),
                           torch.as_tensor(inv), torch.as_tensor(ranks),
                           N_ITERS, DEGREE, sharding.make_mesh(n, "cpu"),
                           halo=width)
    _assert_close(ref, out)


def test_partitions_agree_with_each_other(graph):
    """The plain K3 result does not depend on the number of partitions
    (up to the float order of torch's slot sums)."""
    _, tg, es, n_e, member, elen = graph
    perm, inv, ranks = _perm(es, n_e, member, tie=elen)
    lay = smoother_kernel.build_layout(
        tg, torch.as_tensor(perm), torch.as_tensor(inv),
        torch.as_tensor(ranks), DEGREE, 2)
    p = RegularizerParams()
    base = halo_kernel.iterate_plain(p, N_ITERS, DEGREE, 2, 1, lay.vtx,
                                     lay.slots)
    for n in (2, 4, 8):
        if (V_CAP // 128) // n < 2:
            continue
        out = halo_kernel.iterate_plain(p, N_ITERS, DEGREE, 2, n, lay.vtx,
                                        lay.slots)
        for a, b in zip(out, base):
            torch.testing.assert_close(a, b, rtol=0, atol=1e-6)


@pytest.mark.parametrize("which", ["pallas_halo", "halo"])
def test_energy_decreases(graph, which):
    _, tg, es, n_e, member, elen = graph
    perm, inv, ranks = _perm(es, n_e, member, tie=elen)
    p = RegularizerParams()
    args = (p, tg, torch.as_tensor(perm), torch.as_tensor(inv),
            torch.as_tensor(ranks), 30, DEGREE, sharding.make_mesh(2, "cpu"))
    out = (halo_kernel.smooth_sharded(*args) if which == "pallas_halo"
           else halo.halo_smooth(*args, halo=halo.strip_width(V_CAP, 2, 2)))
    assert float(nltgv2.energy(p, out)) < float(nltgv2.energy(p, tg))


def test_traffic_models_match_jax():
    for n, it, r in ((1, 40, 3), (4, 40, 3), (8, 7, 2)):
        assert halo_kernel.traffic_model(4096, n, it, r) \
            == pallas_halo.traffic_model(4096, n, it, r)
        w = halo.strip_width(4096, n, r)
        assert halo.traffic_model(4096, n, it, w) \
            == jhalo.traffic_model(4096, n, it, w)


def test_bad_partitions_raise(graph):
    _, tg, es, n_e, member, elen = graph
    perm, inv, ranks = _perm(es, n_e, member, tie=elen)
    args = (RegularizerParams(), tg, torch.as_tensor(perm),
            torch.as_tensor(inv), torch.as_tensor(ranks), 1, DEGREE)
    with pytest.raises(ValueError):  # 8 rows into 3 partitions
        halo_kernel.smooth_sharded(*args, sharding.make_mesh(3, "cpu"))
    with pytest.raises(ValueError):  # 2 rows per partition < reach 3
        halo_kernel.smooth_sharded(*args, sharding.make_mesh(4, "cpu"),
                                   reach=3)
    with pytest.raises(ValueError):  # 128-rank blocks < halo 384
        halo.halo_smooth(*args, sharding.make_mesh(8, "cpu"), halo=384)
    with pytest.raises(ValueError):  # V % 128
        smoother_kernel._rows(1000)


def test_mesh():
    m = sharding.make_mesh(4, "cpu")
    assert m.size == 4 and m.device == torch.device("cpu")
    assert m.axis == sharding.AXIS == jhalo.AXIS
    assert sharding.Mesh(("cpu", "cpu")).size == 2
    with pytest.raises(NotImplementedError):
        sharding.Mesh(("cuda:0", "cuda:1"))
    with pytest.raises(NotImplementedError):
        sharding.Mesh(("cpu", "cuda:0"))
    with pytest.raises(ValueError):
        sharding.make_mesh(0, "cpu")


def test_rcm_order_needs_scipy(monkeypatch):
    """The JAX package falls back to a BFS order without scipy; that is
    another permutation, so the port raises instead."""
    monkeypatch.setitem(sys.modules, "scipy.sparse.csgraph", None)
    with pytest.raises(RuntimeError):
        smoother_kernel.rcm_order(np.zeros((0, 2), np.int64), 0, 128,
                                  np.ones(128, bool))


def test_parallel_modules_import_no_jax():
    code = ("import sys, flame_tpu_torch.parallel.orchestrator, "
            "flame_tpu_torch.parallel.halo, "
            "flame_tpu_torch.parallel.halo_kernel; "
            "assert 'jax' not in sys.modules, 'jax imported'; "
            "assert not any(m.startswith('flame_tpu.') or m == 'flame_tpu' "
            "for m in sys.modules), 'flame_tpu imported'")
    env = dict(os.environ, PYTHONPATH=REPO)
    subprocess.run([sys.executable, "-c", code], check=True, cwd=REPO,
                   env=env, timeout=120)
