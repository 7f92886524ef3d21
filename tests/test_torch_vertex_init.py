"""tests/test_vertex_init.py on flame_tpu_torch: under
init_with_prediction a new vertex whose dense-map prediction is NaN
starts from the mean smoothed idepth of its surviving neighbours
(reference flame.cc:2123-2163), and from the prediction where there is
one.

The port has no post_delaunay_step: the JAX one is jax.jit of
_post_delaunay_inner, which the port runs directly, given the same
8-vertex state as the JAX test (survivors 0 and 1, vertex 2 new, one
triangle, no smoothing iterations). Each case holds the new vertex and
the survivors to the JAX test's bounds (1e-5) and every field of the
returned graph to JAX's post_delaunay_step on the same state at atol
1e-5 (masks and integer tables exactly).
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from flame_tpu.core import pipeline as jpipe  # noqa: E402
from flame_tpu.geometry import camera as jcam  # noqa: E402
from flame_tpu.geometry import se3 as jse3  # noqa: E402
from flame_tpu.optimize import nltgv2 as jnltgv2  # noqa: E402
from flame_tpu.params import Params, SolverParams  # noqa: E402
from flame_tpu_torch import convert  # noqa: E402
from flame_tpu_torch.core import pipeline  # noqa: E402
from flame_tpu_torch.optimize import topology  # noqa: E402

V, E, T = 8, 16, 8
W, H = 64, 48


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this module's small CPU tensors: the test
    workers run side by side, and more threads only oversubscribe the
    cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(x):
    return {k: np.asarray(v) for k, v in x._asdict().items()}


def _t(a, dtype=None):
    t = torch.as_tensor(np.array(a))
    return t if dtype is None else t.to(dtype)


def _run(prev_map_value):
    """The JAX test's state through both packages: (port graph, JAX
    graph)."""
    jp = Params(
        feature_capacity=V, edge_capacity=E, triangle_capacity=T,
        poseframe_capacity=2, min_height=-1e6, max_height=1e6,
        init_with_prediction=True,
        solver=SolverParams(n_iters_per_frame=0, max_vertex_degree=4,
                            smoother="vertex"))
    K = jcam.make_k(50.0, 50.0, W / 2, H / 2)
    Kinv = jcam.inv_k(K)

    graph = jnltgv2.empty(V, E, 4)
    vmask = np.zeros(V, bool)
    vmask[:2] = True  # survivors 0, 1
    x = np.zeros(V, np.float32)
    x[0], x[1] = 0.3, 0.4
    pos = np.zeros((V, 2), np.float32)
    pos[0] = (10, 10)
    pos[1] = (30, 10)
    pos[2] = (20, 25)
    graph = graph._replace(
        x=jnp.asarray(x), x_bar=jnp.asarray(x),
        pos=jnp.asarray(pos), vtx_mask=jnp.asarray(vmask),
        data_weight=jnp.asarray(vmask.astype(np.float32)))

    member = np.zeros(V, bool)
    member[:3] = True  # vertex 2 is NEW this frame
    curr = jpipe.CurrFeatures(
        xy=jnp.asarray(pos), idepth=jnp.full((V,), 0.7, jnp.float32),
        var=jnp.full((V,), 1e-3, jnp.float32),
        valid=jnp.asarray(member))

    tris = np.zeros((T, 3), np.int64)
    tris[0] = (0, 1, 2)
    edges = np.zeros((E, 2), np.int64)
    edges[:3] = [(0, 1), (0, 2), (1, 2)]  # code-sorted

    ident = (jse3.quat_identity(), jnp.zeros(3))
    prev_map = np.full((H, W), prev_map_value, np.float32)
    jout = jpipe.post_delaunay_step(
        jp, K, Kinv, graph, jnp.asarray(member), curr, ident, ident,
        jnp.float32(1.0), W, H, prev_idepthmap=jnp.asarray(prev_map),
        tris=jnp.asarray(tris), n_tris=jnp.int32(1),
        edges=jnp.asarray(edges), n_edges=jnp.int32(3))

    tp = convert.params_from_dict(dataclasses.asdict(jp))
    tid = (torch.tensor([1.0, 0, 0, 0]), torch.zeros(3))
    tout = pipeline._post_delaunay_inner(
        tp, _t(K), _t(Kinv), convert.graph_state_from_numpy(_np(graph),
                                                            "cpu"),
        _t(member), convert.curr_features_from_numpy(_np(curr), "cpu"),
        tid, tid, torch.tensor(1.0), W, H, prev_idepthmap=_t(prev_map),
        tris=_t(tris), n_tris=1, edges=_t(edges), n_edges=3,
        edge_ranks=_t(topology.build_edge_ranks(edges[:3], V, E)))
    return tout[0], jout[0]


def _assert_graph_matches_jax(tg, jg):
    for f in dataclasses.fields(tg):
        got = getattr(tg, f.name).numpy()
        want = np.asarray(getattr(jg, f.name))
        if got.dtype == bool or np.issubdtype(want.dtype, np.integer):
            np.testing.assert_array_equal(got, want, err_msg=f.name)
        else:
            np.testing.assert_allclose(got, want, rtol=0, atol=1e-5,
                                       err_msg=f.name)


def test_neighbor_mean_when_prediction_nan():
    tg, jg = _run(np.nan)
    x = tg.x.numpy()
    assert abs(x[2] - 0.35) < 1e-5, x[2]
    # Survivors keep their (projected) values, not the data term.
    assert abs(x[0] - 0.3) < 1e-5 and abs(x[1] - 0.4) < 1e-5
    _assert_graph_matches_jax(tg, jg)


def test_prediction_wins_when_valid():
    tg, jg = _run(0.55)
    x = tg.x.numpy()
    assert abs(x[2] - 0.55) < 1e-5, x[2]
    _assert_graph_matches_jax(tg, jg)
