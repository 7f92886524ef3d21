"""The CUDA kernels of flame_tpu_torch against their plain torch versions,
on the GPU. They skip without a CUDA device; on a GPU machine without
jax, run them past tests/conftest.py (which imports jax) with
`python -m pytest tests/test_torch_kernels.py -q --noconftest`.

Tolerances: the smoother kernel K1 (one launch per call) sums a
vertex's slots in another order than torch (rtol 2e-4 / atol 5e-5 after
40 iterations, the tests/test_pallas_smoother.py bound), and both copies
of every edge's duals stay bit-equal. So for the halo kernel K3 (a
thread-block cluster per partition), whose outputs are also bit-equal for
every number of partitions. The raster kernels' inside test (one view,
and B views with one union binning, both binning on the device) is exact
on truncated vertices (identical NaN masks), their values agree to 1e-5,
and their largest per-tile counts equal the plain binnings'. The BA
window solve, captured as one CUDA graph, equals its eager run (rtol
1e-4: the sums use atomics) and replays new inputs.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from flame_tpu_torch import RegularizerParams, _kernels  # noqa: E402
from flame_tpu_torch.mesh import delaunay  # noqa: E402
from flame_tpu_torch.ops import raster_kernel, rasterize  # noqa: E402
from flame_tpu_torch.optimize import nltgv2, smoother_kernel  # noqa: E402
from flame_tpu_torch.optimize import topology  # noqa: E402
from flame_tpu_torch.parallel import halo_kernel  # noqa: E402

pytestmark = pytest.mark.cuda

V, E, D = 1024, 3072, 16
W, H = 320, 240


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _graph(cuda, V=V, E=E, D=D, W=W, H=H, seed=5):
    """A seeded Delaunay graph of V points over W x H with degree D."""
    rng = np.random.default_rng(seed)
    pts = rng.uniform([2, 2], [W - 2, H - 2], (V, 2)).astype(np.float32)
    tri = delaunay.triangulate(pts)
    edges = tri.edges.astype(np.int64)
    n_e = edges.shape[0]
    ranks = topology.build_edge_ranks(edges, V, E)
    full = np.zeros((E, 2), np.int64)
    full[:n_e] = edges
    g = nltgv2.empty(V, E, D, cuda)
    t = lambda a: torch.as_tensor(a, device=cuda)
    topo = topology.from_edges(t(full), n_e, t(pts), g.edges, g.edge_mask,
                               g.q1, g.q2, g.q3, E, V, D, ranks=t(ranks))
    em = np.arange(E) < n_e
    f = lambda a: t(np.asarray(a, np.float32))
    x = f(rng.uniform(0.1, 0.3, V))
    g = g.replace(
        pos=t(pts), x=x, x_bar=x.clone(), w1=f(rng.normal(0, 1e-3, V)),
        w2=f(rng.normal(0, 1e-3, V)), data_term=f(rng.uniform(0.1, 0.3, V)),
        data_weight=torch.ones(V, device=cuda),
        vtx_mask=t(rng.uniform(size=V) > 0.05),
        edges=topo.edges, alpha=topo.alpha, beta=topo.edge_mask.float(),
        q1=f(np.where(em, rng.uniform(-0.5, 0.5, E), 0)),
        q2=f(np.where(em, rng.uniform(-0.5, 0.5, E), 0)),
        q3=f(np.where(em, rng.uniform(-0.5, 0.5, E), 0)),
        edge_mask=topo.edge_mask, inc_edge=topo.inc_edge,
        inc_sign=topo.inc_sign, src_slot=topo.src_slot)
    g = g.replace(w1_bar=g.w1.clone(), w2_bar=g.w2.clone())
    return g, t(tri.triangles.astype(np.int64))


@pytest.fixture(scope="module")
def graph(cuda):
    return _graph(cuda)


def _iterate_args(g):
    p = RegularizerParams()
    tables, state = nltgv2.slot_prologue(g)
    return (p, tables, g.data_term, (p.data_factor * g.data_weight)
            .contiguous(), g.vtx_mask), state


def _check_smoother(g, n_iters):
    """K1 against the plain iterations: one launch, rtol 2e-4 / atol 5e-5,
    and both copies of every edge's duals bit-equal."""
    args, state = _iterate_args(g)
    before = _kernels.LAUNCHES["nltgv2_smoother"]
    out_k = smoother_kernel.iterate(*args, state, n_iters)
    assert _kernels.LAUNCHES["nltgv2_smoother"] == before + 1
    out_p = nltgv2.iterate_plain(*args, state, n_iters)
    for name, a, b in zip(nltgv2.SmoothState._fields, out_k, out_p):
        torch.testing.assert_close(a, b, rtol=2e-4, atol=5e-5, msg=name)
    tables = args[1]
    src = tables.srcf > 0
    dst = tables.sgn < 0
    n_e = g.q1.shape[0]
    for q in out_k[6:]:
        a = torch.zeros(n_e, device=q.device)
        b = torch.zeros(n_e, device=q.device)
        a[g.inc_edge[src]] = q[src]
        b[g.inc_edge[dst]] = q[dst]
        assert torch.equal(a, b)


@pytest.mark.parametrize("n_iters", [1, 3, 40])
def test_smoother_kernel_matches_plain(graph, n_iters):
    _check_smoother(graph[0], n_iters)


def test_smoother_kernel_two_vertices_per_warp(cuda):
    """1024x768 with 8192 vertices (the XGA row), D=16: more warps than
    the card holds at once, so each warp takes two vertices."""
    g, _ = _graph(cuda, V=8192, E=3 * 8192, D=16, W=1024, H=768, seed=6)
    plan = smoother_kernel._plan(cuda.index or 0, 8192, 16)
    assert plan.vertices_per_warp >= 2
    _check_smoother(g, 40)


def test_smoother_kernel_rejects_what_the_card_cannot_hold(cuda):
    V_big, D_big = 40000, 64
    z = torch.zeros((V_big, D_big), device=cuda)
    tables = nltgv2.SlotTables(torch.zeros((V_big, D_big), dtype=torch.int64,
                                           device=cuda), z, z, z, z, z, z)
    v = torch.zeros(V_big, device=cuda)
    state = nltgv2.SmoothState(v, v, v, v, v, v, z, z, z)
    with pytest.raises(ValueError, match="do not fit the card"):
        smoother_kernel.iterate(RegularizerParams(), tables, v, v,
                                v > 0, state, 40)


def test_smoother_full_smooth_matches_plain(graph):
    g, _ = graph
    p = RegularizerParams()
    a = smoother_kernel.smooth(p, g, 10)
    b = nltgv2._smooth_vertex_centric(p, g, 10)
    for name in ("x", "w1", "w2", "x_bar", "q1", "q2", "q3"):
        torch.testing.assert_close(getattr(a, name), getattr(b, name),
                                   rtol=2e-4, atol=5e-5, msg=name)


@pytest.fixture(scope="module")
def big_graph(cuda):
    """4096 vertices over 640x480: 32 rows, enough for 8 partitions."""
    return _graph(cuda, V=4096, E=3 * 4096, W=640, H=480, seed=7)


def _banded(g):
    """The banded layout of the graph (RCM order of its edges, reach 2)."""
    V, E, D = g.x.shape[0], g.q1.shape[0], g.inc_edge.shape[1]
    edges = g.edges[g.edge_mask].cpu().numpy()
    n_e = edges.shape[0]
    perm = smoother_kernel.rcm_order(edges, n_e, V, np.ones(V, bool))
    inv = np.empty(V, np.int32)
    inv[perm] = np.arange(V, dtype=np.int32)
    ranks = smoother_kernel.perm_edge_ranks(edges, n_e, inv, E, D, 2)
    t = lambda a: torch.as_tensor(a, device=g.x.device)
    lay = smoother_kernel.build_layout(g, t(perm), t(inv), t(ranks), D, 2)
    # Flat slot of each edge's dst copy (row (u // 128) * D + d, lane).
    hi_p = t(inv.astype(np.int64))[g.edges[:, 1]]
    dst = ((hi_p // 128) * D + t(ranks[:, 1].astype(np.int64))) * 128 \
        + hi_p % 128
    return lay, dst


def _plan(g, n):
    return halo_kernel._plan(g.x.device.index or 0, g.x.shape[0], D, n, 2)


@pytest.mark.parametrize("which, n", [("graph", 1), ("graph", 2),
                                      ("graph", 4), ("big_graph", 1),
                                      ("big_graph", 8)])
def test_halo_kernel_matches_plain(request, which, n):
    """One launch, a cluster of more than one CTA per partition (1024
    vertices in one partition force it, as do 4096 in one or 512 in each
    of 8), the plain version's outputs and bit-equal dual copies."""
    g, _ = request.getfixturevalue(which)
    lay, dst = _banded(g)
    p = RegularizerParams()
    assert _plan(g, n).cluster > 1
    before = _kernels.LAUNCHES["halo_smoother"]
    out_k = halo_kernel.iterate(p, 40, D, 2, n, lay.vtx, lay.slots)
    assert _kernels.LAUNCHES["halo_smoother"] == before + 1
    out_p = halo_kernel.iterate_plain(p, 40, D, 2, n, lay.vtx, lay.slots)
    for a, b in zip(out_k, out_p):
        torch.testing.assert_close(a, b, rtol=2e-4, atol=5e-5)
    # Both copies of every live edge's duals are bit-equal.
    assert int(lay.alive.sum()) > 0
    for q in out_k[6:]:
        qf = q.reshape(-1)
        assert torch.equal(qf[lay.src_slot[lay.alive]], qf[dst[lay.alive]])


@pytest.mark.parametrize("which, parts", [("graph", (2, 4)),
                                          ("big_graph", (2, 4, 8))])
def test_halo_kernel_independent_of_partitions(request, which, parts):
    g, _ = request.getfixturevalue(which)
    lay, _ = _banded(g)
    p = RegularizerParams()
    base = halo_kernel.iterate(p, 40, D, 2, 1, lay.vtx, lay.slots)
    for n in parts:
        out = halo_kernel.iterate(p, 40, D, 2, n, lay.vtx, lay.slots)
        for a, b in zip(out, base):
            assert torch.equal(a, b)


def test_halo_kernel_over_a_one_rank_group(graph):
    """K3 over a one-rank NCCL group (its ring ends are its own peer
    buffers, flags epoch-counted): three launches queued back to back,
    each bit-equal to the one-process launch."""
    import socket

    import torch.distributed as dist
    from flame_tpu_torch.parallel import multihost
    g, _ = graph
    lay, _ = _banded(g)
    p = RegularizerParams()
    base = halo_kernel.iterate(p, 40, D, 2, 1, lay.vtx, lay.slots)
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    multihost.initialize(f"127.0.0.1:{port}", 1, 0, backend="nccl")
    try:
        mesh = multihost.global_mesh()
        outs = [halo_kernel.iterate(p, 40, D, 2, 1, lay.vtx, lay.slots,
                                    mesh) for _ in range(3)]
        for out in outs:
            for a, b in zip(out, base):
                assert torch.equal(a, b)
    finally:
        multihost.shutdown()
    assert not dist.is_initialized()


def test_halo_kernel_rejects_what_the_card_cannot_hold(cuda):
    """65,536 vertices in one partition: no cluster shape holds them all
    resident at once, so the wrapper raises before launching."""
    R = 512
    z = torch.zeros((R, 128), device=cuda)
    zs = torch.zeros((R * D, 128), device=cuda)
    zi = torch.zeros((R * D, 128), dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="do not fit the card"):
        halo_kernel.iterate(RegularizerParams(), 40, D, 2, 1, (z,) * 9,
                            (zi, zi) + (zs,) * 9)


def _check_raster(pos, tris, vals, valid, max_per_tile, h=H, w=W):
    """K2 through rasterize_with_count against the plain rasterizer: one
    launch, equal NaN masks, values to 1e-5, equal largest count."""
    cand = rasterize.tile_candidates(pos, tris, vals, valid, h, w,
                                     max_per_tile=max_per_tile)
    before = _kernels.LAUNCHES["raster_mesh"]
    out_k, count = raster_kernel.rasterize_with_count(
        pos, tris, vals, valid, h, w, max_per_tile=max_per_tile)
    assert _kernels.LAUNCHES["raster_mesh"] == before + 1
    out_p = rasterize.finish(rasterize.eval_tiles(cand.cdata), h, w)
    assert torch.equal(torch.isnan(out_k), torch.isnan(out_p))
    m = ~torch.isnan(out_k)
    torch.testing.assert_close(out_k[m], out_p[m], rtol=0, atol=1e-5)
    assert int(count) == int(cand.max_count)
    return out_k, int(count)


def test_raster_kernel_matches_plain(graph):
    g, tris = graph
    vals = torch.rand(V, device=tris.device) + 0.5
    valid = torch.rand(tris.shape[0], device=tris.device) > 0.02
    # Uniform random points are denser per tile than a detection-grid
    # mesh; 256 candidates keep every overlap, so the brute force agrees.
    out_k, count = _check_raster(g.pos, tris, vals, valid, 256)
    assert count <= 256
    ref = rasterize.rasterize_bruteforce(g.pos, tris, vals, valid, H, W)
    assert torch.equal(torch.isnan(ref), torch.isnan(out_k))


def test_raster_kernel_overflow_keeps_the_plain_candidates(cuda):
    """A tile with more than 160 overlapping triangles keeps the 160 of
    the highest index, as the plain binning (and the TPU kernel's
    top_k) does."""
    rng = np.random.default_rng(9)
    pts = np.concatenate([rng.uniform([2, 2], [W - 2, H - 2], (600, 2)),
                          rng.uniform([132, 36], [250, 60], (400, 2))])
    tri = delaunay.triangulate(pts.astype(np.float32))
    pos = torch.as_tensor(pts, dtype=torch.float32, device=cuda)
    tris = torch.as_tensor(tri.triangles.astype(np.int64), device=cuda)
    vals = torch.rand(pts.shape[0], device=cuda) + 0.5
    valid = torch.ones(tris.shape[0], dtype=torch.bool, device=cuda)
    _, count = _check_raster(pos, tris, vals, valid, 160)
    assert count > 160


def _views(pos, B):
    """B views of one mesh, shifted and scaled per view."""
    return torch.stack([pos * (1.0 + 0.01 * b) + torch.tensor(
        [3.0 * b, -2.0 * b], device=pos.device) for b in range(B)])


def _check_raster_batch(verts, tris, vals, valid, max_per_tile, h=H, w=W):
    """K2b through rasterize_batch_with_count against the plain union
    binning + eval_tiles_batch: one launch, equal NaN masks, values to
    1e-5, equal largest union count."""
    cand = rasterize.tile_candidates_batch(verts, tris, vals, valid, h, w,
                                           max_per_tile=max_per_tile)
    before = _kernels.LAUNCHES["raster_mesh_batch"]
    out_k, count = raster_kernel.rasterize_batch_with_count(
        verts, tris, vals, valid, h, w, max_per_tile=max_per_tile)
    assert _kernels.LAUNCHES["raster_mesh_batch"] == before + 1
    out_p = rasterize.finish(rasterize.eval_tiles_batch(cand.cdata), h, w)
    assert torch.equal(torch.isnan(out_k), torch.isnan(out_p))
    m = ~torch.isnan(out_k)
    torch.testing.assert_close(out_k[m], out_p[m], rtol=0, atol=1e-5)
    assert int(count) == int(cand.max_count)
    return out_k, int(count)


@pytest.mark.parametrize("B", [4, 8, 12])
def test_raster_batch_kernel_matches_plain(graph, B):
    """K2b (raster_mesh_batch): B views of one mesh (shifted and scaled
    per view, per-view values, view-specific invalid triangles) with one
    union binning per tile; clusters of 4, 8 and 6 views."""
    g, tris = graph
    dev = tris.device
    verts = _views(g.pos, B)
    vals = torch.rand(B, V, device=dev) + 0.5
    valid = torch.ones(B, tris.shape[0], dtype=torch.bool, device=dev)
    valid[1, :50] = False
    valid[B - 1, 100:180] = False
    out_k, count = _check_raster_batch(verts, tris, vals, valid, 512)
    assert count <= 512
    for b in range(B):
        ref = rasterize.rasterize_bruteforce(verts[b], tris, vals[b],
                                             valid[b], H, W)
        assert torch.equal(torch.isnan(ref), torch.isnan(out_k[b]))


def test_raster_batch_kernel_overflow_keeps_the_plain_candidates(cuda):
    """A tile whose union count passes 192 keeps the 192 of the highest
    index, as the plain union binning (and the TPU kernel's top_k) does."""
    rng = np.random.default_rng(10)
    pts = np.concatenate([rng.uniform([2, 2], [W - 2, H - 2], (600, 2)),
                          rng.uniform([132, 36], [250, 60], (400, 2))])
    tri = delaunay.triangulate(pts.astype(np.float32))
    pos = torch.as_tensor(pts, dtype=torch.float32, device=cuda)
    tris = torch.as_tensor(tri.triangles.astype(np.int64), device=cuda)
    B = 8
    vals = torch.rand(B, pts.shape[0], device=cuda) + 0.5
    valid = torch.rand(B, tris.shape[0], device=cuda) > 0.02
    _, count = _check_raster_batch(_views(pos, B), tris, vals, valid, 192)
    assert count > 192


@pytest.mark.parametrize("seed", [11, 12])
def test_raster_kernels_at_752_columns(cuda, seed):
    """K2 and K2b at 752x480 (a MAV camera): the sixth column of tiles is
    112 of its 128 columns wide. Half the mesh's points lie in the last
    192 columns, so its triangles cross that tile's left edge and reach
    the image's right edge; B=8 views shift and scale the mesh past it.
    Equal NaN masks, values to 1e-5 and equal largest counts against the
    plain rasterizer, and the masks of the brute force."""
    Hm, Wm = 480, 752
    rng = np.random.default_rng(seed)
    pts = np.concatenate([rng.uniform([2, 2], [Wm - 2, Hm - 2], (900, 2)),
                          rng.uniform([560, 2], [Wm - 0.5, Hm - 2],
                                      (900, 2))])
    tri = delaunay.triangulate(pts.astype(np.float32))
    pos = torch.as_tensor(pts, dtype=torch.float32, device=cuda)
    tris = torch.as_tensor(tri.triangles.astype(np.int64), device=cuda)
    vals = torch.rand(pts.shape[0], device=cuda) + 0.5
    valid = torch.rand(tris.shape[0], device=cuda) > 0.02
    out_k, _ = _check_raster(pos, tris, vals, valid, 256, Hm, Wm)
    ref = rasterize.rasterize_bruteforce(pos, tris, vals, valid, Hm, Wm)
    assert torch.equal(torch.isnan(ref), torch.isnan(out_k))
    assert not bool(torch.isnan(out_k[:, 640:]).all())
    B = 8
    verts = _views(pos, B)
    bvals = torch.rand(B, pts.shape[0], device=cuda) + 0.5
    bvalid = torch.rand(B, tris.shape[0], device=cuda) > 0.02
    out_b, _ = _check_raster_batch(verts, tris, bvals, bvalid, 512, Hm, Wm)
    for b in range(B):
        ref = rasterize.rasterize_bruteforce(verts[b], tris, bvals[b],
                                             bvalid[b], Hm, Wm)
        assert torch.equal(torch.isnan(ref), torch.isnan(out_b[b]))


def test_cuda_tensors_never_take_the_plain_path(graph, monkeypatch):
    g, tris = graph

    def forbidden(*a, **k):
        raise AssertionError("plain path taken for CUDA tensors")
    monkeypatch.setattr(nltgv2, "iterate_plain", forbidden)
    monkeypatch.setattr(rasterize, "eval_tiles", forbidden)
    monkeypatch.setattr(rasterize, "eval_tiles_batch", forbidden)
    monkeypatch.setattr(halo_kernel, "iterate_plain", forbidden)
    smoother_kernel.smooth(RegularizerParams(), g, 3)
    lay, _ = _banded(g)
    halo_kernel.iterate(RegularizerParams(), 3, D, 2, 2, lay.vtx, lay.slots)
    vals = torch.ones(V, device=tris.device)
    valid = torch.ones(tris.shape[0], dtype=torch.bool, device=tris.device)
    # Both rasterizers bin on the device: no torch binning either.
    monkeypatch.setattr(rasterize, "_bin_tiles", forbidden)
    monkeypatch.setattr(rasterize, "tile_candidates", forbidden)
    monkeypatch.setattr(rasterize, "tile_candidates_batch", forbidden)
    raster_kernel.rasterize_batch(g.pos[None].repeat(2, 1, 1), tris,
                                  vals[None].repeat(2, 1),
                                  valid[None].repeat(2, 1), H, W)
    raster_kernel.rasterize(g.pos, tris, vals, valid, H, W)
    torch.cuda.synchronize()


def test_wrappers_reject_bad_inputs(graph):
    g, _ = graph
    args, state = _iterate_args(g)
    bad = state._replace(x=state.x.double())
    with pytest.raises(ValueError):
        smoother_kernel.iterate(*args, bad, 1)
    with pytest.raises(ValueError):  # rows of 15 floats
        raster_kernel.raster_mesh(torch.zeros((8, 15), device=g.x.device),
                                  torch.zeros((8, 4), device=g.x.device),
                                  H, W)
    with pytest.raises(ValueError):  # a single view's rows
        raster_kernel.raster_mesh_batch(
            torch.zeros((8, 16), device=g.x.device),
            torch.zeros((8, 4), device=g.x.device), H, W)


def _ba_buf(P, L, M, K, seed, device):
    """A well-posed BA window (9 invalid rows) as one packed upload."""
    from flame_tpu_torch.ba import window
    buf = window.well_posed_window(P, L, M, K, seed, (20, 140), n_invalid=9)
    return torch.as_tensor(buf, device=device)


def test_graphed_ba_solve_matches_eager(cuda):
    """The BA window solve replayed from the graph runner (kind "ba")
    against the eager solve: one capture, and the second call replays
    new inputs."""
    from flame_tpu_torch import BAParams, step_graph
    from flame_tpu_torch.ba import window
    p = BAParams(max_landmarks=64, max_obs=256)
    P, L, M = 4, p.max_landmarks, p.max_obs
    Kn = np.array([[200.0, 0, 80], [0, 200, 60], [0, 0, 1]])
    K = torch.tensor(Kn, dtype=torch.float32, device=cuda)
    Kinv = torch.linalg.inv(K)
    img = torch.rand(P, 130, 170, device=cuda) * 255
    steps = step_graph.Steps(step_graph.cuda_capture)
    for seed in (0, 1):
        b = _ba_buf(P, L, M, Kn, seed, cuda)
        got = window._solve_graphed(steps, p, K, Kinv, b, img, 5, 2, P, L, M)
        want = window._solve_packed(p, K, Kinv, b, img, 5, 2, P, L, M)
        torch.testing.assert_close(got[:-1], want[:-1], rtol=1e-4,
                                   atol=1e-5)
        torch.testing.assert_close(got[-1], want[-1], rtol=1e-3, atol=1e-3)
    assert steps.counts == dict(ba_graph_captures=1, ba_graph_replays=2)


def _section_topology(pts, m, T, cuda):
    """The host triangulation of the first m points, padded as Flame
    uploads it: tris (T, 3), edges (E, 2), edge ranks, and the counts."""
    tri = delaunay.triangulate(pts[:m])
    edges = tri.edges.astype(np.int64)
    d = pts[edges[:, 0]] - pts[edges[:, 1]]
    ranks = topology.build_edge_ranks(edges, V, E,
                                      tie=np.sqrt((d * d).sum(1)))
    tris = np.zeros((T, 3), np.int64)
    tris[:tri.triangles.shape[0]] = tri.triangles
    full = np.zeros((E, 2), np.int64)
    full[:edges.shape[0]] = edges
    t = lambda a: torch.as_tensor(a, device=cuda)  # noqa: E731
    return dict(tris=t(tris), n_tris=int(tri.triangles.shape[0]),
                edges=t(full), n_edges=int(edges.shape[0]),
                edge_ranks=t(ranks))


@pytest.mark.parametrize("deterministic", [False, True])
def test_post_delaunay_section_replays_equal_eager(cuda, deterministic):
    """The post-Delaunay section (pipeline._post_delaunay_inner) replayed
    from its CUDA graphs against the eager section, over four calls whose
    n_tris and n_edges change, each side carrying its own graph state:
    graph state, vertex idepths, normals, validity, map, scale and
    coverage bit for bit; K1 and K2 launched once a call on both sides;
    one capture and a replay per call for each of the four graphs.
    The normals sum each vertex's triangles with index_add_, which on the
    card adds in the order its atomics land unless torch's deterministic
    algorithms are on: so they are compared with those on, and left out
    without (the eager section then differs from itself there)."""
    from flame_tpu_torch import Params, SolverParams
    from flame_tpu_torch import step_graph
    from flame_tpu_torch.core import pipeline
    params = Params(solver=SolverParams(smoother="vertex",
                                        max_vertex_degree=D))
    K = torch.tensor([[250.0, 0, W / 2], [0, 250.0, H / 2], [0, 0, 1]],
                     device=cuda)
    Kinv = torch.linalg.inv(K)
    rng = np.random.default_rng(9)
    pts = rng.uniform([4, 4], [W - 4, H - 4], (V, 2)).astype(np.float32)
    q = torch.tensor([1.0, 0, 0, 0], device=cuda)
    steps = step_graph.Steps(step_graph.cuda_capture)
    state = {side: (nltgv2.empty(V, E, D, cuda), torch.ones((), device=cuda))
             for side in ("eager", "graphed")}
    f = lambda a: torch.as_tensor(np.asarray(a, np.float32),  # noqa: E731
                                  device=cuda)
    was = torch.are_deterministic_algorithms_enabled()
    # warn_only: cuBLAS, whose workspace this process may have set up
    # already, warns instead of raising.
    torch.use_deterministic_algorithms(deterministic, warn_only=True)
    try:
        for k, m in enumerate((700, 850, 600, 1000)):
            xy = pts + np.float32(0.5 * k)
            member = torch.arange(V, device=cuda) < m
            curr = pipeline.CurrFeatures(
                xy=f(xy), idepth=f(rng.uniform(0.1, 0.3, V)),
                var=f(rng.uniform(1e-4, 1e-3, V)), valid=member)
            topo = _section_topology(xy, m, 2 * V, cuda)
            outs = {}
            for side, current in (("eager", None), ("graphed", steps)):
                graph, scale = state[side]
                _kernels.reset_launches()
                with step_graph.active(current):
                    outs[side] = pipeline._post_delaunay_inner(
                        params, K, Kinv, graph, member, curr,
                        (q, f([0.01 * k, 0, 0])),
                        (q, f([0.01 * (k + 1), 0, 0])), scale, W, H, **topo)
                torch.cuda.synchronize()
                assert _kernels.LAUNCHES["nltgv2_smoother"] == 1, (side, k)
                assert _kernels.LAUNCHES["raster_mesh"] == 1, (side, k)
                state[side] = (outs[side][0], outs[side][5])
            want, got = (step_graph._leaves(
                o if deterministic else o[:2] + o[3:])
                for o in (outs["eager"], outs["graphed"]))
            assert len(got) == len(want)
            for a, b in zip(want, got):
                torch.testing.assert_close(a, b, rtol=0, atol=0,
                                           equal_nan=True)
    finally:
        torch.use_deterministic_algorithms(was)
    assert steps.counts == {f"{kind}_graph_{c}": n
                            for kind in ("post", "smooth", "mesh", "raster")
                            for c, n in (("captures", 1), ("replays", 4))}
