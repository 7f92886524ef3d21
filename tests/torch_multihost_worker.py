"""One rank of tests/test_torch_multihost.py: joins a gloo group of NPROC
CPU processes at COORD as rank PID_IDX, runs the named CHECKS on
multihost.global_mesh() and prints "proc <rank> <check> START" before
each check and "proc <rank> <check> OK" after each one that passed, then
"proc <rank> OK". The coordinator writes the
final dense maps of the ShardedFlame runs into OUT_DIR (<check>_<n>.npy)
for the comparison with the JAX package in the pytest process.

Run by the test, which gives each check its own 120 s limit:
    COORD=127.0.0.1:PORT NPROC=2 PID_IDX=0 CHECKS=psum,halo OUT_DIR=DIR \
        FLAME_REPO=REPO python tests/torch_multihost_worker.py

Each group result is held to the one-process mesh of as many partitions
(make_mesh(n)), which runs the same arithmetic on one process: bit-equal
is expected and checked (torch.equal; the maps compared with NaN masks
equal). The quality bounds are tests/test_sharded_e2e.py's.
"""

import os
import sys
import tempfile

sys.path.insert(0, os.environ["FLAME_REPO"])

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402

from flame_tpu_torch import (BAParams, DetectionParams, Params,  # noqa: E402
                             RegularizerParams, SolverParams)
from flame_tpu_torch.ba import schur, window  # noqa: E402
from flame_tpu_torch.core import frame as frame_mod  # noqa: E402
from flame_tpu_torch.mesh import delaunay  # noqa: E402
from flame_tpu_torch.optimize import nltgv2, smoother_kernel  # noqa: E402
from flame_tpu_torch.parallel import (distributed_ba, halo,  # noqa: E402
                                      halo_kernel, multihost, sharding)
from flame_tpu_torch.parallel.orchestrator import ShardedFlame  # noqa: E402
from flame_tpu_torch.utils import checkpoint, evaluation  # noqa: E402

torch.set_num_threads(2)

FX = 100.0
W, H = 160, 120
PLANE_Z = 5.0
N_FRAMES = 14
BATCH_FRAMES = 16
K = np.array([[FX, 0, W / 2], [0, FX, H / 2], [0, 0, 1]], np.float32)
KINV = np.linalg.inv(K.astype(np.float64)).astype(np.float32)
FIELDS = ("x", "w1", "w2", "x_bar", "w1_bar", "w2_bar", "q1", "q2", "q3")

rank = int(os.environ["PID_IDX"])
n = int(os.environ["NPROC"])


def render(cam_x):
    """tests/test_sharded_e2e.py's textured plane at 5 m."""
    vv, uu = np.mgrid[0:H, 0:W].astype(np.float64)
    X = (uu - W / 2) * PLANE_Z / FX + cam_x
    Y = (vv - H / 2) * PLANE_Z / FX
    return (128 + 60 * np.sin(4.1 * X + 0.9 * Y) + 35 * np.cos(1.73 * X)
            + 18 * np.sin(2.31 * Y) + 10 * np.sin(0.83 * X)) \
        .astype(np.float32)


def scene_params(smoother="vertex", **kw):
    """test_sharded_e2e.py's Params: 512 features for "vertex", its
    _run_halo_mode's 1024 for the banded modes; kw overrides a field."""
    big = smoother != "vertex"
    solver = dict(n_iters_per_frame=30, max_vertex_degree=16,
                  smoother=smoother)
    solver.update(kw.pop("solver", {}))
    kw = {**dict(
        feature_capacity=1024 if big else 512,
        edge_capacity=4096 if big else 2048,
        triangle_capacity=2048 if big else 1024, poseframe_capacity=8,
        min_height=-100.0, max_height=100.0, idepth_init=0.05,
        idepth_var_init=0.25), **kw}
    return Params(detection=DetectionParams(win_size=16),
                  solver=SolverParams(**solver), debug_quiet=True, **kw)


def batch_params(smoother="vertex", evict=False, **kw):
    """scene_params on the throughput path: frame_batch=4 under async
    topology with the JAX package's schedule (deterministic); evict:
    with bench.py's comparison-poseframe scoring and eviction (4
    poseframe slots, full by frame 6)."""
    if evict:
        kw.update(poseframe_capacity=4, photo_error_num_pfs=30)
    return scene_params(smoother, solver=dict(
        frame_batch=4, async_topology=True, deterministic=True), **kw)


def run(fl, lo=0, hi=N_FRAMES, u8=False):
    """Frames lo..hi-1, every second one a poseframe (under
    auto_poseframe the selector decides); u8: uint8 images, which the
    batched step takes (float images run the single path)."""
    for i in range(lo, hi):
        cam_x = 0.15 * i
        img = render(cam_x)
        if u8:
            img = np.clip(img, 0, 255).astype(np.uint8)
        fl.update(i * 0.1, i, (np.array([1.0, 0, 0, 0]),
                               np.array([cam_x, 0.0, 0.0])), img,
                  None if fl.params.auto_poseframe else i % 2 == 0)
    return fl


def assert_equal_maps(a, b, what):
    assert np.array_equal(np.isnan(a), np.isnan(b)), f"{what}: NaN masks"
    both = ~np.isnan(a)
    diff = float(np.abs(a[both] - b[both]).max(initial=0.0))
    assert diff <= 1e-6, f"{what}: max |d idepth| {diff}"


def assert_map_bounds(idm, what):
    cov = float(np.mean(~np.isnan(idm)))
    assert cov > 0.5, f"{what}: coverage {cov}"
    err = np.abs(idm[~np.isnan(idm)] - 1.0 / PLANE_Z) * PLANE_Z
    assert np.median(err) < 0.02, f"{what}: median error {np.median(err)}"


def assert_graphs_equal(a, b, what):
    for k in FIELDS:
        assert torch.equal(getattr(a, k), getattr(b, k)), f"{what}: {k}"


def banded_graph(seed=3, V=1024, E=4096, D=16, n_pts=700):
    """tests/test_torch_halo.py's graph (700 seeded Delaunay points in
    random slots of V = 1024) with its RCM order and ranks."""
    rng = np.random.default_rng(seed)
    pts = rng.uniform(5, 500, (n_pts, 2)).astype(np.float32)
    tri = delaunay.triangulate(pts)
    slots = rng.permutation(V)[:n_pts]
    es = np.sort(slots[tri.edges], axis=1).astype(np.int64)
    es = es[np.argsort(es[:, 0] * V + es[:, 1])]
    n_e = es.shape[0]
    member = np.zeros(V, bool)
    member[slots] = True
    pos = np.zeros((V, 2), np.float32)
    pos[slots] = pts
    edges = np.zeros((E, 2), np.int64)
    edges[:n_e] = es
    em = np.arange(E) < n_e
    d = pos[edges[:, 0]] - pos[edges[:, 1]]
    length = np.sqrt((d * d).sum(1))
    alpha = np.where(em & (length > 1e-6), 1.0 / np.maximum(length, 1e-6),
                     0.0)

    def f(a):
        return torch.as_tensor(np.asarray(a, np.float32))
    x = f(np.where(member, rng.uniform(0.5, 2.0, V), 0.0))
    w1 = f(np.where(member, rng.normal(0, 0.01, V), 0.0))
    w2 = f(np.where(member, rng.normal(0, 0.01, V), 0.0))
    g = nltgv2.empty(V, E, D, "cpu").replace(
        pos=torch.as_tensor(pos), x=x, w1=w1, w2=w2, x_bar=x.clone(),
        w1_bar=w1.clone(), w2_bar=w2.clone(),
        data_term=f(np.where(member, rng.uniform(0.5, 2.0, V), 0.0)),
        data_weight=f(member), vtx_mask=torch.as_tensor(member),
        edges=torch.as_tensor(edges), alpha=f(alpha), beta=f(em),
        q1=f(np.where(em, rng.uniform(-0.5, 0.5, E), 0.0)),
        q2=f(np.where(em, rng.uniform(-0.5, 0.5, E), 0.0)),
        q3=f(np.where(em, rng.uniform(-0.5, 0.5, E), 0.0)),
        edge_mask=torch.as_tensor(em))
    perm = smoother_kernel.rcm_order(es, n_e, V, member)
    inv = np.empty(V, np.int32)
    inv[perm] = np.arange(V, dtype=np.int32)
    ranks = smoother_kernel.perm_edge_ranks(es, n_e, inv, E, D, 2,
                                            tie=length[:n_e])
    return (g, torch.as_tensor(perm).long(), torch.as_tensor(inv).long(),
            torch.as_tensor(ranks), D)


def check_psum(mesh):
    total = sharding.psum(torch.tensor([[float(rank + 1)]]), mesh)
    assert float(total) == n * (n + 1) / 2, total


def check_smooth(mesh):
    # A 16-vertex ring in a (32, 64) graph, as tests/test_multihost.py;
    # 1e-5 of nltgv2.smooth after 10 iterations (another summation order).
    V, E, nv = 32, 64, 16
    rng = np.random.default_rng(0)
    edges = np.zeros((E, 2), np.int64)
    edges[:nv, 0] = np.arange(nv)
    edges[:nv, 1] = (np.arange(nv) + 1) % nv
    emask = np.arange(E) < nv
    vmask = np.arange(V) < nv

    def f32(a):
        return torch.as_tensor(np.asarray(a, np.float32))
    x = f32(rng.uniform(0.1, 0.3, V))
    g = nltgv2.empty(V, E, 4, "cpu").replace(
        pos=f32(rng.uniform(0, 50, (V, 2))), x=x, x_bar=x.clone(),
        data_term=torch.full((V,), 0.2), data_weight=f32(vmask),
        vtx_mask=torch.as_tensor(vmask), edges=torch.as_tensor(edges),
        alpha=f32(emask * 0.2), beta=f32(emask),
        edge_mask=torch.as_tensor(emask))
    p = RegularizerParams()
    g2 = sharding.sharded_smooth(p, g, 10, mesh)
    ref = nltgv2.smooth(p, g, 10)
    for name in FIELDS:
        torch.testing.assert_close(getattr(g2, name), getattr(ref, name),
                                   rtol=0, atol=1e-5, msg=name)
    assert sharding.LAST_TRAFFIC["n_devices"] == n


def check_ba(mesh):
    # A window every process holds whole; 63 rows pad to the ranks. 1e-4
    # of schur.solve_window on t, q and lm, 1e-2 relative on the cost.
    Kn = np.array([[100.0, 0, 64], [0, 100.0, 48], [0, 0, 1]])
    P, L, M = 4, 12, 63
    buf = torch.as_tensor(window.well_posed_window(P, L, M, Kn, 5, (20, 100),
                                                   n_invalid=3))
    problem, _ = window._decode_packed(buf, P, L, M)
    Kt = torch.as_tensor(Kn, dtype=torch.float32)
    Kinv = torch.linalg.inv(Kt)
    bp = BAParams(n_gn_iters=3)
    got = distributed_ba.solve_window_sharded(bp, Kt, Kinv, problem, mesh)
    want = schur.solve_window(bp, Kt, Kinv, problem)
    for a, b in zip(got[:3], want[:3]):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-4)
    assert abs(float(got[3]) - float(want[3])) \
        <= 1e-2 * max(float(want[3]), 1.0)


def check_grid(mesh):
    grid = multihost.grid_mesh((1, n), ("hosts", "graph"))
    assert grid.mesh.tolist() == [list(range(n))], grid.mesh
    assert tuple(grid.mesh_dim_names) == ("hosts", "graph")


def check_halo(mesh):
    """The plain "halo" smoother over the group against make_mesh(n)."""
    g, perm, inv, ranks, D = banded_graph()
    p = RegularizerParams()
    width = halo.strip_width(g.x.shape[0], n, 2)
    got = halo.halo_smooth(p, g, perm, inv, ranks, 7, D, mesh, halo=width)
    want = halo.halo_smooth(p, g, perm, inv, ranks, 7, D,
                            sharding.make_mesh(n, "cpu"), halo=width)
    assert_graphs_equal(got, want, "halo_smooth")


def check_kernel(mesh):
    """K3's plain version over the group against make_mesh(n)."""
    g, perm, inv, ranks, D = banded_graph()
    p = RegularizerParams()
    got = halo_kernel.smooth_sharded(p, g, perm, inv, ranks, 7, D, mesh)
    want = halo_kernel.smooth_sharded(p, g, perm, inv, ranks, 7, D,
                                      sharding.make_mesh(n, "cpu"))
    assert_graphs_equal(got, want, "smooth_sharded")


def check_step(mesh):
    """sharded_update_step over the group: tracking bit-equal to the
    one-process step, each rank tracking and holding its block only."""
    params = scene_params("pallas_halo")
    fl = run(ShardedFlame(W, H, K, KINV, params,
                          mesh=sharding.make_mesh(n, "cpu"), device="cpu"),
             0, 7)
    cam_x = 0.15 * 7
    fnew = frame_mod.create(7, torch.tensor([1.0, 0, 0, 0]),
                            torch.tensor([cam_x, 0.0, 0.0]),
                            torch.as_tensor(render(cam_x)), params.pad)
    topo = fl._staged.dev
    perm = topo["perm"].long()
    inv = torch.empty_like(perm)
    inv[perm] = torch.arange(perm.shape[0])
    args = (fl.K, fl.Kinv, fl._stack)
    tail = (fnew, fl._curr_pf_slot, fl._graph, perm, inv,
            topo["edge_ranks"])
    want = sharding.sharded_update_step(
        params, sharding.make_mesh(n, "cpu"), "pallas_halo")(
        *args, fl._feats, *tail)
    block = sharding.shard_rows(fl._feats, mesh)
    got = sharding.sharded_update_step(params, mesh, "pallas_halo")(
        *args, block, *tail)
    N = params.feature_capacity
    assert got[0].idepth_mu.shape[0] == N // n
    for a, b in zip(got[:3], want[:3]):  # feats', curr, member
        assert_same(a, sharding.shard_rows(b, mesh))
    assert torch.equal(got[4], want[4]), "stats"
    assert_graphs_equal(got[3], want[3], "graph")


def assert_same(a, b):
    """Every leaf of two states (or two tensors) equal."""
    names, va = sharding._leaves(a)
    _, vb = sharding._leaves(b)
    for k, x, y in zip(names, va, vb):
        assert (x is None and y is None) or torch.equal(x, y), k


def check_stage(mesh):
    """sharded_update_step over the group on the dry run's state that the
    pytest process wrote (OUT_DIR/stage_in.pt, tests/test_torch_sharding
    .dryrun_state), for "edge", "halo" and "pallas_halo"; the coordinator
    writes the gathered outputs (OUT_DIR/stage_out.pt), which the pytest
    process holds to eager JAX tracking and JAX's sharded step."""
    out_dir = os.environ["OUT_DIR"]
    d = torch.load(os.path.join(out_dir, "stage_in.pt"), weights_only=False)
    K, Kinv, stack, feats, fnew, slot, graph = d["targs"]
    outs = {}
    for smoother in ("edge", "halo", "pallas_halo"):
        extra = d["trcm"] if smoother != "edge" else ()
        step = sharding.sharded_update_step(d["tp"], mesh, smoother)
        f2, curr, member, g2, stats = step(
            K, Kinv, stack, sharding.shard_rows(feats, mesh), fnew, slot,
            graph, *extra)
        assert f2.valid.shape[0] == feats.valid.shape[0] // n
        outs[smoother] = (*sharding.gather_rows(mesh, f2, curr, member),
                          g2, stats)
    if multihost.is_coordinator():
        torch.save(outs, os.path.join(out_dir, "stage_out.pt"))


def placed(fl, what):
    """Each rank holds capacity / n rows of the feature and graph state,
    the frames and the map whole."""
    N = fl.params.feature_capacity
    E = fl.params.edge_capacity
    for name, t, rows in (("feats.idepth_mu", fl._feats.idepth_mu, N),
                          ("curr.xy", fl._curr.xy, N),
                          ("graph.x", fl._graph.x, N),
                          ("graph.q1", fl._graph.q1, E),
                          ("vtx_idepths", fl._vtx_idepths, N)):
        assert t.shape[0] == rows // n, (what, name, tuple(t.shape))
    assert fl._stack.img_pad.shape[0] == fl.params.poseframe_capacity, what
    assert tuple(fl._idepthmap.shape) == (H, W), what


def flame_check(smoother, **kw):
    def check(mesh):
        params = scene_params(smoother, **kw)
        fl = run(ShardedFlame(W, H, K, KINV, params, mesh=mesh,
                              device="cpu"))
        placed(fl, smoother)
        idm = fl.get_inverse_depth_map()
        ref = run(ShardedFlame(W, H, K, KINV, params,
                               mesh=sharding.make_mesh(n, "cpu"),
                               device="cpu"))
        assert_equal_maps(idm, ref.get_inverse_depth_map(), smoother)
        assert_map_bounds(idm, smoother)
        mesh_out = fl.get_inverse_depth_mesh()
        assert mesh_out["triangles"].shape[0] > 30
        if multihost.is_coordinator():
            np.save(os.path.join(os.environ["OUT_DIR"],
                                 f"{smoother}_{n}.npy"), idm)
    return check


def check_flame_ba(mesh):
    """tests/test_sharded_e2e.py::test_sharded_ba_e2e over the group:
    max_obs=1001 (not a multiple of the ranks), aniso weights, exact
    poses."""
    params = scene_params(
        "vertex", do_ba=True,
        ba=BAParams(window_size=4, n_gn_iters=3, obs_capacity=4096,
                    max_landmarks=256, max_obs=1001, aniso_weights=True))
    fl = run(ShardedFlame(W, H, K, KINV, params, mesh=mesh, device="cpu"))
    placed(fl, "ba")
    assert fl.stats.stats("ba_sharded_solves") >= 1
    assert fl.stats.stats("ba_single_solves") == 0.0
    assert fl._ba.last_cost is not None and np.isfinite(fl._ba.last_cost)
    assert fl._ba.last_accepted
    for fid, slot in fl._pf_slot_by_id.items():
        t = fl._stack.t[slot].numpy()
        assert np.linalg.norm(t - [0.15 * fid, 0, 0]) < 0.02, (fid, t)


def check_checkpoint(mesh):
    """tests/test_sharded_e2e.py::test_sharded_checkpoint_roundtrip over
    the group: the blocks go back to their ranks, and the resumed run
    equals the continued one."""
    params = scene_params("vertex", solver=dict(deterministic=True))
    fl = run(ShardedFlame(W, H, K, KINV, params, mesh=mesh, device="cpu"),
             0, 10)
    # One path for every rank: the coordinator's temporary directory.
    d = [tempfile.mkdtemp() if rank == 0 else None]
    dist.broadcast_object_list(d, src=0)
    path = os.path.join(d[0], "group.npz")
    checkpoint.save(path, fl)
    fl2 = ShardedFlame(W, H, K, KINV, params, mesh=mesh, device="cpu")
    checkpoint.load(path, fl2)
    placed(fl2, "loaded")
    for a, b in zip((fl._feats, fl._curr, fl._graph),
                    (fl2._feats, fl2._curr, fl2._graph)):
        assert_same(a, b)
    run(fl, 10, 16)
    run(fl2, 10, 16)
    a = fl.get_inverse_depth_map()
    b = fl2.get_inverse_depth_map()
    np.testing.assert_array_equal(a, b)
    assert np.mean(~np.isnan(b)) > 0.5


def assert_ranks_agree(idm, what):
    """The ranks' replicated maps equal."""
    idm = torch.as_tensor(idm)
    maps = [torch.empty_like(idm) for _ in range(n)]
    dist.all_gather(maps, idm)
    for m in maps[1:]:
        assert_equal_maps(maps[0].numpy(), m.numpy(), what)


def batch_check(smoother, evict):
    """The batched step over the group (pipeline.batch_step, K2b's plain
    version) against make_mesh(n) in one process; evict: with eviction,
    whose slots every rank frees alike."""
    def check(mesh):
        params = batch_params(smoother, evict)
        fl = run(ShardedFlame(W, H, K, KINV, params, mesh=mesh,
                              device="cpu"), 0, BATCH_FRAMES, u8=True)
        ref = run(ShardedFlame(W, H, K, KINV, params,
                               mesh=sharding.make_mesh(n, "cpu"),
                               device="cpu"), 0, BATCH_FRAMES, u8=True)
        placed(fl, f"batch {smoother}")
        assert fl._dispatches >= 2 and fl._dispatches == ref._dispatches, \
            (fl._dispatches, ref._dispatches)
        # The last batched step's stats, summed over the group (the
        # getters flush the buffered frames through the single path).
        assert fl._last_dispatch_frames == 4
        assert torch.equal(fl._last_stats_dev, ref._last_stats_dev)
        idm = fl.get_inverse_depth_map()
        assert_equal_maps(idm, ref.get_inverse_depth_map(), smoother)
        assert (fl.stats.stats("pf_evictions") >= 1) == evict
        slots = [None] * n
        dist.all_gather_object(slots, (fl._pf_slot_by_id, fl._pf_free))
        assert all(x == (ref._pf_slot_by_id, ref._pf_free) for x in slots)
        assert_map_bounds(idm, f"batch {smoother}")
        assert_ranks_agree(idm, f"batch {smoother} ranks")
        if multihost.is_coordinator():
            np.save(os.path.join(os.environ["OUT_DIR"],
                                 f"batch_{smoother}_{n}.npy"), idm)
    return check


def check_flame_batch_ba(mesh):
    """tests/test_torch_checkpoint.py's batched BA configuration
    (frame_batch=4, deterministic, a solve every 3 new poseframes) over
    the group, exact poses: every solve sharded, the poseframes where
    check_flame_ba holds them, the map equal to make_mesh(n)'s."""
    params = batch_params(do_ba=True, ba=BAParams(
        window_size=8, n_gn_iters=2, obs_capacity=2048, max_landmarks=256,
        max_obs=512, solve_min_new_pfs=3))
    fl = run(ShardedFlame(W, H, K, KINV, params, mesh=mesh, device="cpu"),
             0, BATCH_FRAMES, u8=True)
    placed(fl, "batch ba")
    st = fl.stats
    assert fl._dispatches >= 2, fl._dispatches
    assert st.stats("ba_sharded_solves") >= 1
    assert st.stats("ba_single_solves") == 0.0
    assert fl._ba.last_cost is not None and np.isfinite(fl._ba.last_cost)
    ids = sorted(fl._pf_slot_by_id)
    t = fl._stack.t[[fl._pf_slot_by_id[i] for i in ids]].numpy()
    gt = np.array([[0.15 * i, 0.0, 0.0] for i in ids])
    assert np.linalg.norm(t - gt, axis=1).max() < 0.02, (ids, t)
    assert evaluation.ate_rmse(t, gt) < 0.02
    ref = run(ShardedFlame(W, H, K, KINV, params,
                           mesh=sharding.make_mesh(n, "cpu"), device="cpu"),
              0, BATCH_FRAMES, u8=True)
    assert ref.stats.stats("ba_sharded_solves") \
        == st.stats("ba_sharded_solves")
    assert_equal_maps(fl.get_inverse_depth_map(), ref.get_inverse_depth_map(),
                      "batch ba")


def check_flame_batch_auto(mesh):
    """Automatic poseframes on the batched step over the group
    (tests/test_torch_auto_poseframe.py's selector settings): every rank
    declares the same frames as make_mesh(n), and the maps are equal."""
    params = batch_params(auto_poseframe=True, auto_pf_max_disparity=12.0,
                          auto_pf_depth=PLANE_Z)
    fl = run(ShardedFlame(W, H, K, KINV, params, mesh=mesh, device="cpu"),
             0, BATCH_FRAMES, u8=True)
    ref = run(ShardedFlame(W, H, K, KINV, params,
                           mesh=sharding.make_mesh(n, "cpu"), device="cpu"),
              0, BATCH_FRAMES, u8=True)
    assert fl._dispatches >= 2 and fl._dispatches == ref._dispatches
    idm = fl.get_inverse_depth_map()
    assert_equal_maps(idm, ref.get_inverse_depth_map(), "batch auto")
    declared = [None] * n
    dist.all_gather_object(declared, sorted(fl._pf_slot_by_id))
    assert len(declared[0]) >= 2
    assert all(d == sorted(ref._pf_slot_by_id) for d in declared), declared


def check_checkpoint_batch(mesh):
    """A save mid-batch over the group: the buffered frames run through
    the single-frame group path, the blocks go back to their ranks, and
    the resumed batched run equals the continued one."""
    params = batch_params()
    fl = run(ShardedFlame(W, H, K, KINV, params, mesh=mesh, device="cpu"),
             0, 11, u8=True)
    assert fl._batch_pending and fl._dispatches >= 1
    d = [tempfile.mkdtemp() if rank == 0 else None]
    dist.broadcast_object_list(d, src=0)
    path = os.path.join(d[0], "group_batch.npz")
    checkpoint.save(path, fl)
    assert not fl._batch_pending
    fl2 = ShardedFlame(W, H, K, KINV, params, mesh=mesh, device="cpu")
    checkpoint.load(path, fl2)
    placed(fl2, "loaded mid-batch")
    for a, b in zip((fl._feats, fl._curr, fl._graph),
                    (fl2._feats, fl2._curr, fl2._graph)):
        assert_same(a, b)
    d0 = fl._dispatches
    run(fl, 11, 20, u8=True)
    run(fl2, 11, 20, u8=True)
    assert fl._dispatches > d0 and fl2._dispatches == fl._dispatches
    a = fl.get_inverse_depth_map()
    b = fl2.get_inverse_depth_map()
    np.testing.assert_array_equal(a, b)
    assert np.mean(~np.isnan(b)) > 0.5


def check_flame_async(mesh):
    """The asynchronous path over the group: the coordinator decides
    whether a snapshot or a triangulation has landed for every rank
    (sharding.agree), so the ranks stay in step and their replicated
    maps agree bit for bit."""
    params = scene_params("vertex", solver=dict(async_topology=True))
    fl = run(ShardedFlame(W, H, K, KINV, params, mesh=mesh, device="cpu"))
    placed(fl, "async")
    idm = fl.get_inverse_depth_map()
    assert_ranks_agree(idm, "async ranks")
    assert np.mean(~np.isnan(idm)) > 0.3


CHECKS = {
    "psum": check_psum, "smooth": check_smooth, "ba": check_ba,
    "grid": check_grid, "halo": check_halo, "kernel": check_kernel,
    "step": check_step, "checkpoint": check_checkpoint,
    "stage": check_stage,
    "flame_vertex": flame_check("vertex"),
    "flame_halo": flame_check("halo"),
    "flame_pallas_halo": flame_check("pallas_halo"),
    "flame_ba": check_flame_ba,
    "flame_async": check_flame_async,
    "flame_batch_vertex": batch_check("vertex", evict=False),
    "flame_batch_pallas_halo": batch_check("pallas_halo", evict=True),
    "flame_batch_ba": check_flame_batch_ba,
    "flame_batch_auto": check_flame_batch_auto,
    "checkpoint_batch": check_checkpoint_batch,
}


def main():
    multihost.initialize(os.environ["COORD"], n, rank, backend="gloo")
    try:
        mesh = multihost.global_mesh()
        assert dist.get_world_size() == n
        assert mesh.size == n and mesh.first_block == rank
        assert mesh.device == torch.device("cpu") and not mesh.staged
        assert multihost.is_coordinator() == (rank == 0)
        try:  # gloo carries CPU tensors and, through the host, a card's
            multihost.global_mesh(device="meta")
        except ValueError:
            pass
        else:
            raise AssertionError("a mesh on a device gloo cannot carry")
        for name in os.environ["CHECKS"].split(","):
            print(f"proc {rank} {name} START", flush=True)
            CHECKS[name](mesh)
            print(f"proc {rank} {name} OK", flush=True)
    finally:
        multihost.shutdown()
    print(f"proc {rank} OK", flush=True)


if __name__ == "__main__":
    main()
