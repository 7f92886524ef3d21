"""tests/test_pair_mode.py on flame_tpu_torch: two frames per dispatch
(solver.frame_batch=2, pipeline.batch_step) on the CPU, with that file's
Params (converted from the JAX package's), scene and bounds.

  * quality parity of B=2 against the single-frame path on the 160x120
    plane (coverage > 0.9x, median error < max(2x, 0.01)), of B=4
    against B=2 (coverage > 0.85x, error < 0.02), and of resident uint8
    tensors against host images (> 0.9x, < 0.02);
  * the getter flush of a buffered frame, raw idepths, the stats and the
    mesh, the prune guard, MIN_EDGE_LENGTH's clamp of alpha, the capacity
    truncation counters, the snapshot dedupe of coincident packed
    positions, and each poseframe of a batch stashing its own map;
  * test_batch_tracking_bit_equal_sequential: the port's batch_step at
    B=2 with detection off against two port frame_track_step calls, bit
    for bit, on __graft_entry__._synthetic_state carried over through
    convert.py (feature state, each frame's observations, the packed
    snapshot, membership, the last frame's projected features and the
    summed stats).
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import flame_tpu_torch  # noqa: E402
from flame_tpu.params import (DetectionParams, Params,  # noqa: E402
                              SolverParams)
from flame_tpu_torch import convert  # noqa: E402
from flame_tpu_torch.core import pipeline  # noqa: E402

FX = 100.0
W, H = 160, 120
PLANE_Z = 5.0


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this module's small CPU tensors: the test
    workers run side by side, and more threads only oversubscribe the
    cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def tex(X, Y):
    return (128 + 60 * np.sin(4.1 * X + 0.9 * Y) + 35 * np.cos(1.73 * X)
            + 18 * np.sin(2.31 * Y) + 10 * np.sin(0.83 * X))


def render(cam_x):
    vv, uu = np.mgrid[0:H, 0:W].astype(np.float64)
    X = (uu - W / 2) * PLANE_Z / FX + cam_x
    Y = (vv - H / 2) * PLANE_Z / FX
    return np.clip(tex(X, Y), 0, 255).astype(np.uint8)


def port_params(jax_params):
    return convert.params_from_dict(dataclasses.asdict(jax_params))


def make_flame(frame_batch):
    params = Params(
        feature_capacity=512, edge_capacity=2048, triangle_capacity=1024,
        poseframe_capacity=8, min_height=-100.0, max_height=100.0,
        idepth_init=0.05, idepth_var_init=0.25,
        detection=DetectionParams(win_size=16),
        solver=SolverParams(n_iters_per_frame=30, max_vertex_degree=16,
                            async_topology=True, coalesce_uploads=True,
                            frame_batch=frame_batch, smoother="vertex"),
        debug_quiet=True)
    K = np.array([[FX, 0, W / 2], [0, FX, H / 2], [0, 0, 1]], np.float32)
    Kinv = np.linalg.inv(K.astype(np.float64)).astype(np.float32)
    return flame_tpu_torch.Flame(W, H, K, Kinv, port_params(params),
                                 device="cpu")


def drive(fl, n, start=0, resident=False):
    for i in range(start, start + n):
        cam_x = 0.15 * i
        img = render(cam_x)
        fl.update(i * 0.1, i, (np.array([1.0, 0, 0, 0], np.float32),
                               np.array([cam_x, 0.0, 0.0], np.float32)),
                  torch.as_tensor(img) if resident else img, i % 2 == 0)


def coverage(idm):
    return np.mean(~np.isnan(idm))


def error(idm):
    return np.nanmedian(np.abs(idm - 1 / PLANE_Z)) * PLANE_Z


@pytest.fixture(scope="module")
def paired():
    fl = make_flame(2)
    drive(fl, 20)
    return fl


@pytest.fixture(scope="module")
def paired_map(paired):
    """The B=2 run's map after its 20 frames, before any test drives it
    further."""
    return paired.get_inverse_depth_map()


def test_pair_mode_engages(paired):
    assert paired._dispatches >= 5  # pairs actually dispatched


def test_pair_quality_matches_single(paired_map):
    fl1 = make_flame(1)
    drive(fl1, 20)
    assert fl1._dispatches == 0
    idm1 = fl1.get_inverse_depth_map()
    assert coverage(paired_map) > 0.9 * coverage(idm1)
    assert error(paired_map) < max(2.0 * error(idm1), 0.01)


def test_batch4_quality_matches_single(paired_map):
    """frame_batch=4: the batched step at depth 4 holds the quality of
    the pair path (one dispatch per 4 frames)."""
    fl4 = make_flame(4)
    drive(fl4, 20)
    assert fl4._dispatches >= 3
    idm4 = fl4.get_inverse_depth_map()
    assert coverage(idm4) > 0.85 * coverage(paired_map)
    assert error(idm4) < 0.02


def test_resident_image_batching(paired_map):
    """uint8 tensors on the Flame's device (here the CPU) engage the
    batched step as resident frames and hold parity with host images."""
    fl = make_flame(2)
    drive(fl, 20, resident=True)
    assert fl._dispatches >= 5
    idm = fl.get_inverse_depth_map()
    assert coverage(idm) > 0.9 * coverage(paired_map)
    assert error(idm) < 0.02


def test_getter_flushes_pending_frame(paired, paired_map):
    # An odd number of frames leaves one buffered; a getter runs it.
    drive(paired, 1, start=20)
    if paired._batch_pending:
        paired.get_inverse_depth_map()
    assert not paired._batch_pending


def test_raw_idepths_accurate(paired):
    verts, mu, var = paired.get_raw_idepths()
    assert mu.shape[0] > 50
    assert np.median(np.abs(mu - 1 / PLANE_Z)) * PLANE_Z < 0.05


def test_failure_stats_and_mesh(paired):
    s = paired.failure_stats()
    assert s["updates"] > 0
    mesh = paired.get_inverse_depth_mesh()
    assert mesh["triangles"].shape[0] > 50
    assert np.isfinite(mesh["vertices"]).all()


def test_prune_without_current_pf_raises(paired):
    ids = sorted(paired._pf_slot_by_id.keys())
    assert len(ids) >= 2
    with pytest.raises(ValueError):
        paired.prune_poseframes(ids[:-1])  # drops the current poseframe
    # State untouched by the rejected call.
    assert sorted(paired._pf_slot_by_id.keys()) == ids


def test_alpha_clamped():
    """A sub-pixel edge gets alpha 1 / MIN_EDGE_LENGTH, not 1 / length
    (the Chambolle-Pock step condition under pair-scale staleness)."""
    from flame_tpu_torch.optimize import topology
    pos = torch.tensor([[10.0, 10.0], [10.001, 10.0], [30.0, 10.0],
                        [20.0, 25.0]])
    pad = torch.zeros((16, 2), dtype=torch.int64)
    pad[:3] = torch.tensor([[0, 1], [0, 2], [1, 3]])
    z = torch.zeros(16)
    ranks = torch.as_tensor(topology.build_edge_ranks(pad[:3].numpy(), 4,
                                                      16))
    topo = topology.from_edges(pad, 3, pos, pad, torch.zeros(16, dtype=bool),
                               z, z, z, 16, 4, 4, ranks=ranks)
    alpha = topo.alpha.numpy()
    assert alpha[0] <= 1.0 / topology.MIN_EDGE_LENGTH + 1e-6
    assert alpha[1] == pytest.approx(1.0 / 20.0)


def _flags():
    return (pipeline.PACK_MEMBER | pipeline.PACK_CURR_VALID
            | pipeline.PACK_FEAT_VALID)


def test_capacity_truncation_counted():
    """Overflowing a tiny triangle / edge capacity is counted, not
    silent."""
    params = Params(
        feature_capacity=256, edge_capacity=16, triangle_capacity=8,
        poseframe_capacity=4, min_height=-1e6, max_height=1e6,
        solver=SolverParams(max_vertex_degree=8, smoother="vertex"),
        debug_quiet=True)
    K = np.array([[FX, 0, W / 2], [0, FX, H / 2], [0, 0, 1]], np.float32)
    fl = flame_tpu_torch.Flame(W, H, K, np.linalg.inv(K),
                               port_params(params), device="cpu")
    rng = np.random.default_rng(0)
    pk = np.zeros((256, 3), np.uint16)
    for i in range(64):
        pk[i, 0] = int(rng.uniform(10, 150) * pipeline.PACK_XY_SCALE)
        pk[i, 1] = int(rng.uniform(10, 110) * pipeline.PACK_XY_SCALE)
        pk[i, 2] = _flags()
    assert fl._host_triangulate(pk) is not None
    stats = fl.failure_stats()
    assert stats["tris_truncated"] > 0
    assert stats["edges_truncated"] > 0


def test_snapshot_dedupe():
    """Coincident packed positions are deduped before Delaunay."""
    fl = make_flame(1)
    N = fl.params.feature_capacity
    pk = np.zeros((N, 3), np.uint16)
    # 4 members, two of them at the identical packed position.
    for i, (x, y) in enumerate([(320, 240), (320, 240), (960, 240),
                                (640, 720)]):
        pk[i] = (x, y, _flags())
    res = fl._host_triangulate(pk)
    assert res is not None
    tris_slots = res[0]
    assert tris_slots.shape[0] == 1  # the duplicate collapsed: one left
    assert 1 not in set(tris_slots.reshape(-1).tolist())
    assert fl.failure_stats()["members_deduped"] == 1


def _np(x):
    return {k: np.asarray(v) for k, v in x._asdict().items()}


def _fields(x):
    if dataclasses.is_dataclass(x):
        return {f.name: getattr(x, f.name) for f in dataclasses.fields(x)}
    return x._asdict()


def _assert_bit_equal(a, b, what):
    for name, v in _fields(a).items():
        assert torch.equal(v, _fields(b)[name]), f"{what}.{name}"


def test_batch_tracking_bit_equal_sequential(monkeypatch):
    """batch_step (B=2, detection off) reproduces two frame_track_step
    calls exactly, given the same state: the tracking, measurement and
    fusion chain of the batched loop is the sequential one (PARITY.md;
    later batch frames see the batch-start smoothing and seed cadence,
    which detection off keeps out)."""
    import __graft_entry__ as ge
    jp = ge._small_params()
    p = port_params(jp)
    Hh, Ww = 96, 128
    K, Kinv, stack, feats, fnew, graph = ge._synthetic_state(jp, Hh, Ww)
    tK, tKinv = (torch.as_tensor(np.array(a)) for a in (K, Kinv))

    def state():  # fresh copies: both steps write the stack in place
        return (convert.frame_stack_from_numpy(_np(stack), "cpu"),
                convert.feature_state_from_numpy(_np(feats), "cpu"))

    vv, uu = np.mgrid[0:Hh, 0:Ww].astype(np.float64)
    imgs = [torch.as_tensor(np.clip(
        128 + 60 * np.sin(0.5 * (uu + 2.0 * i)) + 30 * np.cos(0.3 * vv),
        0, 255).astype(np.uint8)) for i in (1, 2)]
    qs = [torch.tensor([1.0, 0, 0, 0]) for _ in (1, 2)]
    ts = [torch.tensor([0.1 * i, 0.0, 0.0]) for i in (1, 2)]
    seed = torch.full((Hh, Ww), float("nan"))
    prev_q, prev_t = (torch.as_tensor(np.array(a)) for a in (fnew.q, fnew.t))
    obs_seen = []
    track = pipeline.track_project_sync

    def recorded(*a, **kw):
        out = track(*a, **kw)
        obs_seen.append(out[4])
        return out
    monkeypatch.setattr(pipeline, "track_project_sync", recorded)

    # Sequential: two frame_track_step calls.
    st_s, fe_s = state()
    pq, pt = prev_q, prev_t
    stats_s = 0
    for b in range(2):
        f_s, fe_s, curr_s, member_s, st, _obs, packed_s = \
            pipeline.frame_track_step(p, tK, tKinv, st_s, fe_s, imgs[b],
                                      10 + b, qs[b], ts[b], 0, pq, pt, 0,
                                      seed, do_detect=False,
                                      do_insert=(b == 0))
        stats_s = stats_s + st
        pq, pt = f_s.q, f_s.t
    obs_seq, obs_seen[:] = list(obs_seen), []

    # Batched: one batch_step over the same two frames.
    st_b, fe_b = state()
    topo = convert.topology_from_words(
        np.zeros(2 + 3 * jp.triangle_capacity + 3 * jp.edge_capacity,
                 np.uint16), jp.triangle_capacity, jp.edge_capacity, "cpu")
    out = pipeline.batch_step(
        p, tK, tKinv, st_b, fe_b,
        convert.graph_state_from_numpy(_np(graph), "cpu"),
        torch.tensor(1.0), imgs, [10, 11], qs, ts, [True, False],
        [False, False], [0, 0], [0, 0], prev_q, prev_t, prev_q, prev_t,
        seed, topo, Ww, Hh)
    _f_b, _stack_b, fe_b, curr_b, member_b, stats_b, packed_b = out[:7]

    assert int(fe_s.valid.sum()) > 10
    _assert_bit_equal(fe_s, fe_b, "feats")
    assert len(obs_seq) == len(obs_seen) == 2
    for b in range(2):
        _assert_bit_equal(obs_seq[b], obs_seen[b], f"obs[{b}]")
    assert torch.equal(packed_s, packed_b)
    assert torch.equal(member_s, member_b)
    _assert_bit_equal(curr_s, curr_b, "curr")
    assert torch.equal(stats_s, stats_b)
    # The inserted poseframe (batch_step also stashes its map there).
    for name in ("frame_id", "q", "t", "img_pad", "gradx", "grady",
                 "valid"):
        assert torch.equal(getattr(st_s, name), getattr(_stack_b, name)), \
            f"stack.{name}"


def test_per_frame_dense_maps_in_batch():
    """Each poseframe inside a batch gets its own per-frame dense map
    (the reference rasterizes inside every update, flame.cc:409-415),
    not one batch-end map copied to all."""
    fl = make_flame(4)
    drive(fl, 24)
    assert fl._dispatches >= 3
    slots = [fl._pf_slot_by_id[fid] for fid in sorted(fl._pf_slot_by_id)]
    maps = [fl._stack.idepthmap[s].numpy() for s in slots]
    covs = [float(coverage(m)) for m in maps]
    populated = [m for m, c in zip(maps, covs) if c > 0.3]
    assert len(populated) >= 3, covs
    # Two poseframes of one batch see the scene from different camera
    # positions; their stashed maps must differ.
    diffs = []
    for a, b in zip(populated[:-1], populated[1:]):
        both = ~np.isnan(a) & ~np.isnan(b)
        if both.sum() > 100:
            diffs.append(float(np.max(np.abs(a[both] - b[both]))))
    assert diffs and max(diffs) > 1e-6, diffs
