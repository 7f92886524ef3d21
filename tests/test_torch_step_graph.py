"""The graph runner (flame_tpu_torch/step_graph.py) of the tracking
step, the post-Delaunay section and the BA solves, on the CPU.

A CPU stack takes the runner only through step_graph.attach, here with
eager_capture: the body runs on the runner's own buffers (the copied-in
inputs and the device scalars) and each replay writes over the same
output tensors, as a CUDA graph's replay does. Every case holds the
runner to the plain eager call bit for bit, on the 160x120 plane of
test_torch_tracing.py with the port's own Params; the card's own check
of the captured graphs is chip_smoke.py's phase 16 and
tests/test_torch_kernels.py.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import flame_tpu_torch  # noqa: E402
from flame_tpu_torch import step_graph  # noqa: E402
from flame_tpu_torch.ba import window  # noqa: E402
from flame_tpu_torch.core import pipeline  # noqa: E402
from flame_tpu_torch.core import frame as frame_mod  # noqa: E402
from flame_tpu_torch.ops import raster_kernel  # noqa: E402
from flame_tpu_torch.optimize import smoother_kernel  # noqa: E402
from flame_tpu_torch.params import (BAParams, DetectionParams,  # noqa: E402
                                    Params, SolverParams)
from flame_tpu_torch.parallel import distributed_ba, sharding  # noqa: E402
from flame_tpu_torch.utils import stats  # noqa: E402

FX = 100.0
W, H = 160, 120
PLANE_Z = 5.0


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def render(cam_x):
    vv, uu = np.mgrid[0:H, 0:W].astype(np.float64)
    X = (uu - W / 2) * PLANE_Z / FX + cam_x
    Y = (vv - H / 2) * PLANE_Z / FX
    t = (128 + 60 * np.sin(4.1 * X + 0.9 * Y) + 35 * np.cos(1.73 * X)
         + 18 * np.sin(2.31 * Y) + 10 * np.sin(0.83 * X))
    return np.clip(t, 0, 255).astype(np.uint8)


def pose(i):
    return (np.array([1.0, 0, 0, 0], np.float32),
            np.array([0.15 * i, 0.0, 0.0], np.float32))


def make_flame(async_topology=False, frame_batch=1, do_ba=False,
               device="cpu"):
    params = Params(
        feature_capacity=512, edge_capacity=2048, triangle_capacity=1024,
        poseframe_capacity=8, min_height=-100.0, max_height=100.0,
        idepth_init=0.05, idepth_var_init=0.25, do_ba=do_ba,
        detection=DetectionParams(win_size=16),
        solver=SolverParams(n_iters_per_frame=10, max_vertex_degree=16,
                            async_topology=async_topology,
                            coalesce_uploads=True, frame_batch=frame_batch,
                            deterministic=True, smoother="vertex"),
        debug_quiet=True)
    K = np.array([[FX, 0, W / 2], [0, FX, H / 2], [0, 0, 1]], np.float32)
    Kinv = np.linalg.inv(K.astype(np.float64)).astype(np.float32)
    return flame_tpu_torch.Flame(W, H, K, Kinv, params, device=device)


def tensors(x):
    return _tensors_of(x)


def assert_bits(a, b):
    ta, tb = tensors(a), tensors(b)
    assert len(ta) == len(tb)
    for u, v in zip(ta, tb):
        assert u.dtype == v.dtype and u.shape == v.shape
        torch.testing.assert_close(u, v, rtol=0, atol=0, equal_nan=True)


class Recorder:
    """Wraps functions by their module names, as the benchmark does:
    keeps each call's inputs and outputs as handed over, with copies of
    them taken at once. points: (module, attribute) pairs; calls are
    keyed by the attribute's name."""

    def __init__(self, monkeypatch, points):
        self.calls = {n: [] for _, n in points}
        for mod, n in points:
            orig = getattr(mod, n)

            def wrapper(*a, _orig=orig, _n=n, **kw):
                args = (a, kw)
                a_copy = [t.clone() for t in tensors(args)]
                out = _orig(*a, **kw)
                self.calls[_n].append(
                    (out, [t.clone() for t in tensors(out)], args, a_copy))
                return out
            monkeypatch.setattr(mod, n, wrapper)

    def outputs(self, name):
        return [c[0] for c in self.calls[name]]

    def check_unchanged(self, name, inputs=False):
        """Every output of `name` (and with inputs, every tensor handed
        to it) still holds what it held then: no later replay wrote over
        it."""
        for out, copy, args, a_copy in self.calls[name]:
            pairs = list(zip(tensors(out), copy))
            if inputs:
                pairs += list(zip(tensors(args), a_copy))
            for t, c in pairs:
                torch.testing.assert_close(t, c, rtol=0, atol=0,
                                           equal_nan=True)


def _tensors_of(x):
    """_leaves, through the dicts of keyword arguments too."""
    if isinstance(x, dict):
        return [t for v in x.values() for t in _tensors_of(v)]
    if isinstance(x, (tuple, list)):
        return [t for v in x for t in _tensors_of(v)]
    return step_graph._leaves(x)


def points(*names):
    """(module, attribute) of the pipeline's functions by name, and of the
    post-Delaunay section's two calls by name (smooth, rasterize)."""
    mods = {"smooth": smoother_kernel, "rasterize": raster_kernel}
    return [(mods.get(n, pipeline), n) for n in names]


def run(monkeypatch, capture, n, pf_every, names, **kw):
    """n frames through a Flame whose stack takes `capture` (None: the
    device's own path)."""
    fl = make_flame(**kw)
    if capture is not None:
        step_graph.attach(fl._stack, capture)
    with monkeypatch.context() as m:
        rec = Recorder(m, points(*names))
        fb = int(fl.params.solver.frame_batch)
        for i in range(n):
            fl.update(i * 0.1, i, pose(i), render(0.15 * i),
                      i % pf_every == 0)
            if (i + 1) % fb == 0:
                fl.get_inverse_depth_map()
    return fl, rec


def counters(fl, kinds=step_graph.KINDS):
    return {f"{k}_graph_{c}": int(fl.stats.stats(f"{k}_graph_{c}"))
            for k in kinds for c in step_graph.COUNTERS}


POST = ("_post_delaunay_inner", "smooth", "rasterize")
SECTION = ("post", "smooth", "mesh", "raster")


def section_counters(n_calls):
    """The post-Delaunay section's counters after n_calls replayed calls:
    one capture and a replay per call for each of its four graphs."""
    return {f"{k}_graph_{c}": v for k in SECTION for c, v in (
        ("captures", 1), ("replays", n_calls), ("eager", 0))}


@pytest.fixture(scope="module")
def sync_runs():
    """16 synchronous frames, poseframes every 4th, eager and with the
    runner (eager_capture), every call by name recorded."""
    names = ("track_step", "_detect_and_insert") + POST
    with pytest.MonkeyPatch.context() as mp:
        ref, rec_e = run(mp, None, 16, 4, names)
        fl, rec_g = run(mp, step_graph.eager_capture, 16, 4, names)
    return ref, rec_e, fl, rec_g


def test_sync_track_step_graphed_matches_eager(sync_runs):
    """12 tracked synchronous frames (16 frames, the first four
    bootstrap), poseframes every 4th: three of them detect."""
    names = ("track_step", "_detect_and_insert")
    ref, rec_e, fl, rec_g = sync_runs
    steps_e, steps_g = rec_e.outputs("track_step"), rec_g.outputs(
        "track_step")
    assert len(steps_g) == len(steps_e) == 12
    for eo, go in zip(steps_e, steps_g):
        # feats, curr, member, stats, obs, packed
        assert_bits(eo, go)
    assert len(rec_g.calls["_detect_and_insert"]) == 3
    assert_bits(ref._feats, fl._feats)
    assert_bits(ref._curr, fl._curr)
    assert_bits(ref._last_stats_dev, fl._last_stats_dev)
    for name in names:
        rec_g.check_unchanged(name)
    assert counters(fl, ("track", "detect")) == dict(
        track_graph_captures=1, track_graph_replays=len(steps_g),
        track_graph_eager=0, detect_graph_captures=1,
        detect_graph_replays=3, detect_graph_eager=0)
    assert counters(ref) == dict.fromkeys(counters(ref), 0)
    # The newest tracker, which the span report reads the counters from.
    assert stats.latest_tracker() is fl.stats


def _check_section(rec_e, rec_g, n_calls, normals=True):
    """The section's calls by name, graphed against eager: each called
    once per post-Delaunay step with equal inputs and outputs, bit for
    bit (normals=False: but the normals, which index_add_'s atomics sum
    in no fixed order on the card), and nothing handed over changed by a
    later replay."""
    for name in POST:
        calls_e, calls_g = rec_e.calls[name], rec_g.calls[name]
        assert len(calls_e) == len(calls_g) == n_calls, name
        for (eo, _, ea, _), (go, _, ga, _) in zip(calls_e, calls_g):
            assert_bits(_tensors_of(ea), _tensors_of(ga))
            if name == "_post_delaunay_inner" and not normals:
                eo, go = eo[:2] + eo[3:], go[:2] + go[3:]
            assert_bits(eo, go)
        rec_g.check_unchanged(name, inputs=True)


def test_sync_post_delaunay_graphed_matches_eager(sync_runs):
    """The 11 post-Delaunay steps of the synchronous run (the first
    tracked frame has no triangulation yet): smooth and rasterize called
    by name inside each, the graph state, map, validity and normals
    bit-equal, and the section's counters: one capture and 11 replays a
    graph."""
    ref, rec_e, fl, rec_g = sync_runs
    _check_section(rec_e, rec_g, 11)
    assert_bits(ref._graph, fl._graph)
    assert_bits([ref._idepthmap, ref._tri_validity, ref._vtx_normals,
                 ref._coverage], [fl._idepthmap, fl._tri_validity,
                                  fl._vtx_normals, fl._coverage])
    assert counters(fl, SECTION) == section_counters(11)


@pytest.fixture(scope="module")
def batch_runs():
    """One warm-up batch and two steps of B=8 under do_ba, eager and with
    the runner."""
    names = ("batch_step", "track_project_sync") + POST
    kw = dict(async_topology=True, frame_batch=8, do_ba=True)
    with pytest.MonkeyPatch.context() as mp:
        ref, rec_e = run(mp, None, 24, 4, names, **kw)
        fl, rec_g = run(mp, step_graph.eager_capture, 24, 4, names, **kw)
    return ref, rec_e, fl, rec_g


def test_batch_step_graphed_matches_eager(batch_runs):
    """The batched steps: the summed stats, the packed transfer with the
    frames' matches, and each frame's obs."""
    ref, rec_e, fl, rec_g = batch_runs
    bs_e, bs_g = rec_e.outputs("batch_step"), rec_g.outputs("batch_step")
    assert len(bs_g) == len(bs_e) >= 2
    for eo, go in zip(bs_e, bs_g):
        assert_bits(eo[5], go[5])  # stats summed over the batch
        assert_bits(eo[6], go[6])  # packed, widened with the matches
        assert_bits(eo[2], go[2])  # feats'
    tr_e, tr_g = (r.outputs("track_project_sync") for r in (rec_e, rec_g))
    assert len(tr_g) == len(tr_e)
    for eo, go in zip(tr_e, tr_g):
        assert_bits(eo[4], go[4])  # obs
        assert_bits(eo[3], go[3])  # stats
    # (batch_step returns the stack, which later steps write in place.)
    rec_g.check_unchanged("track_project_sync")
    c = counters(fl)
    assert c["track_graph_captures"] == 1
    assert c["track_graph_replays"] == len(tr_g)
    assert c["detect_graph_captures"] == 1
    assert c["track_graph_eager"] == c["detect_graph_eager"] == 0
    # Every BA solve replays through the stack's runner.
    assert c["ba_graph_replays"] == fl.stats.stats("ba_single_solves") >= 1


def test_batch_post_delaunay_graphed_matches_eager(batch_runs):
    """The batched run's post-Delaunay section, once per batched step
    and once in the single-frame warm-up: smooth and rasterize by name,
    bit-equal to the eager path, nothing handed over changed later, a
    replay per call."""
    ref, rec_e, fl, rec_g = batch_runs
    n = len(rec_e.calls["_post_delaunay_inner"])
    assert n == len(rec_g.calls["batch_step"]) + 1
    _check_section(rec_e, rec_g, n)
    assert_bits(ref._graph, fl._graph)
    assert_bits([ref._idepthmap, ref._vtx_normals, ref._tri_validity],
                [fl._idepthmap, fl._vtx_normals, fl._tri_validity])
    assert counters(fl, SECTION) == section_counters(n)


@pytest.fixture(scope="module")
def tracked_state():
    """A synchronous run's stack and features, and its next two frames."""
    fl = make_flame()
    for i in range(8):
        fl.update(i * 0.1, i, pose(i), render(0.15 * i), i % 2 == 0)
    p = fl.params
    frames = [frame_mod.create(
        i, torch.as_tensor(pose(i)[0]), torch.as_tensor(pose(i)[1]),
        torch.as_tensor(render(0.15 * i)), p.pad) for i in (8, 9)]
    return fl, frames


def _state(tracked_state):
    fl, frames = tracked_state
    stack = dataclasses.replace(
        fl._stack, **{f.name: getattr(fl._stack, f.name).clone()
                      for f in dataclasses.fields(fl._stack)})
    return fl.params, fl.K, fl.Kinv, stack, fl._feats, frames


def _ba_solves(steps, stack, pad, kind):
    """Kind "ba" (window._solve_graphed on the stack's img_pad) or
    "ba_sharded" (solve_window_sharded over two partitions, the runner
    current) on well-posed windows of 3 and 4 poses, two each: every
    result equal to the eager call's, each window size captured once and
    replayed at every call, and no result changed by a later replay."""
    p = BAParams(max_landmarks=64, max_obs=256)
    L, M = p.max_landmarks, p.max_obs
    Kn = np.array([[FX, 0, W / 2], [0, FX, H / 2], [0, 0, 1]])
    K = torch.tensor(Kn, dtype=torch.float32)
    Kinv = torch.linalg.inv(K)
    mesh = sharding.make_mesh(2, "cpu")

    def solve(P, seed, current):
        buf = torch.as_tensor(window.well_posed_window(
            P, L, M, Kn, seed, (20, 100), n_invalid=9))
        if kind == "ba":
            return window._solve_graphed(current, p, K, Kinv, buf,
                                         stack.img_pad, pad, 2, P, L, M)
        problem, _ = window._decode_packed(buf, P, L, M)
        with step_graph.active(current):
            return distributed_ba.solve_window_sharded(p, K, Kinv, problem,
                                                       mesh)
    outs = []
    for P in (3, 4):
        for seed in (0, 1):
            got = solve(P, seed, steps)
            assert_bits(solve(P, seed, None), got)
            outs.append((got, [t.clone() for t in tensors(got)]))
    for got, copy in outs:
        assert_bits(got, copy)
    assert not torch.equal(tensors(outs[0][0])[0], tensors(outs[1][0])[0])
    assert steps.counts == {f"{kind}_graph_captures": 2,
                            f"{kind}_graph_replays": 4}


@pytest.mark.parametrize("case", ["slots", "storage", "params", "outputs",
                                  "ba", "ba_sharded"])
def test_runner_keys_and_outputs(tracked_state, case):
    """slots: curr_pf_slot moving over the live slots replays one graph;
    storage: a stack tensor given new storage recaptures once; params:
    so does another Params object; outputs: call k's tensors are
    unchanged after call k + 1; ba and ba_sharded: the BA window solves
    (_ba_solves)."""
    params, K, Kinv, stack, feats, frames = _state(tracked_state)
    steps = step_graph.attach(stack, step_graph.eager_capture)
    if case.startswith("ba"):
        _ba_solves(steps, stack, params.pad, case)
        return
    slots = [s for s in range(stack.valid.shape[0]) if bool(stack.valid[s])]
    assert len(slots) >= 3

    def both(slot, fr):
        want = pipeline._track_project_sync(params, K, Kinv, stack, feats,
                                            fr, slot)
        got = pipeline.track_project_sync(params, K, Kinv, stack, feats, fr,
                                          slot)
        assert_bits(want, got)
        return got

    if case == "slots":
        for k, slot in enumerate(slots):
            both(slot, frames[k % 2])
        assert steps.counts == dict(track_graph_captures=1,
                                    track_graph_replays=len(slots))
    elif case in ("storage", "params"):
        both(slots[0], frames[0])
        both(slots[1], frames[1])
        if case == "storage":
            stack.img_pad = stack.img_pad.clone()
        else:
            params = params.replace(outlier_sigma_thresh=2.0)
        both(slots[0], frames[0])
        both(slots[1], frames[1])
        assert steps.counts == dict(track_graph_captures=2,
                                    track_graph_replays=4)
    else:
        first = both(slots[0], frames[0])
        copy = [t.clone() for t in tensors(first)]
        second = both(slots[1], frames[1])
        assert any(not torch.equal(a, b) for a, b in zip(
            tensors(first), tensors(second)))
        assert_bits(first, copy)
        assert steps.counts["track_graph_captures"] == 1


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("posture", ["sync", "batched"])
def test_cuda_graphs_match_eager(cuda, monkeypatch, posture):
    """On the card: the captured graphs against the eager path (steps_for
    patched to None), bit for bit, with one capture per graph and a
    replay per call; the post-Delaunay section's calls by name, K1 and
    K2 launched once per call."""
    from flame_tpu_torch import _kernels
    kw = dict(device=cuda)
    if posture == "batched":
        kw.update(async_topology=True, frame_batch=8, do_ba=True)
    names = ("track_project_sync", "_detect_and_insert")
    with monkeypatch.context() as m:
        m.setattr(step_graph, "steps_for", lambda stack: None)
        ref, rec_e = run(m, None, 24, 4, names + POST, **kw)
    _kernels.reset_launches()
    fl, rec_g = run(monkeypatch, None, 24, 4, names + POST, **kw)
    n_post = len(rec_g.calls["_post_delaunay_inner"])
    assert n_post >= 1
    assert _kernels.LAUNCHES["nltgv2_smoother"] == n_post
    assert _kernels.LAUNCHES["raster_mesh"] == n_post
    for name in names:
        assert len(rec_g.calls[name]) == len(rec_e.calls[name]) >= 1
        for eo, go in zip(rec_e.outputs(name), rec_g.outputs(name)):
            assert_bits(eo, go)
        rec_g.check_unchanged(name)
    _check_section(rec_e, rec_g, n_post, normals=False)
    assert_bits(ref._feats, fl._feats)
    assert_bits(ref._graph, fl._graph)
    np.testing.assert_array_equal(ref.get_inverse_depth_map(),
                                  fl.get_inverse_depth_map())
    assert counters(fl, ("track", "detect") + SECTION) == dict(
        track_graph_captures=1,
        track_graph_replays=len(rec_g.calls["track_project_sync"]),
        track_graph_eager=0, detect_graph_captures=1,
        detect_graph_replays=len(rec_g.calls["_detect_and_insert"]),
        detect_graph_eager=0, **section_counters(n_post))
    assert counters(ref) == dict.fromkeys(counters(ref), 0)


@pytest.mark.cuda
def test_cuda_graph_recaptures_on_new_storage(cuda, tracked_state):
    """On the card: a stack tensor moved to new storage recaptures once,
    and the replays equal the eager body."""
    params, K, Kinv, stack, feats, frames = _state(tracked_state)
    mv = lambda x: x.to(cuda)  # noqa: E731
    K, Kinv = mv(K), mv(Kinv)
    stack = dataclasses.replace(stack, **{
        f.name: mv(getattr(stack, f.name))
        for f in dataclasses.fields(stack)})
    feats = dataclasses.replace(feats, **{
        f.name: mv(getattr(feats, f.name))
        for f in dataclasses.fields(feats)})
    frames = [dataclasses.replace(fr, **{
        k: mv(getattr(fr, k)) for k in ("q", "t", "img", "img_pad", "gradx",
                                        "grady")}) for fr in frames]
    slot = next(s for s in range(stack.valid.shape[0])
                if bool(stack.valid[s]))
    for k in range(4):
        if k == 2:
            stack.img_pad = stack.img_pad.clone()
        want = pipeline._track_project_sync(params, K, Kinv, stack, feats,
                                            frames[k % 2], slot)
        got = pipeline.track_project_sync(params, K, Kinv, stack, feats,
                                          frames[k % 2], slot)
        assert_bits(want, got)
    assert step_graph.counts(stack) == dict(track_graph_captures=2,
                                            track_graph_replays=4)
