"""The tracking step's graph runner (flame_tpu_torch/core/step_graph.py)
on the CPU.

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
from flame_tpu_torch.core import pipeline, step_graph  # noqa: E402
from flame_tpu_torch.core import frame as frame_mod  # noqa: E402
from flame_tpu_torch.params import (DetectionParams, Params,  # noqa: E402
                                    SolverParams)
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
    return step_graph._leaves(x)


def assert_bits(a, b):
    ta, tb = tensors(a), tensors(b)
    assert len(ta) == len(tb)
    for u, v in zip(ta, tb):
        assert u.dtype == v.dtype and u.shape == v.shape
        torch.testing.assert_close(u, v, rtol=0, atol=0, equal_nan=True)


class Recorder:
    """Wraps pipeline functions by their module names, as the benchmark
    does: keeps each call's outputs as returned and a copy of them
    taken at once."""

    def __init__(self, monkeypatch, names):
        self.calls = {n: [] for n in names}
        for n in names:
            orig = getattr(pipeline, n)

            def wrapper(*a, _orig=orig, _n=n, **kw):
                out = _orig(*a, **kw)
                self.calls[_n].append(
                    (out, [t.clone() for t in tensors(out)]))
                return out
            monkeypatch.setattr(pipeline, n, wrapper)

    def check_unchanged(self, name):
        """Every output of `name` still holds what it held when it was
        returned: no later replay wrote over it."""
        for out, copy in self.calls[name]:
            for t, c in zip(tensors(out), copy):
                torch.testing.assert_close(t, c, rtol=0, atol=0,
                                           equal_nan=True)


def run(monkeypatch, capture, n, pf_every, names, **kw):
    """n frames through a Flame whose stack takes `capture` (None: the
    device's own path)."""
    fl = make_flame(**kw)
    if capture is not None:
        step_graph.attach(fl._stack, capture)
    with monkeypatch.context() as m:
        rec = Recorder(m, names)
        fb = int(fl.params.solver.frame_batch)
        for i in range(n):
            fl.update(i * 0.1, i, pose(i), render(0.15 * i),
                      i % pf_every == 0)
            if (i + 1) % fb == 0:
                fl.get_inverse_depth_map()
    return fl, rec


def counters(fl):
    return {f"{k}_graph_{c}": int(fl.stats.stats(f"{k}_graph_{c}"))
            for k in ("track", "detect") for c in step_graph.COUNTERS}


def test_sync_track_step_graphed_matches_eager(monkeypatch):
    """12 tracked synchronous frames (16 frames, the first four
    bootstrap), poseframes every 4th: three of them detect."""
    names = ("track_step", "_detect_and_insert")
    ref, rec_e = run(monkeypatch, None, 16, 4, names)
    fl, rec_g = run(monkeypatch, step_graph.eager_capture, 16, 4, names)
    steps_e, steps_g = rec_e.calls["track_step"], rec_g.calls["track_step"]
    assert len(steps_g) == len(steps_e) == 12
    for (eo, _), (go, _) in zip(steps_e, steps_g):
        # feats, curr, member, stats, obs, packed
        assert_bits(eo, go)
    assert len(rec_g.calls["_detect_and_insert"]) == 3
    assert_bits(ref._feats, fl._feats)
    assert_bits(ref._curr, fl._curr)
    assert_bits(ref._last_stats_dev, fl._last_stats_dev)
    for name in names:
        rec_g.check_unchanged(name)
    assert counters(fl) == dict(
        track_graph_captures=1, track_graph_replays=len(steps_g),
        track_graph_eager=0, detect_graph_captures=1,
        detect_graph_replays=3, detect_graph_eager=0)
    assert counters(ref) == dict.fromkeys(counters(ref), 0)
    # The newest tracker, which the span report reads the counters from.
    assert stats.latest_tracker() is fl.stats


def test_batch_step_graphed_matches_eager(monkeypatch):
    """One warm-up batch and two steps of B=8 under do_ba: the summed
    stats, the packed transfer with the frames' matches, and each
    frame's obs."""
    names = ("batch_step", "track_project_sync")
    kw = dict(async_topology=True, frame_batch=8, do_ba=True)
    ref, rec_e = run(monkeypatch, None, 24, 4, names, **kw)
    fl, rec_g = run(monkeypatch, step_graph.eager_capture, 24, 4, names, **kw)
    bs_e, bs_g = rec_e.calls["batch_step"], rec_g.calls["batch_step"]
    assert len(bs_g) == len(bs_e) >= 2
    for (eo, _), (go, _) in zip(bs_e, bs_g):
        assert_bits(eo[5], go[5])  # stats summed over the batch
        assert_bits(eo[6], go[6])  # packed, widened with the matches
        assert_bits(eo[2], go[2])  # feats'
    tr_e, tr_g = (r.calls["track_project_sync"] for r in (rec_e, rec_g))
    assert len(tr_g) == len(tr_e)
    for (eo, _), (go, _) in zip(tr_e, tr_g):
        assert_bits(eo[4], go[4])  # obs
        assert_bits(eo[3], go[3])  # stats
    # (batch_step returns the stack, which later steps write in place.)
    rec_g.check_unchanged("track_project_sync")
    c = counters(fl)
    assert c["track_graph_captures"] == 1
    assert c["track_graph_replays"] == len(tr_g)
    assert c["detect_graph_captures"] == 1
    assert c["track_graph_eager"] == c["detect_graph_eager"] == 0


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


@pytest.mark.parametrize("case", ["slots", "storage", "params", "outputs"])
def test_runner_keys_and_outputs(tracked_state, case):
    """slots: curr_pf_slot moving over the live slots replays one graph;
    storage: a stack tensor given new storage recaptures once; params:
    so does another Params object; outputs: call k's tensors are
    unchanged after call k + 1."""
    params, K, Kinv, stack, feats, frames = _state(tracked_state)
    steps = step_graph.attach(stack, step_graph.eager_capture)
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
    replay per call."""
    kw = dict(device=cuda)
    if posture == "batched":
        kw.update(async_topology=True, frame_batch=8, do_ba=True)
    names = ("track_project_sync", "_detect_and_insert")
    with monkeypatch.context() as m:
        m.setattr(step_graph, "steps_for", lambda stack: None)
        ref, rec_e = run(m, None, 24, 4, names, **kw)
    fl, rec_g = run(monkeypatch, None, 24, 4, names, **kw)
    for name in names:
        assert len(rec_g.calls[name]) == len(rec_e.calls[name]) >= 1
        for (eo, _), (go, _) in zip(rec_e.calls[name], rec_g.calls[name]):
            assert_bits(eo, go)
        rec_g.check_unchanged(name)
    assert_bits(ref._feats, fl._feats)
    np.testing.assert_array_equal(ref.get_inverse_depth_map(),
                                  fl.get_inverse_depth_map())
    assert counters(fl) == dict(
        track_graph_captures=1,
        track_graph_replays=len(rec_g.calls["track_project_sync"]),
        track_graph_eager=0, detect_graph_captures=1,
        detect_graph_replays=len(rec_g.calls["_detect_and_insert"]),
        detect_graph_eager=0)
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
