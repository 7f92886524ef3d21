"""The port's frame-tagged spans (flame_tpu_torch/utils/stats.py) on the
CPU: what Flame records on the synchronous, async and batched paths,
their nesting, the bounded stores, the profiler annotations and the
update()->map latency read from the spans.

The scene is test_torch_pair_mode.py's 160x120 textured plane with the
port's own Params (no JAX package here).
"""

import gc
import json
import os
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import flame_tpu_torch  # noqa: E402
from flame_tpu_torch import step_graph  # noqa: E402
from flame_tpu_torch.params import (BAParams, DetectionParams,  # noqa: E402
                                    Params, SolverParams)
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


def make_flame(async_topology=False, frame_batch=1, ba=None):
    params = Params(do_ba=ba is not None, ba=ba or BAParams(),
        feature_capacity=512, edge_capacity=2048, triangle_capacity=1024,
        poseframe_capacity=8, min_height=-100.0, max_height=100.0,
        idepth_init=0.05, idepth_var_init=0.25,
        detection=DetectionParams(win_size=16),
        solver=SolverParams(n_iters_per_frame=10, max_vertex_degree=16,
                            async_topology=async_topology,
                            coalesce_uploads=True, frame_batch=frame_batch,
                            smoother="vertex"),
        debug_quiet=True)
    K = np.array([[FX, 0, W / 2], [0, FX, H / 2], [0, 0, 1]], np.float32)
    Kinv = np.linalg.inv(K.astype(np.float64)).astype(np.float32)
    return flame_tpu_torch.Flame(W, H, K, Kinv, params, device="cpu")


def drive(fl, n, start=0):
    """n frames from `start`, the map read after each full batch, as
    the benchmark's closed loop reads it."""
    fb = int(fl.params.solver.frame_batch)
    for i in range(start, start + n):
        cam_x = 0.15 * i
        fl.update(i * 0.1, i, (np.array([1.0, 0, 0, 0], np.float32),
                               np.array([cam_x, 0.0, 0.0], np.float32)),
                  render(cam_x), i % 2 == 0)
        if (i + 1) % fb == 0:
            fl.get_inverse_depth_map()


@pytest.fixture(scope="module")
def sync_run():
    fl = make_flame()
    drive(fl, 10)
    return fl


@pytest.fixture(scope="module")
def async_run():
    fl = make_flame(async_topology=True)
    drive(fl, 12)
    fl._adopt_tri_result(force=True)  # the worker's last span has ended
    return fl


@pytest.fixture(scope="module")
def batch_run():
    fl = make_flame(async_topology=True, frame_batch=4)
    drive(fl, 16)
    fl._adopt_tri_result(force=True)
    return fl


@pytest.fixture(scope="module")
def ba_run():
    """The synchronous path with windowed BA; every solve fails the cost
    gate (max_mean_cost 0), so each apply is a rejection."""
    fl = make_flame(ba=BAParams(max_landmarks=256, max_obs=1024,
                                max_mean_cost=0.0))
    drive(fl, 12)
    return fl


def _by_seq(spans):
    return {s.seq: s for s in spans}


def test_one_update_root_span_per_call(sync_run):
    spans = sync_run.stats.spans.spans()
    roots = sorted((s for s in spans if s.name == "update"
                    and s.parent < 0), key=lambda s: s.start_ns)
    assert [s.frames for s in roots] == [(i,) for i in range(10)]
    assert [s.poseframe for s in roots] == [i % 2 == 0 for i in range(10)]
    names = {s.name for s in spans}
    assert {"upload", "frame_creation", "update_idepths", "triangulate",
            "snapshot_wait", "delaunay", "topo_upload", "sync_graph",
            "smoother", "raster", "map_read"} <= names
    # A tracked frame's spans carry its id and poseframe flag.
    for s in spans:
        if s.name in ("update_idepths", "snapshot_wait", "delaunay"):
            assert len(s.frames) == 1
            assert s.poseframe == (s.frames[0] % 2 == 0)
    # The map read is tagged with the newest frame handed to update().
    reads = sorted((s for s in spans if s.name == "map_read"),
                   key=lambda s: s.start_ns)
    assert [s.frames for s in reads] == [(i,) for i in range(10)]
    # timings() keeps the last value of the keys it kept before.
    t = sync_run.stats.snapshot()["timings_ms"]
    assert {"update", "triangulate", "delaunay", "topo_upload"} <= set(t)
    assert not {"upload", "snapshot_wait", "map_read"} & set(t)


def test_delaunay_walk_steps_counter(sync_run):
    """The synchronous path's Delaunay leaves the mean walk length of its
    latest call in Flame.stats; failure_stats() keeps the JAX package's
    keys."""
    assert "delaunay_walk_steps" in sync_run.stats.snapshot()["stats"]
    assert 1.0 <= sync_run.stats.stats("delaunay_walk_steps") < 8.0
    assert "delaunay_walk_steps" not in sync_run.failure_stats()


@pytest.mark.parametrize("run", ["sync_run", "async_run", "batch_run",
                                 "ba_run"])
def test_children_nest_inside_parents(run, request):
    fl = request.getfixturevalue(run)
    spans = fl.stats.spans.spans()
    seq = _by_seq(spans)
    kids = {}
    for s in spans:
        assert s.start_ns <= s.end_ns
        if s.parent < 0:
            continue
        p = seq[s.parent]
        assert p.thread == s.thread
        assert p.start_ns <= s.start_ns and s.end_ns <= p.end_ns
        kids.setdefault(p.seq, []).append(s)
    for pseq, ch in kids.items():
        assert seq[pseq].end_ns - seq[pseq].start_ns \
            >= sum(c.end_ns - c.start_ns for c in ch)


def test_batched_step_spans_carry_the_batch(batch_run):
    spans = batch_run.stats.spans.spans()
    seq = _by_seq(spans)
    steps = [s for s in spans if s.name == "batch_step"]
    assert len(steps) >= 2
    for st in steps:
        assert len(st.frames) == 4
        assert list(st.frames) == list(range(st.frames[0],
                                             st.frames[0] + 4))
        # The step runs inside its last frame's update().
        root = seq[st.parent]
        assert root.name == "update" and root.frames == (st.frames[-1],)
        inner = [s for s in spans if s.parent == st.seq]
        assert {"raster_batch", "update_idepths", "sync_graph"} <= {
            s.name for s in inner}
        for s in inner:
            assert s.frames == st.frames


def test_worker_delaunay_spans(async_run):
    spans = async_run.stats.spans.spans()
    seq = _by_seq(spans)
    main = {s.thread for s in spans if s.name == "update"}
    assert len(main) == 1
    worker = [s for s in spans if s.name == "delaunay"
              and s.thread not in main]
    assert len(worker) >= 3
    updated = {s.frames[0] for s in spans if s.name == "update"}
    for s in worker:
        assert s.parent == -1 and len(s.frames) == 1
        assert s.frames[0] in updated
        cause = seq[s.link]
        assert cause.thread in main and cause.start_ns <= s.start_ns
        # The snapshot is that of an earlier frame than the one whose
        # update started the triangulation, or of that frame itself.
        assert s.frames[0] <= max(cause.frames)


def test_ring_stays_at_capacity(monkeypatch):
    monkeypatch.setattr(stats, "SPAN_CAPACITY", 64)
    tr = stats.StatsTracker()
    assert stats.latest() is tr.spans
    for i in range(200):
        with tr.span("frame", frames=(i,)):
            with tr.timed("block"):
                pass
    ring = tr.spans.spans()
    assert len(tr.spans) == len(ring) == 64
    assert [s.frames[0] for s in ring] == [i for i in range(168, 200)
                                           for _ in range(2)]
    assert [s.name for s in ring] == ["block", "frame"] * 32
    assert tr.spans.lost_end_ns >= 0
    assert tr.spans.lost_end_ns <= ring[0].end_ns
    # latest() outlives its tracker.
    ring_obj = tr.spans
    del tr
    gc.collect()
    assert stats.latest() is ring_obj and len(ring_obj) == 64


def test_cuda_event_store_is_bounded(monkeypatch):
    """timed()'s CUDA-event pairs per stage stop at EVENT_CAPACITY,
    oldest dropped, and device_times_ms() keeps its order (stand-in
    events: no card here)."""
    class FakeEvent:
        clock = 0

        def __init__(self, enable_timing=False):
            self.t = None

        def record(self):
            FakeEvent.clock += 1
            self.t = FakeEvent.clock

        def elapsed_time(self, end):
            return float(end.t - self.t)

    monkeypatch.setattr(torch.cuda, "Event", FakeEvent)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda: None)
    monkeypatch.setattr(stats, "EVENT_CAPACITY", 8)
    tr = stats.StatsTracker(device="cpu")
    tr._cuda = True
    for _ in range(20):
        with tr.timed("stage"):
            with tr.timed("inner"):
                pass
    first = tr.device_times_ms()
    assert len(first["stage"]) == len(first["inner"]) == 8
    assert first["stage"] == [3.0] * 8 and first["inner"] == [1.0] * 8
    with tr.timed("stage"):
        pass
    again = tr.device_times_ms()
    assert len(again["stage"]) == 8 and again["stage"][-1] == 1.0
    assert again["stage"][:-1] == first["stage"][1:]


def test_profiler_annotations_nest_as_spans(tmp_path):
    fl = make_flame()
    drive(fl, 4)
    n0 = fl.stats.next_seq()
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        drive(fl, 2, start=4)
    path = os.path.join(tmp_path, "trace.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    spans = [s for s in fl.stats.spans.spans() if s.seq > n0]
    assert spans and all(s.profiled for s in spans)
    main = {s.thread for s in spans if s.name == "update"}
    mine = sorted((s for s in spans if s.thread in main),
                  key=lambda s: s.start_ns)
    ann = [e for e in events if e.get("ph") == "X"
           and e.get("cat") == "user_annotation"
           and e["name"].startswith("flame.")]
    tids = {e["tid"] for e in ann if e["name"] == "flame.update"}
    assert len(tids) == 1
    ann = sorted((e for e in ann if e["tid"] in tids),
                 key=lambda e: (e["ts"], -e["dur"]))
    assert [e["name"] for e in ann] == ["flame." + s.name for s in mine]
    ev = {s.seq: e for s, e in zip(mine, ann)}
    for s in mine:
        if s.parent in ev:
            p, c = ev[s.parent], ev[s.seq]
            assert p["ts"] <= c["ts"]
            assert c["ts"] + c["dur"] <= p["ts"] + p["dur"]
    assert not any(s.profiled for s in fl.stats.spans.spans()
                   if s.seq < n0)


def test_no_record_function_without_a_profiler(monkeypatch):
    entered = []
    real = stats._autograd_profiler.record_function

    class Counting(real):
        def __enter__(self):
            entered.append(self.name)
            return super().__enter__()

    monkeypatch.setattr(stats._autograd_profiler, "record_function",
                        Counting)
    fl = make_flame(async_topology=True, frame_batch=4)
    drive(fl, 8)
    assert len(fl.stats.spans) > 8 and not entered
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU]):
        with fl.stats.timed("probe"):
            pass
    assert entered == ["flame.probe"]


def test_latency_from_update_spans(async_run):
    spans = async_run.stats.spans.spans()
    entry = {}
    for s in sorted(spans, key=lambda s: s.start_ns):
        if s.name == "update":
            entry.setdefault(s.frames[0], s.start_ns)
    flights = [s for s in spans if s.name == "snapshot_flight"]
    assert len(flights) >= 3
    expect = sorted(1e-6 * (s.end_ns - entry[f])
                    for s in flights for f in s.frames)
    samples = sorted(async_run._latency_ms())
    assert len(samples) == sum(len(s.frames) for s in flights)
    np.testing.assert_allclose(samples, expect, rtol=0, atol=1e-9)
    assert all(v >= 0 for v in samples)
    p50, p95 = async_run.latency_percentiles()
    assert p50 == pytest.approx(float(np.percentile(samples, 50)))
    assert p95 == pytest.approx(float(np.percentile(samples, 95)))


def test_threads_share_a_tracker():
    """More threads than cores open nested spans on one tracker with the
    interpreter switching threads every microsecond: no span is lost,
    seqs stay unique, and each thread's spans nest on their own stack."""
    import sys
    import threading
    n_threads, n_spans = 4 * (os.cpu_count() or 1), 200
    tr = stats.StatsTracker()
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def work(k):
            for i in range(n_spans):
                with tr.span("outer", frames=(k,)):
                    with tr.timed("inner"):
                        pass
        threads = [threading.Thread(target=work, args=(k,))
                   for k in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    spans = tr.spans.spans()
    assert len(spans) == 2 * n_threads * n_spans
    seq = _by_seq(spans)
    assert len(seq) == len(spans)
    for s in spans:
        if s.name == "inner":
            p = seq[s.parent]
            assert p.name == "outer" and p.thread == s.thread
            assert p.frames == s.frames
        else:
            assert s.parent == -1
    assert len({s.frames for s in spans}) == n_threads


def test_own_time_restarts_after_a_nested_span_of_its_name():
    """A buffered frame's update run inside the next frame's: the outer
    span's elapsed_ms() and timings() value cover only its own frame,
    from the nested span's end, while the span itself keeps its start."""
    tr = stats.StatsTracker()
    with tr.span("update", frames=(1,), timing="update") as outer:
        with tr.span("update", frames=(0,), timing="update"):
            time.sleep(0.05)
        assert tr.timings("update") >= 50.0
        assert tr.elapsed_ms("update") < 50.0
    assert tr.timings("update") < 50.0
    spans = tr.spans.spans()
    assert spans[-1].seq == outer.seq and spans[-1].ms >= 50.0


def test_fps_max_times_the_frame_not_the_flushed_ones(monkeypatch):
    """When batching disengages, update() runs the buffered frames first;
    fps_max and timings('update') take the current frame's time alone
    (a 3-s stall before the flush counts for no frame)."""
    fl = make_flame(async_topology=True, frame_batch=4)
    drive(fl, 10)  # two full batches, two frames buffered
    assert len(fl._batch_pending) == 2
    real_flush, real_done, real_ema = fl._flush_batch, fl._done, fl.stats.ema
    at_done, samples = [], []

    def stalled_flush():
        if fl._batch_pending:
            time.sleep(3.0)
        real_flush()

    def done(result, frames=1):
        at_done.append(fl.stats.elapsed_ms("update"))
        return real_done(result, frames)

    def ema(name, value, alpha=0.01):
        if name == "fps_max":
            samples.append(value)
        return real_ema(name, value, alpha)

    monkeypatch.setattr(fl, "_flush_batch", stalled_flush)
    monkeypatch.setattr(fl, "_batch_ok", lambda img: False)
    monkeypatch.setattr(fl, "_done", done)
    monkeypatch.setattr(fl.stats, "ema", ema)
    drive(fl, 1, start=10)
    outer = [s for s in fl.stats.spans.spans() if s.name == "update"
             and s.frames == (10,)]
    assert len(outer) == 1 and outer[0].ms >= 3000.0
    assert len(at_done) == 3  # frames 8 and 9, flushed, then frame 10
    assert all(ms < 3000.0 for ms in at_done)
    assert fl.stats.timings("update") < 3000.0
    assert all(v > 1000.0 / 3000.0 for v in samples)


def test_ba_spans_carry_their_update(ba_run):
    """ba_stage holds ba_solve; ba_stage and ba_apply run in the "ba"
    block of an update() and carry its frame id; the new counters count
    the graph captures (one per window size, on the card alone) and the
    rejections (one per apply), and failure_stats() lists BA's
    counters."""
    spans = ba_run.stats.spans.spans()
    seq = _by_seq(spans)
    named = {k: [s for s in spans if s.name == k]
             for k in ("ba_stage", "ba_solve", "ba_apply")}
    assert all(named.values()), {k: len(v) for k, v in named.items()}
    for s in named["ba_solve"]:
        assert seq[s.parent].name == "ba_stage"
        assert s.frames == seq[s.parent].frames
    for s in named["ba_stage"] + named["ba_apply"]:
        ba = seq[s.parent]
        assert ba.name == "ba"
        upd = seq[ba.parent]
        assert upd.name == "update" and upd.parent < 0
        assert s.frames == upd.frames and len(s.frames) == 1
    st = ba_run.stats
    # The graph runner's counter (one capture per window size on the
    # card; no runner, so none, off it).
    graphs = step_graph.counts(ba_run._stack)
    assert st.stats("ba_graph_captures") == graphs.get(
        "ba_graph_captures", 0)
    assert bool(graphs) == (ba_run.device.type == "cuda")
    assert st.stats("ba_single_solves") == len(named["ba_solve"])
    assert st.stats("ba_solves_rejected") == len(named["ba_apply"])
    assert st.stats("ba_solves_applied") == 0
    fs = ba_run.failure_stats()
    assert fs["ba_solves_rejected"] == len(named["ba_apply"])
    assert fs["ba_graph_captures"] == st.stats("ba_graph_captures")
