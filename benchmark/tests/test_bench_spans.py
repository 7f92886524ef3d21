"""The readers of the program's spans on the tiny CPU cells: each gives a
finite number from a Context built as the harness builds it, and None
when the program recorded no spans, when the ring lost the window's
first frame, or when the program keeps no span ring at all."""

import math
import threading

import pytest

import bench_tiny
from flame_tpu_torch.utils import stats
from harness import cell, registry
from harness import spans as harness_spans

READERS = ["update.self_ms_per_frame", "tracking.host_ms_per_frame",
           "snapshot_wait.ms_per_frame", "delaunay.ms_per_call",
           "map_read.ms_per_read"]
# Window seconds: the batched cell's window has to hold a triangulation
# of one of its own snapshots, so at least two steps of 8 frames.
CELLS = {"tum_vga.sync": 2.0, "tum_vga.batched": 10.0}


@pytest.fixture(scope="module")
def paths(tmp_path_factory):
    return bench_tiny.make(str(tmp_path_factory.mktemp("bench")))


@pytest.fixture(scope="module", params=sorted(CELLS))
def run(request, paths):
    """One tiny run of the cell: its Context and the ring it left."""
    r = bench_tiny.run(paths, request.param,
                       seconds=CELLS[request.param])
    x = r["_extra"]
    ctx = cell.Context(frames=x["frames"], reads=x["reads"], stages={},
                       trace=None, rooflines={})
    return ctx, stats.latest()


def _read(name, ctx, paths):
    return registry.metric_reader(name, paths["bench_dir"]).read(ctx)


def _with_ring(ring, monkeypatch):
    monkeypatch.setattr(stats, "latest", lambda: ring)


@pytest.mark.parametrize("name", READERS)
def test_reader_gives_a_finite_number(run, name, paths, monkeypatch):
    ctx, ring = run
    _with_ring(ring, monkeypatch)
    v = _read(name, ctx, paths)
    assert v is not None and math.isfinite(v) and v >= 0


@pytest.mark.parametrize("name", READERS)
def test_reader_gives_none_without_the_window(run, name, paths,
                                              monkeypatch):
    ctx, ring = run
    # A tracker that recorded nothing.
    _with_ring(stats.StatsTracker().spans, monkeypatch)
    assert _read(name, ctx, paths) is None
    # A ring that dropped the window's first frame: the run's spans fed
    # to a ring that holds only those that ended after it.
    spans = ring.spans()
    plain = [s for s in spans if not s.profiled]
    first = sorted(harness_spans.entries(plain))[-ctx.frames]
    end = max(s.end_ns for s in spans if s.name == "update"
              and s.frames == (first,))
    keep = sum(1 for s in spans if s.end_ns > end)
    short = stats.SpanRing(keep)
    for s in spans:
        short._add(tuple(s))
    _with_ring(short, monkeypatch)
    assert _read(name, ctx, paths) is None
    # A program whose stats module has no span ring.
    monkeypatch.delattr(stats, "latest")
    assert _read(name, ctx, paths) is None


def test_window_holds_frames_run_inside_other_spans(paths, monkeypatch):
    """A buffered frame that a map read runs (a partial batch flushed)
    or that the next update() runs (batching disengaged) has its update
    span inside that span: the window still holds it and counts its own
    time once. A worker's span that carries a traced frame's id but
    opened after the profiler stopped does not move the window."""
    tr = stats.StatsTracker()

    def frame(f, work=True):
        with tr.span("update", frames=(f,)):
            if work:
                with tr.timed("update_idepths"):
                    pass

    def read(f, flushed=()):
        with tr.span("map_read", frames=(f,)):
            for g in flushed:
                frame(g)

    frame(0)
    read(0)
    frame(1, work=False)  # buffered
    frame(2, work=False)
    read(2, flushed=(1, 2))  # the map read flushes the partial batch
    frame(3, work=False)
    with tr.span("update", frames=(4,)):  # runs the buffered frame 3
        frame(3)
        with tr.timed("update_idepths"):
            pass
    read(4)
    frame(5)
    read(5)
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU]):
        for f in (6, 7):
            frame(f)
            read(f)

    def triangulate():
        with tr.span("delaunay", frames=(7,)):
            pass

    worker = threading.Thread(target=triangulate)
    worker.start()
    worker.join()
    _with_ring(tr.spans, monkeypatch)

    ctx = cell.Context(frames=6, reads=4, stages={}, trace=None,
                       rooflines={})
    w = harness_spans.window(ctx)
    assert w is not None and w.ids == set(range(6))
    upd = [s for s in tr.spans.spans() if s.name == "update"
           and s.frames[0] < 6]
    assert sum(s.parent >= 0 for s in upd) == 3
    own = sum(s.ms - sum(c.ms for c in tr.spans.spans()
                         if c.parent == s.seq) for s in upd)
    assert _read("update.self_ms_per_frame", ctx, paths) \
        == pytest.approx(own / 6, rel=1e-9)
    host = [s.ms for s in tr.spans.spans() if s.name == "update_idepths"
            and s.frames[0] < 6]
    assert len(host) == 6
    assert _read("tracking.host_ms_per_frame", ctx, paths) \
        == pytest.approx(sum(host) / 6, rel=1e-9)
    reads = [s.ms for s in tr.spans.spans() if s.name == "map_read"
             and not s.profiled]
    assert _read("map_read.ms_per_read", ctx, paths) \
        == pytest.approx(sum(reads) / 4, rel=1e-9)
