"""What the port's spans cost and whether they cover the frame.

    python3 tools/torch_span_report.py --cost
    python3 tools/torch_span_report.py --cell tum_vga.sync --seed 3000000011 \\
        --seconds 45

--cost times 100,000 enter/exit pairs of StatsTracker.span() and of
timed() (no CUDA events), at the root and under an open parent, on this
host's CPU, and prints nanoseconds a pair.

--cell runs one benchmark cell with --trace 1 in this process, as
benchmark/run.py does (a CUDA card is needed), and prints one JSON line:
the result line's metrics, and from the spans of the tracker's ring,
in the window the per-layer metrics read (benchmark/harness/spans.py)
and in the traced slice
  closure          per frame, the host time of the update and map_read
                   root spans over the wall time, for the window and
                   for the traced slice (1 when the spans cover the
                   whole loop; the harness's own code makes the rest)
  update_ms        the window's update spans' host ms, p50 / p95, for
                   poseframes and for the other frames
  triangulate      the window's triangulate spans (synchronous path)
                   split into snapshot_wait, delaunay, topo_upload and
                   the rest, ms a frame
  delaunay         the window's delaunay spans, ms a call, split into the
                   core (the ctypes call into csrc/delaunay.cpp), the
                   wrapper around it (mesh/delaunay.py: the buffers, the
                   edge sort and the copies) and the numpy after it
                   (dedup, edge codes, slot ranks); the members a call;
                   and delaunay_walk_steps, the tracker's mean triangles a
                   point's walk visited in the latest call (None where the
                   program has no such counter)
  slice_ms_per_frame  the traced slice's wall ms a frame
  graphs           the tracker's CUDA-graph counters
                   ({kind}_graph_{captures,replays,eager} for every kind
                   of flame_tpu_torch/step_graph.py, BA's included), the
                   update() calls of the run (warm-up, window and
                   slice), the post-Delaunay calls in the window and the
                   graphs captured inside it
  ba               with do_ba (ba/window.py): the window's ba_stage,
                   ba_solve (host) and ba_apply spans in ms a frame, the
                   solves staged in the window, the run's counters
                   (solves staged, applied, rejected, graph captures),
                   the graph captures made inside the window, and the
                   ATE (m, no alignment) of the live poseframes' poses at
                   the run's end against the scene's true poses, beside
                   that of the same frames' input poses
"""

import argparse
import contextlib
import json
import os
import sys
import threading
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def cost(n: int = 100_000) -> dict:
    sys.path.insert(0, REPO)
    from flame_tpu_torch.utils import stats
    tr = stats.StatsTracker()

    def pairs(make, parent):
        t0 = time.perf_counter_ns()
        if parent:
            with tr.span("parent", frames=(1,)):
                for _ in range(n):
                    with make("x"):
                        pass
        else:
            for _ in range(n):
                with make("x"):
                    pass
        return (time.perf_counter_ns() - t0) / n

    out = {}
    for kind, make in (("span", tr.span), ("timed", tr.timed)):
        for parent in (False, True):
            pairs(make, parent)
            out[f"{kind}_{'child' if parent else 'root'}_ns"] = min(
                pairs(make, parent) for _ in range(5))
    return out


def _p(v):
    return [float(np.percentile(v, 50)), float(np.percentile(v, 95))] \
        if v else None


def _closure(w, wall_s):
    """Per frame, the host time of the update and map_read root spans on
    the main thread over the wall time."""
    main = {s.thread for s in w.named("update")}
    return sum(s.ms for name in ("update", "map_read")
               for s in w.roots(name) if s.thread in main) / (1e3 * wall_s)


def _ba(w, captures_ns, fl, cell_name, seed) -> dict:
    """BA's split of the window, its counters, and the live poseframes'
    ATE against the true and the input poses (see the module)."""
    from harness import registry
    from scenes import box_room
    from flame_tpu_torch.ba import window
    from flame_tpu_torch.utils import stats
    n = len(w.ids)
    ms = {k: sum(s.ms for s in w.named(k)) / n
          for k in ("ba_stage", "ba_solve", "ba_apply")}
    solved = {s.parent for s in w.named("ba_solve")}
    first = min(s.start_ns for s in w.named("update"))
    last = max(s.end_ns for s in w.named("update"))
    tracker = stats.latest_tracker()
    out = dict(ms_per_frame=ms, staged_in_window=sum(
        s.seq in solved for s in w.named("ba_stage")),
        counters={k: int(tracker.stats(k)) for k in window.COUNTERS},
        graph_captures_in_window=sum(first <= t <= last
                                     for t in captures_ns))
    sp = registry.spec()
    entry = registry.cell(sp, cell_name)
    cfg = registry.config(entry["config"])
    noise = registry.traffic(entry["traffic"]).get("pose_noise", {})
    start = box_room.start_frame(cfg, seed)
    fids = sorted(fl._pf_slot_by_id)
    slots = [fl._pf_slot_by_id[f] for f in fids]
    est = fl._stack.t[slots].double().cpu().numpy()
    true = np.array([box_room.true_pose(cfg, start + f)[1] for f in fids])
    given = box_room.noisy_poses(cfg, fids[-1] + 1, float(noise.get(
        "t_m", 0.0)), float(noise.get("deg", 0.0)), seed, start)
    inp = np.array([given[f][1] for f in fids])

    def ate(t):
        return float(np.sqrt(np.mean(np.sum((t - true) ** 2, axis=1))))
    out["ate_m"] = dict(ba=ate(est), input=ate(inp), poseframes=len(fids))
    return out


@contextlib.contextmanager
def timed_delaunay(calls: list):
    """While open, each mesh.delaunay.triangulate call appends (thread,
    start ns, end ns, ns inside the ctypes core, points) to calls."""
    sys.path.insert(0, REPO)
    from flame_tpu_torch.mesh import delaunay
    lib, tri = delaunay._load(), delaunay.triangulate
    cores = {name: getattr(lib, name) for name in (
        "delaunay_triangulate_ex", "delaunay_triangulate")
        if hasattr(lib, name)}
    core_ns = {}

    def timed_core(fn):
        def call(*a):
            t0 = time.perf_counter_ns()
            try:
                return fn(*a)
            finally:
                core_ns[threading.get_ident()] = time.perf_counter_ns() - t0
        return call

    def timed_triangulate(points):
        t0 = time.perf_counter_ns()
        try:
            return tri(points)
        finally:
            tid = threading.get_ident()
            calls.append((tid, t0, time.perf_counter_ns(),
                          core_ns.pop(tid, 0), len(points)))
    delaunay.triangulate = timed_triangulate
    for name, fn in cores.items():
        setattr(lib, name, timed_core(fn))
    try:
        yield calls
    finally:
        delaunay.triangulate = tri
        for name, fn in cores.items():
            setattr(lib, name, fn)


def _delaunay_split(spans_, calls, tracker) -> dict:
    """The delaunay spans' ms a call, split by the triangulate calls made
    inside them (same thread, inside the span's interval)."""
    core = wrap = members = 0.0
    for s in spans_:
        for tid, t0, t1, c, n in calls:
            if tid == s.thread and s.start_ns <= t0 and t1 <= s.end_ns:
                core += c * 1e-6
                wrap += (t1 - t0 - c) * 1e-6
                members += n
    n = len(spans_)
    total = sum(s.ms for s in spans_)
    walk = tracker.stats("delaunay_walk_steps") \
        if "delaunay_walk_steps" in tracker.snapshot()["stats"] else None
    return dict(calls=n, ms_per_call=total / n, core=core / n,
                wrapper=wrap / n, numpy=(total - core - wrap) / n,
                members_per_call=members / n,
                delaunay_walk_steps=walk) if n else None


def report(cell_name: str, seed: int, seconds: float) -> dict:
    bench = os.path.join(REPO, "benchmark")
    for p in (REPO, bench):
        if p not in sys.path:
            sys.path.insert(0, p)
    from harness import cell, spans
    from flame_tpu_torch import step_graph
    from flame_tpu_torch.core import flame
    from flame_tpu_torch.utils import stats
    # The run's last Flame, kept past the harness's del for the ATE, the
    # kind and host clock of each graph capture, and the Delaunay calls.
    held, captures, tri_calls = {}, [], []
    read, count = flame.Flame.get_inverse_depth_map, step_graph.Steps._count

    def read_and_keep(self, *a, **k):
        held["fl"] = self
        return read(self, *a, **k)

    def count_and_clock(self, kind, what):
        if what == "captures":
            captures.append((kind, time.perf_counter_ns()))
        count(self, kind, what)
    flame.Flame.get_inverse_depth_map = read_and_keep
    step_graph.Steps._count = count_and_clock
    try:
        with timed_delaunay(tri_calls):
            t_start = time.perf_counter()
            r = cell.run(cell_name, seed, seconds, True, t_start,
                         device="cuda")
    finally:
        flame.Flame.get_inverse_depth_map = read
        step_graph.Steps._count = count
    x = r["_extra"]
    n = x["frames"]
    ctx = cell.Context(frames=n, reads=x["reads"], stages={}, trace=None,
                       rooflines={})
    w = spans.window(ctx)
    traced = [s for s in stats.latest().spans() if s.profiled]
    slice_ = spans.Window(traced, set(spans.entries(traced)))
    upd = w.named("update")
    first = min(s.start_ns for s in upd)
    last = max(s.end_ns for s in upd)
    tri = w.named("triangulate")
    split = {}
    for t in tri:
        for c in w.spans:
            if c.parent == t.seq:
                split[c.name] = split.get(c.name, 0.0) + c.ms
    tri_ms = sum(t.ms for t in tri)
    return dict(
        cell=cell_name, seed=seed, correct=r["correct"],
        metrics={k: v["value"] for k, v in r["metrics"].items()},
        frames=n, window_s=x["window_s"], fps=n / x["window_s"],
        closure=dict(window=_closure(w, x["window_s"]),
                     slice=_closure(slice_, x["traced"]["window_s"])),
        update_ms=dict(
            poseframe=_p([s.ms for s in upd if s.poseframe]),
            other=_p([s.ms for s in upd if not s.poseframe])),
        triangulate=dict(
            total=tri_ms / n,
            **{k: v / n for k, v in sorted(split.items())},
            rest=(tri_ms - sum(split.values())) / n) if tri else None,
        slice_ms_per_frame=x["traced"]["ms_per_frame"],
        idle_share=x["traced"]["idle_share"],
        idle_gaps=r["breakdown"]["idle_gaps"],
        graphs=dict(
            {f"{k}_graph_{c}": int(stats.latest_tracker().stats(
                f"{k}_graph_{c}")) for k in step_graph.KINDS
             for c in step_graph.COUNTERS},
            updates=sum(1 for s in stats.latest().spans()
                        if s.name == "update"),
            sync_graph_in_window=len(w.named("sync_graph")),
            captures_in_window=sum(first <= t <= last
                                   for _, t in captures)),
        delaunay=_delaunay_split(w.named("delaunay"), tri_calls,
                                 stats.latest_tracker()),
        ba=(_ba(w, [t for k, t in captures if k.startswith("ba")],
                held["fl"], cell_name, seed)
            if held["fl"]._ba is not None else None),
        spans_in_ring=len(stats.latest()))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--cost", action="store_true")
    ap.add_argument("--cell")
    ap.add_argument("--seed", type=int, default=3000000011)
    ap.add_argument("--seconds", type=float, default=45.0)
    args = ap.parse_args(argv)
    if args.cost:
        print(json.dumps(cost()), flush=True)
    if args.cell:
        print(json.dumps(report(args.cell, args.seed, args.seconds)),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
