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
  slice_ms_per_frame  the traced slice's wall ms a frame
"""

import argparse
import json
import os
import sys
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


def report(cell_name: str, seed: int, seconds: float) -> dict:
    bench = os.path.join(REPO, "benchmark")
    for p in (REPO, bench):
        if p not in sys.path:
            sys.path.insert(0, p)
    from harness import cell, spans
    from flame_tpu_torch.utils import stats
    t_start = time.perf_counter()
    r = cell.run(cell_name, seed, seconds, True, t_start, device="cuda")
    x = r["_extra"]
    n = x["frames"]
    ctx = cell.Context(frames=n, reads=x["reads"], stages={}, trace=None,
                       rooflines={})
    w = spans.window(ctx)
    traced = [s for s in stats.latest().spans() if s.profiled]
    slice_ = spans.Window(traced, set(spans.entries(traced)))
    upd = w.named("update")
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
