"""The host triangulation (core/flame.py _host_triangulate: dedup, the
ctypes Delaunay, edges and slot ranks), on the main thread or the async
worker: the mean host milliseconds of the window's delaunay spans. The
window is the ctx.frames highest frame ids among the update spans
recorded without the profiler (harness/spans.py); a worker's span
carries its snapshot's frame ids. None when the window is not whole or
holds no such span."""

from harness import spans


def read(ctx):
    w = spans.window(ctx)
    if w is None:
        return None
    ms = [s.ms for s in w.named("delaunay")]
    return sum(ms) / len(ms) if ms else None
