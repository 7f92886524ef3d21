"""The map read (core/flame.py get_inverse_depth_map, the read that ends
every frame's latency): the host milliseconds of the window's map_read
spans over its reads (the drain's read included, as fps includes it).
The window is the ctx.frames highest frame ids among the update spans
recorded without the profiler (harness/spans.py); a read carries the
newest frame handed to update(). None when the window is not whole or
holds no read."""

from harness import spans


def read(ctx):
    w = spans.window(ctx)
    if w is None:
        return None
    ms = [s.ms for s in w.named("map_read")]
    return sum(ms) / ctx.reads if ms else None
