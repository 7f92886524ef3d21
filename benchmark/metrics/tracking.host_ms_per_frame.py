"""Tracking's host time (core/pipeline.py, update_idepths): the host
milliseconds of the window's update_idepths spans over its frames,
beside tracking.ms_per_frame's CUDA events. The window is the ctx.frames
highest frame ids among the update spans recorded without the profiler
(harness/spans.py); None when it is not whole or holds no such span."""

from harness import spans


def read(ctx):
    w = spans.window(ctx)
    if w is None:
        return None
    ms = [s.ms for s in w.named("update_idepths")]
    return sum(ms) / ctx.frames if ms else None
