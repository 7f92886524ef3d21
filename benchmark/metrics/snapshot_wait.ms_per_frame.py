"""The host blocked on the packed snapshot's device-to-host copy
(core/flame.py: as_numpy_packed inside triangulate on the synchronous
path, the join in _drain_packed_queue under async topology): the host
milliseconds of the window's snapshot_wait spans over its frames. The
window is the ctx.frames highest frame ids among the update spans
recorded without the profiler (harness/spans.py); None when it is not
whole."""

from harness import spans


def read(ctx):
    w = spans.window(ctx)
    if w is None:
        return None
    return sum(s.ms for s in w.named("snapshot_wait")) / ctx.frames
