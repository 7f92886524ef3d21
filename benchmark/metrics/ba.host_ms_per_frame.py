"""Bundle adjustment's host work (ba/window.py): the host milliseconds of
the window's ba_stage spans (the window's build, the pack, the upload
and the solve's launch) and ba_apply spans (the acceptance check and
the write-back) over its frames. The window is the ctx.frames highest
frame ids among the update spans recorded without the profiler
(harness/spans.py); BA's spans carry the frame of the update() that ran
them. None when the window is not whole or holds no ba_stage span."""

from harness import spans


def read(ctx):
    w = spans.window(ctx)
    if w is None:
        return None
    stage = w.named("ba_stage")
    if not stage:
        return None
    inside = {s.seq for s in stage}
    apply = [s for s in w.named("ba_apply") if s.parent not in inside]
    return sum(s.ms for s in stage + apply) / ctx.frames
