"""Bundle adjustment's cadence (ba/window.py): the window's staged solves
(its ba_stage spans that hold a ba_solve block; a ba_stage span without
one built a window too small to solve) over its poseframes (the update
spans flagged as poseframes). Read beside fps: a change that starves BA
of solves raises fps and lowers this. The window is the ctx.frames
highest frame ids among the update spans recorded without the profiler
(harness/spans.py). None when the window is not whole or holds no
ba_stage span or no poseframe."""

from harness import spans


def read(ctx):
    w = spans.window(ctx)
    if w is None:
        return None
    stage = w.named("ba_stage")
    pfs = {s.frames[0] for s in w.named("update") if s.poseframe} & w.ids
    if not stage or not pfs:
        return None
    solved = {s.parent for s in w.named("ba_solve")}
    return sum(s.seq in solved for s in stage) / len(pfs)
