"""Triangulation (mesh/delaunay.py on the host, after the snapshot copy):
the window's triangulate CUDA-event milliseconds over its frames; a
block of the synchronous path only (async topology runs it on a worker
thread, off the critical path)."""


def read(ctx):
    ms = ctx.stages.get("triangulate")
    if not ms:
        return None
    return sum(ms) / ctx.frames
