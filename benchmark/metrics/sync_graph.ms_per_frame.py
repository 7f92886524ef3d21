"""Graph sync and smoothing (core/pipeline.py post-Delaunay: topology,
graph sync, the smoother, the mesh outputs and raster): the window's
sync_graph CUDA-event milliseconds over its frames."""


def read(ctx):
    ms = ctx.stages.get("sync_graph")
    if not ms:
        return None
    return sum(ms) / ctx.frames
