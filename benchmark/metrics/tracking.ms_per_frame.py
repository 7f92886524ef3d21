"""Tracking (core/pipeline.py, update_idepths): the StatsTracker CUDA-event
milliseconds of the window's update_idepths blocks over its frames."""


def read(ctx):
    ms = ctx.stages.get("update_idepths")
    if not ms:
        return None
    return sum(ms) / ctx.frames
