"""Batched raster (pipeline.batch_step: the B views projected and drawn
by K2b): the window's raster_batch CUDA-event milliseconds over its
batched steps."""


def read(ctx):
    ms = ctx.stages.get("raster_batch")
    if not ms:
        return None
    return sum(ms) / len(ms)
