"""Bundle adjustment's solve (ba/window.py: the ba_solve block around the
replay of the solve's CUDA graph, inputs copied in): the mean
StatsTracker CUDA-event milliseconds of the window's ba_solve blocks,
the solve's device time. None where the window holds no such block (BA
off, or a program without the block)."""


def read(ctx):
    ms = ctx.stages.get("ba_solve")
    if not ms:
        return None
    return sum(ms) / len(ms)
