"""The device's idle share over the traced slice: 1 - the union of its
kernel, copy and memset intervals (torch.profiler) over the slice's
wall time."""


def read(ctx):
    w = ctx.trace["window_s"]
    if w <= 0:
        return None
    return 1.0 - ctx.trace["busy_s"] / w
