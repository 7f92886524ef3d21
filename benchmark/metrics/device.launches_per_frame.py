"""Device kernels launched per frame: the kernels in the traced slice's
profiler trace over the slice's frames."""


def read(ctx):
    n = ctx.trace.get("frames", 0)
    if n <= 0 or ctx.trace["n_kernels"] <= 0:
        return None
    return ctx.trace["n_kernels"] / n
