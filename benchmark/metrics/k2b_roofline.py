"""K2b, the batched raster kernel (csrc/raster.cu raster_mesh_batch): its
share of the roofline, in percent: the mean over the traced slice's
calls of the least time the card could take (the larger of the call's
bytes over 3.35 TB/s and its operations over 67 TFLOP/s fp32;
roofline/k2b.py counts them from the call's inputs) over the mean device
time of its launches in the profiler's trace."""


def read(ctx):
    r = ctx.rooflines.get("k2b")
    if r is None or r["time_s"] <= 0:
        return None
    return 100.0 * r["bound_s"] / r["time_s"]
