"""The closed loop's map latency where it is not an end-to-end metric:
the 95th percentile over every frame of the window of the host time from
its update() call to the return of the map read that first includes it,
as harness/cell.py takes map_latency_ms_p95. None when the run kept no
end-to-end readings."""


def read(ctx):
    e2e = getattr(ctx, "e2e", None) or {}
    return e2e.get("map_latency_ms_p95")
