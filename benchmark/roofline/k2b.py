"""K2b, the B-view tile rasterizer (flame_tpu_torch/csrc/raster.cu
raster_mesh_batch, called through
ops/raster_kernel.rasterize_batch_with_count): bytes and operations of
one call from its inputs and its B maps (_raster.py)."""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import _raster  # noqa: E402

HOOK = ("flame_tpu_torch.ops.raster_kernel", "rasterize_batch_with_count")
KERNEL = "raster_mesh_batch_kernel"


def record(args, kwargs, out):
    verts, tris, vals, tri_valid = args[:4]
    return dict(verts=verts, tris=tris, tri_valid=tri_valid, maps=out[0])


def cost(rec):
    return _raster.counts(rec["verts"], rec["tris"], rec["tri_valid"],
                          rec["maps"])
