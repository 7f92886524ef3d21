"""K2, the single-view tile rasterizer (flame_tpu_torch/csrc/raster.cu
raster_mesh, called through ops/raster_kernel.rasterize): bytes and
operations of one call from its inputs and its map (_raster.py)."""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import _raster  # noqa: E402

HOOK = ("flame_tpu_torch.ops.raster_kernel", "rasterize")
KERNEL = "raster_mesh_kernel"


def record(args, kwargs, out):
    verts, tris, vals, tri_valid = args[:4]
    return dict(verts=verts, tris=tris, tri_valid=tri_valid, maps=out)


def cost(rec):
    return _raster.counts(rec["verts"][None], rec["tris"],
                          rec["tri_valid"][None], rec["maps"][None])
