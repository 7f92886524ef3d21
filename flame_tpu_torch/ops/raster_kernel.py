"""The tile rasterizer with its CUDA kernel.

Counterpart of flame_tpu/ops/pallas_raster.py::rasterize. Setup and
binning are plain torch (rasterize.tile_candidates); the per-tile
max-combine is csrc/raster.cu, one CTA per 32x128 tile.

For tensors on the CPU the tiles run the plain version
(rasterize.eval_tiles). For CUDA tensors the kernel runs or the call
raises; there is no fallback.
"""

import torch

from flame_tpu_torch import _kernels
from flame_tpu_torch.ops import rasterize as plain

KERNEL = "raster_tiles"
MAX_PER_TILE = 160


def rasterize_tiles(cdata: torch.Tensor, tile_h: int = 32) -> torch.Tensor:
    """(nty, ntx, K1, 16) candidates -> (nty*tile_h, ntx*128), NEG where
    uncovered; same contract as rasterize.eval_tiles."""
    dev = cdata.device
    if dev.type == "cpu":
        return plain.eval_tiles(cdata, tile_h)
    if dev.type != "cuda":
        raise ValueError(f"{KERNEL}: unsupported device {dev}")
    if cdata.dtype != torch.float32 or cdata.dim() != 4 \
            or cdata.shape[3] != 16 or not cdata.is_contiguous():
        raise ValueError(f"{KERNEL}: cdata must be a contiguous float32 "
                         f"(nty, ntx, K1, 16) tensor, got {cdata.dtype} "
                         f"{tuple(cdata.shape)}")
    if not 1 <= tile_h <= 32:
        raise ValueError(f"{KERNEL}: tile_h must be in [1, 32]")
    nty, ntx, k1, _ = cdata.shape
    out = torch.empty((nty * tile_h, ntx * plain.TILE_W),
                      dtype=torch.float32, device=dev)
    lib = _kernels.load()
    err = lib.raster_tiles(cdata.data_ptr(), out.data_ptr(), nty, ntx, k1,
                           tile_h, torch.cuda.current_stream(dev).cuda_stream)
    _kernels.check_cuda_error(err, KERNEL)
    _kernels.LAUNCHES[KERNEL] += 1
    return out


def rasterize(verts, tris, vals, tri_valid, height: int, width: int,
              truncate: bool = True, tile_h: int = 32,
              max_per_tile: int = MAX_PER_TILE) -> torch.Tensor:
    """(H, W) float32 map, NaN where uncovered."""
    cand = plain.tile_candidates(verts, tris, vals, tri_valid, height,
                                 width, truncate, tile_h, max_per_tile)
    return plain.finish(rasterize_tiles(cand.cdata.contiguous(), tile_h),
                        height, width)
