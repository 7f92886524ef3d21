"""The tile rasterizer with its CUDA kernel, for one view and for B views.

Counterpart of flame_tpu/ops/pallas_raster.py::rasterize and
::rasterize_batch. Setup and binning are plain torch
(rasterize.tile_candidates, tile_candidates_batch); the per-tile
max-combine is csrc/raster.cu, one CTA per 32x128 tile and view.

For tensors on the CPU the tiles run the plain version
(rasterize.eval_tiles, eval_tiles_batch). For CUDA tensors the kernel
runs or the call raises; there is no fallback.
"""

import torch

from flame_tpu_torch import _kernels
from flame_tpu_torch.ops import rasterize as plain

KERNEL = "raster_tiles"
KERNEL_BATCH = "raster_tiles_batch"
MAX_PER_TILE = 160
MAX_PER_TILE_BATCH = 192  # union bboxes grow with the motion in a batch


def _check(name: str, cdata: torch.Tensor, dims: int, tile_h: int):
    if cdata.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {cdata.device}")
    if cdata.dtype != torch.float32 or cdata.dim() != dims \
            or cdata.shape[-1] != 16 or not cdata.is_contiguous():
        raise ValueError(f"{name}: cdata must be a contiguous float32 "
                         f"{dims}-d (..., nty, ntx, K1, 16) tensor, got "
                         f"{cdata.dtype} {tuple(cdata.shape)}")
    if not 1 <= tile_h <= 32:
        raise ValueError(f"{name}: tile_h must be in [1, 32]")


def rasterize_tiles(cdata: torch.Tensor, tile_h: int = 32) -> torch.Tensor:
    """(nty, ntx, K1, 16) candidates -> (nty*tile_h, ntx*128), NEG where
    uncovered; same contract as rasterize.eval_tiles."""
    if cdata.device.type == "cpu":
        return plain.eval_tiles(cdata, tile_h)
    _check(KERNEL, cdata, 4, tile_h)
    nty, ntx, k1, _ = cdata.shape
    out = torch.empty((nty * tile_h, ntx * plain.TILE_W),
                      dtype=torch.float32, device=cdata.device)
    err = _kernels.load().raster_tiles(
        cdata.data_ptr(), out.data_ptr(), nty, ntx, k1, tile_h,
        torch.cuda.current_stream(cdata.device).cuda_stream)
    _kernels.check_cuda_error(err, KERNEL)
    _kernels.LAUNCHES[KERNEL] += 1
    return out


def rasterize_tiles_batch(cdata: torch.Tensor,
                          tile_h: int = 32) -> torch.Tensor:
    """(B, nty, ntx, K1, 16) candidates -> (B, nty*tile_h, ntx*128), NEG
    where uncovered; same contract as rasterize.eval_tiles_batch."""
    if cdata.device.type == "cpu":
        return plain.eval_tiles_batch(cdata, tile_h)
    _check(KERNEL_BATCH, cdata, 5, tile_h)
    B, nty, ntx, k1, _ = cdata.shape
    out = torch.empty((B, nty * tile_h, ntx * plain.TILE_W),
                      dtype=torch.float32, device=cdata.device)
    err = _kernels.load().raster_tiles_batch(
        cdata.data_ptr(), out.data_ptr(), B, nty, ntx, k1, tile_h,
        torch.cuda.current_stream(cdata.device).cuda_stream)
    _kernels.check_cuda_error(err, KERNEL_BATCH)
    _kernels.LAUNCHES[KERNEL_BATCH] += 1
    return out


def rasterize(verts, tris, vals, tri_valid, height: int, width: int,
              truncate: bool = True, tile_h: int = 32,
              max_per_tile: int = MAX_PER_TILE) -> torch.Tensor:
    """(H, W) float32 map, NaN where uncovered."""
    cand = plain.tile_candidates(verts, tris, vals, tri_valid, height,
                                 width, truncate, tile_h, max_per_tile)
    return plain.finish(rasterize_tiles(cand.cdata.contiguous(), tile_h),
                        height, width)


def rasterize_batch(verts, tris, vals, tri_valid, height: int, width: int,
                    truncate: bool = True, tile_h: int = 32,
                    max_per_tile: int = MAX_PER_TILE_BATCH) -> torch.Tensor:
    """One triangle set from B views: verts (B, V, 2), vals (B, V),
    tri_valid (B, T) -> (B, H, W) float32, NaN where uncovered."""
    cand = plain.tile_candidates_batch(verts, tris, vals, tri_valid, height,
                                       width, truncate, tile_h, max_per_tile)
    return plain.finish(rasterize_tiles_batch(cand.cdata.contiguous(),
                                              tile_h), height, width)
