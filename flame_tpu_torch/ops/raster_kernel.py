"""The tile rasterizer with its CUDA kernels, for one view and for B views.

Counterpart of flame_tpu/ops/pallas_raster.py::rasterize and
::rasterize_batch. Triangle setup is plain torch (rasterize._packed_rows).

  * One view: csrc/raster.cu's raster_mesh bins the triangles to 32x128
    tiles and max-combines each tile's candidates in one launch, one CTA
    per tile (plain version: rasterize.bin_rows + eval_tiles).
  * B views: csrc/raster.cu's raster_mesh_batch does the same for all
    views in one launch, one CTA per tile and view, the views of a tile
    in a thread-block cluster that bins once over the union bboxes
    (plain version: rasterize.tile_candidates_batch + eval_tiles_batch).

For tensors on the CPU the plain versions run. For CUDA tensors the
kernel runs or the call raises; there is no fallback.
"""

import torch

from flame_tpu_torch import _kernels, step_graph
from flame_tpu_torch.ops import rasterize as plain

KERNEL = "raster_mesh"
KERNEL_BATCH = "raster_mesh_batch"
MAX_PER_TILE = 160
MAX_PER_TILE_BATCH = 192  # union bboxes grow with the motion in a batch
# raster_mesh keeps K1 candidates of 68 bytes each in shared memory (at
# most 227 KB per CTA on Hopper).
MAX_K1 = 3072


def _check_tile_h(name: str, tile_h: int):
    if not 1 <= tile_h <= 32:
        raise ValueError(f"{name}: tile_h must be in [1, 32]")


def mesh_inputs(verts, tris, vals, tri_valid, truncate: bool = True):
    """raster_mesh's inputs: the (T, 16) triangle rows and the (T, 4)
    [xmin, xmax, ymin, ymax] bboxes of rasterize._packed_rows; with
    leading view dimensions (verts (B, V, 2)) raster_mesh_batch's."""
    packed, _, bbox = plain._packed_rows(verts, tris, vals, tri_valid,
                                         truncate)
    return packed, torch.stack(bbox, dim=-1)


def _check_rows(name, packed, bbox, shape):
    for arg, t, cols in (("packed", packed, 16), ("bbox", bbox, 4)):
        want = shape + (cols,)
        if t.device.type != "cuda" or t.device != packed.device \
                or t.dtype != torch.float32 or tuple(t.shape) != want \
                or not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(
                f"{name}: {arg} must be a contiguous, 16-byte aligned "
                f"float32 {want} tensor on a CUDA device, got "
                f"{t.dtype} {tuple(t.shape)} on {t.device}")


def _k1(name, max_per_tile, T):
    k1 = min(max_per_tile, T)
    if k1 > MAX_K1:
        raise ValueError(f"{name}: max_per_tile {k1} exceeds the "
                         f"{MAX_K1} candidates a CTA holds")
    return k1


def raster_mesh(packed: torch.Tensor, bbox: torch.Tensor, height: int,
                width: int, tile_h: int = 32,
                max_per_tile: int = MAX_PER_TILE):
    """One launch: binning of the T triangles to (tile_h, 128) tiles, the
    K1 = min(max_per_tile, T) highest overlapping indices per tile, and
    their max-combine. Returns the (nty*tile_h, ntx*128) grid, NEG where
    uncovered, and the largest per-tile overlap count (a (1,) int32
    tensor); same contract as rasterize.bin_rows + eval_tiles."""
    _check_tile_h(KERNEL, tile_h)
    dev = packed.device
    T = packed.shape[0]
    _check_rows(KERNEL, packed, bbox, (T,))
    k1 = _k1(KERNEL, max_per_tile, T)
    nty = -(-height // tile_h)
    ntx = -(-width // plain.TILE_W)
    out = torch.empty((nty * tile_h, ntx * plain.TILE_W),
                      dtype=torch.float32, device=dev)
    count = torch.empty(1, dtype=torch.int32, device=dev)
    err = _kernels.load().raster_mesh(
        packed.data_ptr(), bbox.data_ptr(), T, out.data_ptr(),
        count.data_ptr(), nty, ntx, k1, tile_h,
        torch.cuda.current_stream(dev).cuda_stream)
    _kernels.check_cuda_error(err, KERNEL)
    _kernels.LAUNCHES[KERNEL] += 1
    return out, count


def rasterize_with_count(verts, tris, vals, tri_valid, height: int,
                         width: int, truncate: bool = True, tile_h: int = 32,
                         max_per_tile: int = MAX_PER_TILE):
    """(H, W) float32 map, NaN where uncovered, and the largest per-tile
    overlap count (a device integer scalar)."""
    if verts.device.type == "cpu":
        cand = plain.tile_candidates(verts, tris, vals, tri_valid, height,
                                     width, truncate, tile_h, max_per_tile)
        return (plain.finish(plain.eval_tiles(cand.cdata, tile_h), height,
                             width), cand.max_count)
    out, count = raster_mesh(*mesh_inputs(verts, tris, vals, tri_valid,
                                          truncate),
                             height, width, tile_h, max_per_tile)
    return plain.finish(out, height, width), count[0]


def rasterize(verts, tris, vals, tri_valid, height: int, width: int,
              truncate: bool = True, tile_h: int = 32,
              max_per_tile: int = MAX_PER_TILE) -> torch.Tensor:
    """(H, W) float32 map, NaN where uncovered. While a step_graph.Steps
    is current (the post-Delaunay section on a CUDA device) the call
    replays one CUDA graph: the triangle rows, K2's launch, the crop."""
    shape = (height, width, truncate, tile_h, max_per_tile)

    def body(ins, scalars):
        return rasterize_with_count(*ins, *shape)[0]
    ins = [verts, tris, vals, tri_valid]
    steps = step_graph.current()
    if steps is None:
        return body(ins, ())
    return steps.run("raster", body, ins, (), None, (), static=shape)


def raster_mesh_batch(packed: torch.Tensor, bbox: torch.Tensor, height: int,
                      width: int, tile_h: int = 32,
                      max_per_tile: int = MAX_PER_TILE_BATCH):
    """One launch for B views of one triangle set: per tile one binning
    of the union bboxes (rasterize.union_boxes, formed in the kernel's
    scan), the K1 = min(max_per_tile, T) highest overlapping indices, and
    each view's max-combine of its rows of them. packed (B, T, 16), bbox
    (B, T, 4) from mesh_inputs. Returns the (B, nty*tile_h, ntx*128)
    grids, NEG where uncovered, and the largest per-tile union count (a
    (1,) int32 tensor); same contract as rasterize.tile_candidates_batch
    + eval_tiles_batch."""
    _check_tile_h(KERNEL_BATCH, tile_h)
    dev = packed.device
    if packed.dim() != 3:
        raise ValueError(f"{KERNEL_BATCH}: packed must be (B, T, 16), got "
                         f"{tuple(packed.shape)}")
    B, T = packed.shape[:2]
    _check_rows(KERNEL_BATCH, packed, bbox, (B, T))
    k1 = _k1(KERNEL_BATCH, max_per_tile, T)
    nty = -(-height // tile_h)
    ntx = -(-width // plain.TILE_W)
    out = torch.empty((B, nty * tile_h, ntx * plain.TILE_W),
                      dtype=torch.float32, device=dev)
    count = torch.empty(1, dtype=torch.int32, device=dev)
    err = _kernels.load().raster_mesh_batch(
        packed.data_ptr(), bbox.data_ptr(), B, T,
        out.data_ptr(), count.data_ptr(), nty, ntx, k1, tile_h,
        torch.cuda.current_stream(dev).cuda_stream)
    _kernels.check_cuda_error(err, KERNEL_BATCH)
    _kernels.LAUNCHES[KERNEL_BATCH] += 1
    return out, count


def rasterize_batch_with_count(verts, tris, vals, tri_valid, height: int,
                               width: int, truncate: bool = True,
                               tile_h: int = 32,
                               max_per_tile: int = MAX_PER_TILE_BATCH):
    """One triangle set from B views: verts (B, V, 2), vals (B, V),
    tri_valid (B, T) -> (B, H, W) float32, NaN where uncovered, and the
    largest per-tile union count (a device integer scalar)."""
    if verts.device.type == "cpu":
        cand = plain.tile_candidates_batch(verts, tris, vals, tri_valid,
                                           height, width, truncate, tile_h,
                                           max_per_tile)
        return (plain.finish(plain.eval_tiles_batch(cand.cdata, tile_h),
                             height, width), cand.max_count)
    out, count = raster_mesh_batch(*mesh_inputs(verts, tris, vals, tri_valid,
                                                truncate),
                                   height, width, tile_h, max_per_tile)
    return plain.finish(out, height, width), count[0]


def rasterize_batch(verts, tris, vals, tri_valid, height: int, width: int,
                    truncate: bool = True, tile_h: int = 32,
                    max_per_tile: int = MAX_PER_TILE_BATCH) -> torch.Tensor:
    """(B, H, W) float32 maps, NaN where uncovered."""
    return rasterize_batch_with_count(verts, tris, vals, tri_valid, height,
                                      width, truncate, tile_h,
                                      max_per_tile)[0]
