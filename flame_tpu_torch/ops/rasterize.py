"""Barycentric mesh rasterization into dense value maps.

Port of flame_tpu/ops/rasterize.py and of the setup and binning around the
TPU tile kernel (ops/pallas_raster.py). For each (pixel, triangle) pair
the three edge functions are evaluated; a pixel is inside when all three
are >= 0, and the interpolated values are max-combined over triangles.
Background is NaN (reference flame.cc:412).

Vertex coordinates are truncated to integers first (the reference
converts to cv::Point, image_utils.cc:383-391). The edge coefficients are
then integers, so the inside test is exact in float32 for images under
2048 px.

  * rasterize_bruteforce: every triangle against every pixel.
  * tile_candidates (_packed_rows + bin_rows) + eval_tiles: the tiled
    form. Triangles are binned to 32x128 tiles by bounding box; each tile
    keeps the max_per_tile highest-index overlapping triangles (overflow
    is dropped, and tile_candidates reports the largest count). bin_rows
    + eval_tiles is the plain version of the single-view CUDA kernel
    (ops/raster_kernel.py).
  * tile_candidates_batch + eval_tiles_batch: one triangle set from B
    views with one shared binning pass over the union of each
    triangle's per-view bboxes (pallas_raster.rasterize_batch). When no
    tile overflows it gives each view the map the per-view form gives.
  * rasterize_auto / rasterize_batch_auto: the CUDA kernels K2 / K2b for
    tensors on the card, these plain versions on the CPU
    (ops/raster_kernel.py); interpolate_mesh draws through
    rasterize_auto.
"""

from typing import NamedTuple

import torch

TILE_W = 128
NEG = -3.0e38  # finite -inf stand-in, as in the TPU kernel
BIG = 3e38  # an empty union bbox's bound


def _tri_setup(verts, tris, truncate: bool, corners=None):
    """Edge-function coefficients a, b, c (..., T, 3), sign-normalized so
    inside => all >= 0, and area2 (..., T) = |2 * signed area|. corners
    (..., T, 3, 2) may carry leading view dimensions."""
    p = corners if corners is not None else verts[tris]
    if truncate:
        p = torch.trunc(p)
    v0, v1, v2 = p[..., 0, :], p[..., 1, :], p[..., 2, :]

    def edge_coeffs(pa, pb):
        a = pa[..., 1] - pb[..., 1]
        b = pb[..., 0] - pa[..., 0]
        c = pb[..., 1] * pa[..., 0] - pb[..., 0] * pa[..., 1]
        return a, b, c

    a0, b0, c0 = edge_coeffs(v1, v2)
    a1, b1, c1 = edge_coeffs(v2, v0)
    a2, b2, c2 = edge_coeffs(v0, v1)
    a = torch.stack([a0, a1, a2], dim=-1)
    b = torch.stack([b0, b1, b2], dim=-1)
    c = torch.stack([c0, c1, c2], dim=-1)
    area2 = (v1[..., 0] - v0[..., 0]) * (v2[..., 1] - v0[..., 1]) - \
        (v1[..., 1] - v0[..., 1]) * (v2[..., 0] - v0[..., 0])
    sign = torch.where(area2 < 0, -1.0, 1.0)[..., None]
    return a * sign, b * sign, c * sign, torch.abs(area2)


def rasterize_bruteforce(verts, tris, vals, tri_valid, height: int,
                         width: int, truncate: bool = True,
                         chunk: int = 128) -> torch.Tensor:
    """Every triangle against every pixel, in chunks of triangles.
    verts (V, 2), tris (T, 3), vals (V,), tri_valid (T,) -> (H, W)."""
    dev = verts.device
    a, b, c, area2 = _tri_setup(verts, tris, truncate)
    tvals = vals[tris]
    ok = tri_valid & (area2 > 0)
    denom = torch.where(area2 > 0, area2, torch.ones_like(area2))
    xs = torch.arange(width, dtype=torch.float32, device=dev)
    ys = torch.arange(height, dtype=torch.float32, device=dev)
    out = torch.full((height, width), float("-inf"), device=dev)
    for s in range(0, tris.shape[0], chunk):
        sl = slice(s, s + chunk)
        w = (a[sl, :, None, None] * xs[None, None, None, :]
             + b[sl, :, None, None] * ys[None, None, :, None]
             + c[sl, :, None, None])  # (C, 3, H, W)
        inside = torch.all(w >= 0, dim=1) & ok[sl, None, None]
        val = (w[:, 0] * tvals[sl, 0, None, None]
               + w[:, 1] * tvals[sl, 1, None, None]
               + w[:, 2] * tvals[sl, 2, None, None]) / denom[sl, None, None]
        cand = torch.where(inside, val, torch.full_like(val, float("-inf")))
        out = torch.maximum(out, torch.amax(cand, dim=0))
    return torch.where(torch.isinf(out), torch.full_like(out, float("nan")),
                       out)


class TileCandidates(NamedTuple):
    cdata: torch.Tensor  # ([B,] nty, ntx, K1, 16) rows [a0..2 b0..2 c0..2
    # v0..2 inv_area valid 0 0], c in image coordinates; dead slots zero
    max_count: torch.Tensor  # () int, largest per-tile overlap count


def _packed_rows(verts, tris, vals, tri_valid, truncate: bool):
    """Per-triangle (..., T, 16) rows, validity (..., T) and bboxes, for
    verts (..., V, 2) and vals (..., V) with optional leading view
    dimensions (pallas_raster._setup_one of the JAX package)."""
    corners = verts[..., tris, :]  # (..., T, 3, 2)
    a, b, c, area2 = _tri_setup(None, None, truncate, corners=corners)
    tvals = vals[..., tris]
    p = torch.trunc(corners) if truncate else corners
    bbox = (torch.amin(p[..., 0], dim=-1), torch.amax(p[..., 0], dim=-1),
            torch.amin(p[..., 1], dim=-1), torch.amax(p[..., 1], dim=-1))
    ok = tri_valid & (area2 > 0)
    inv_area = torch.where(area2 > 0, 1.0 / torch.where(
        area2 > 0, area2, torch.ones_like(area2)), torch.zeros_like(area2))
    packed = torch.cat([a, b, c, tvals, inv_area[..., None],
                        ok[..., None].float(),
                        torch.zeros(ok.shape + (2,), device=verts.device)],
                       dim=-1)
    return packed, ok, bbox


def _bin_tiles(bbox, ok, height: int, width: int, tile_h: int, K1: int):
    """Bbox binning to (tile_h, 128) tiles: (n_tiles, K1) candidate
    indices (-1 for dead slots; the K1 highest overlapping indices) and
    the largest per-tile overlap count."""
    xmin, xmax, ymin, ymax = bbox
    dev = ok.device
    T = ok.shape[0]
    nty = -(-height // tile_h)
    ntx = -(-width // TILE_W)
    tids = torch.arange(nty * ntx, device=dev)
    ty = (tids // ntx).float() * tile_h
    tx = (tids % ntx).float() * TILE_W
    overlap = ((xmin[None, :] <= tx[:, None] + (TILE_W - 1))
               & (xmax[None, :] >= tx[:, None])
               & (ymin[None, :] <= ty[:, None] + (tile_h - 1))
               & (ymax[None, :] >= ty[:, None]) & ok[None, :])
    key = torch.where(overlap, torch.arange(T, device=dev)[None, :], -1)
    kvals = torch.topk(key, K1, dim=1).values  # (n_tiles, K1)
    return kvals, overlap.sum(dim=1).max()


def tile_candidates(verts, tris, vals, tri_valid, height: int, width: int,
                    truncate: bool = True, tile_h: int = 32,
                    max_per_tile: int = 160) -> TileCandidates:
    """Triangle setup and bbox binning to (tile_h, 128) tiles
    (pallas_raster._setup_one and _bin_tiles of the JAX package)."""
    packed, ok, bbox = _packed_rows(verts, tris, vals, tri_valid, truncate)
    return bin_rows(packed, ok, bbox, height, width, tile_h,
                    min(max_per_tile, tris.shape[0]))


def bin_rows(packed, ok, bbox, height: int, width: int, tile_h: int,
             K1: int) -> TileCandidates:
    """Bbox binning of _packed_rows' (T, 16) rows, validity and bboxes:
    each tile's K1 highest overlapping rows (pallas_raster._bin_tiles and
    the row gather of the JAX package). With eval_tiles, the plain version
    of the single-view CUDA kernel (raster_kernel.raster_mesh)."""
    nty = -(-height // tile_h)
    ntx = -(-width // TILE_W)
    kvals, max_count = _bin_tiles(bbox, ok, height, width, tile_h, K1)
    k_valid = kvals >= 0
    cdata = packed[torch.clamp(kvals, min=0)] * k_valid[..., None].float()
    return TileCandidates(cdata=cdata.reshape(nty, ntx, K1, 16),
                          max_count=max_count)


def union_boxes(ok, bbox):
    """Each triangle's union bbox (xmin, xmax, ymin, ymax), (T,) each, over
    the views where it is valid: ok (B, T), bbox four (B, T) tensors. A view
    where the triangle is invalid does not widen it; valid in none, it is
    (BIG, -BIG, BIG, -BIG) and meets no tile."""
    xmin, xmax, ymin, ymax = bbox

    def lo(v):
        return torch.amin(torch.where(ok, v, torch.full_like(v, BIG)), dim=0)

    def hi(v):
        return torch.amax(torch.where(ok, v, torch.full_like(v, -BIG)), dim=0)
    return lo(xmin), hi(xmax), lo(ymin), hi(ymax)


def tile_candidates_batch(verts, tris, vals, tri_valid, height: int,
                          width: int, truncate: bool = True,
                          tile_h: int = 32,
                          max_per_tile: int = 192) -> TileCandidates:
    """One triangle set seen from B views (verts (B, V, 2), vals (B, V),
    tri_valid (B, T)) with ONE shared binning pass
    (pallas_raster.rasterize_batch of the JAX package): each triangle's
    bbox is the union of its bboxes over the views where it is valid, one
    top-K picks each tile's K1 = min(max_per_tile, T) candidates, and
    every view takes its own rows for them. cdata is (B, nty, ntx, K1,
    16); a view where a candidate is invalid carries valid 0 in its row.
    max_count is the largest per-tile count of the union bboxes."""
    B = verts.shape[0]
    nty = -(-height // tile_h)
    ntx = -(-width // TILE_W)
    K1 = min(max_per_tile, tris.shape[0])
    packed, ok, bbox = _packed_rows(verts, tris, vals, tri_valid, truncate)
    kvals, max_count = _bin_tiles(union_boxes(ok, bbox), ok.any(dim=0),
                                  height, width, tile_h, K1)
    k_valid = kvals >= 0
    cdata = packed[:, torch.clamp(kvals, min=0)] \
        * k_valid[None, ..., None].float()
    return TileCandidates(cdata=cdata.reshape(B, nty, ntx, K1, 16),
                          max_count=max_count)


def eval_tiles(cdata: torch.Tensor, tile_h: int = 32) -> torch.Tensor:
    """Plain version of the tile kernel: (nty, ntx, K1, 16) candidates ->
    (nty*tile_h, ntx*128) max-combined values, NEG where uncovered."""
    nty, ntx, K1, _ = cdata.shape
    dev = cdata.device
    xs = torch.arange(TILE_W, dtype=torch.float32, device=dev)
    ys = torch.arange(tile_h, dtype=torch.float32, device=dev)
    ox = (torch.arange(ntx, device=dev) * TILE_W).float()
    rows = []
    for i in range(nty):  # one tile row at a time bounds the memory
        cd = cdata[i]  # (ntx, K1, 16)
        X = (ox[:, None, None, None] + xs)  # (ntx, 1, 1, 128)
        Y = float(i * tile_h) + ys[:, None]  # (tile_h, 1)

        def w(k):
            return (cd[:, :, k, None, None] * X
                    + cd[:, :, 3 + k, None, None] * Y
                    + cd[:, :, 6 + k, None, None])  # (ntx, K1, th, 128)

        w0, w1, w2 = w(0), w(1), w(2)
        inv_area = cd[:, :, 12, None, None]
        inside = ((w0 >= 0) & (w1 >= 0) & (w2 >= 0)
                  & (cd[:, :, 13, None, None] > 0))
        val = (w0 * (cd[:, :, 9, None, None] * inv_area)
               + w1 * (cd[:, :, 10, None, None] * inv_area)
               + w2 * (cd[:, :, 11, None, None] * inv_area))
        best = torch.where(inside, val, torch.full_like(val, NEG))
        best = torch.amax(best, dim=1)  # (ntx, th, 128)
        rows.append(best.permute(1, 0, 2).reshape(tile_h, ntx * TILE_W))
    return torch.cat(rows, dim=0)


def eval_tiles_batch(cdata: torch.Tensor, tile_h: int = 32) -> torch.Tensor:
    """Plain version of the batched tile kernel: (B, nty, ntx, K1, 16)
    -> (B, nty*tile_h, ntx*128), each view as eval_tiles."""
    return torch.stack([eval_tiles(cd, tile_h) for cd in cdata])


def finish(out: torch.Tensor, height: int, width: int) -> torch.Tensor:
    """Crop the tile grid(s) to ([B,] H, W); NaN where nothing covered."""
    out = out[..., :height, :width]
    return torch.where(out <= NEG * 0.5, torch.full_like(out, float("nan")),
                       out)


def rasterize(verts, tris, vals, tri_valid, height: int, width: int,
              truncate: bool = True, tile_h: int = 32,
              max_per_tile: int = 160) -> torch.Tensor:
    """The tiled rasterizer in plain torch."""
    cand = tile_candidates(verts, tris, vals, tri_valid, height, width,
                           truncate, tile_h, max_per_tile)
    return finish(eval_tiles(cand.cdata, tile_h), height, width)


def rasterize_batch(verts, tris, vals, tri_valid, height: int, width: int,
                    truncate: bool = True, tile_h: int = 32,
                    max_per_tile: int = 192) -> torch.Tensor:
    """The batched tiled rasterizer in plain torch: (B, H, W)."""
    cand = tile_candidates_batch(verts, tris, vals, tri_valid, height,
                                 width, truncate, tile_h, max_per_tile)
    return finish(eval_tiles_batch(cand.cdata, tile_h), height, width)


def rasterize_auto(verts, tris, vals, tri_valid, height: int,
                   width: int) -> torch.Tensor:
    """(H, W) map, NaN where uncovered: the tile kernel K2 for tensors on
    the card, the plain tiled rasterizer on the CPU."""
    from flame_tpu_torch.ops import raster_kernel  # it imports this module
    return raster_kernel.rasterize(verts, tris, vals, tri_valid, height,
                                   width)


def rasterize_batch_auto(verts, tris, vals, tri_valid, height: int,
                         width: int) -> torch.Tensor:
    """One triangle set from B views: verts (B, V, 2), vals (B, V),
    tri_valid (B, T) -> (B, H, W); the batched kernel K2b for tensors on
    the card, the plain shared binning on the CPU."""
    from flame_tpu_torch.ops import raster_kernel
    return raster_kernel.rasterize_batch(verts, tris, vals, tri_valid,
                                         height, width)


def interpolate_mesh(verts, tris, vals, tri_valid, vtx_valid, height: int,
                     width: int) -> torch.Tensor:
    """interpolateMesh (reference image_utils.cc:373-396): a triangle is
    drawn iff it and its three vertices are valid."""
    ok = tri_valid & torch.all(vtx_valid[tris], dim=1)
    return rasterize_auto(verts, tris, vals, ok, height, width)
