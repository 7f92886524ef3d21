"""Plain reference of the dense-map rasterizer (the port's K2 and K2b).

The semantics stated by the port and by the reference FLaME
(image_utils.cc:383-391): vertex pixel coordinates are truncated to
integers; a pixel (x, y) at integer coordinates is inside a triangle of
nonzero area when its three edge functions are >= 0; the value is the
barycentric interpolation of the vertex values; the map takes the
largest value over the triangles that cover a pixel and is NaN where
none does. The tile contract both kernels share with the TPU kernel is
kept too, because it decides which triangles draw: each 32 x 128 tile
keeps the max_per_tile highest-index valid triangles whose (truncated)
bounding box meets it; for B views of one triangle set (K2b) the boxes
are the union over the views in which the triangle is valid.

Plain torch in any dtype (float64 for the reference, bfloat16 for the
control), one tile at a time so that it fits; imports nothing of the
port.
"""

import torch

TILE_W = 128


def _setup(verts, tris, dtype):
    """Edge coefficients (B, T, 3) a, b, c sign-normalised so that inside
    is all >= 0, |2 area| (B, T) and the truncated corners."""
    p = torch.trunc(verts.to(dtype)[:, tris])  # (B, T, 3, 2)
    v0, v1, v2 = p[..., 0, :], p[..., 1, :], p[..., 2, :]

    def edge(pa, pb):
        return (pa[..., 1] - pb[..., 1], pb[..., 0] - pa[..., 0],
                pb[..., 1] * pa[..., 0] - pb[..., 0] * pa[..., 1])

    e = [edge(v1, v2), edge(v2, v0), edge(v0, v1)]
    a = torch.stack([x[0] for x in e], -1)
    b = torch.stack([x[1] for x in e], -1)
    c = torch.stack([x[2] for x in e], -1)
    area2 = (v1[..., 0] - v0[..., 0]) * (v2[..., 1] - v0[..., 1]) \
        - (v1[..., 1] - v0[..., 1]) * (v2[..., 0] - v0[..., 0])
    s = torch.where(area2 < 0, -1.0, 1.0).to(dtype)[..., None]
    return a * s, b * s, c * s, area2.abs(), p


def rasterize(verts, tris, vals, tri_valid, height: int, width: int,
              max_per_tile: int, union: bool = False, tile_h: int = 32,
              dtype=torch.float64) -> torch.Tensor:
    """verts (B, V, 2), tris (T, 3), vals (B, V), tri_valid (B, T) ->
    (B, H, W) maps in dtype, NaN where uncovered. union: one binning over
    the views' union boxes (K2b), else one per view (K2)."""
    tris = tris.long()
    B, T = tri_valid.shape
    dev = verts.device
    a, b, c, area2, p = _setup(verts, tris, dtype)
    ok = tri_valid.bool() & (area2 > 0)
    tv = vals.to(dtype)[:, tris]  # (B, T, 3)
    xmin, xmax = p[..., 0].amin(-1), p[..., 0].amax(-1)
    ymin, ymax = p[..., 1].amin(-1), p[..., 1].amax(-1)
    if union:
        def over_views(v, lowest):
            fill = torch.full_like(v.double(), 3e38 if lowest else -3e38)
            m = torch.where(ok, v.double(), fill)
            return (m.amin(0) if lowest else m.amax(0))[None].expand(B, T)
        boxes = (over_views(xmin, True), over_views(xmax, False),
                 over_views(ymin, True), over_views(ymax, False))
        ok_bin = ok.any(0)[None].expand(B, T)
    else:
        boxes = (xmin.double(), xmax.double(), ymin.double(), ymax.double())
        ok_bin = ok
    nty = -(-height // tile_h)
    ntx = -(-width // TILE_W)
    k1 = min(max_per_tile, T)
    out = torch.full((B, nty * tile_h, ntx * TILE_W), float("nan"),
                     dtype=dtype, device=dev)
    ys0 = torch.arange(tile_h, device=dev).to(dtype)[:, None]
    xs0 = torch.arange(TILE_W, device=dev).to(dtype)[None, :]
    idx = torch.arange(T, device=dev)
    for v in range(B if not union else 1):
        views = range(B) if union else [v]
        for ty in range(nty):
            y0 = ty * tile_h
            for tx in range(ntx):
                x0 = tx * TILE_W
                bx0, bx1, by0, by1 = (x[v] for x in boxes)
                meet = (ok_bin[v] & (bx0 <= x0 + TILE_W - 1) & (bx1 >= x0)
                        & (by0 <= y0 + tile_h - 1) & (by1 >= y0))
                cand = idx[meet]
                if cand.numel() == 0:
                    continue
                cand = cand[-k1:]  # the k1 highest indices
                Y = ys0 + y0
                X = xs0 + x0
                for w in views:
                    sel = cand[ok[w, cand]]
                    if sel.numel() == 0:
                        continue
                    ws = [a[w, sel, k, None, None] * X
                          + b[w, sel, k, None, None] * Y
                          + c[w, sel, k, None, None] for k in range(3)]
                    inside = (ws[0] >= 0) & (ws[1] >= 0) & (ws[2] >= 0)
                    val = (ws[0] * tv[w, sel, 0, None, None]
                           + ws[1] * tv[w, sel, 1, None, None]
                           + ws[2] * tv[w, sel, 2, None, None]) \
                        / area2[w, sel, None, None]
                    val = torch.where(inside, val,
                                      torch.full_like(val, float("-inf")))
                    best = val.amax(0)
                    out[w, y0:y0 + tile_h, x0:x0 + TILE_W] = torch.where(
                        torch.isinf(best), torch.full_like(best, float("nan")),
                        best)
    return out[:, :height, :width]
