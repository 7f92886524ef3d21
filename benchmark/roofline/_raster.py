"""Shared counts of the rasterizer's roofline files (k2.py, k2b.py).

From the call's inputs alone: a triangle draws when it is valid and its
truncated corners span a nonzero area. Bytes: each vertex that a drawing
triangle uses read once per view (2 position words and its value), each
drawing triangle's 3 vertex indices once, the validity byte of each
triangle per view, and each map written once (4-byte words). Operations:
per drawing triangle and view its setup (30: three edge functions'
coefficients, the area and its reciprocal), per pixel of its bounding
box inside the image the three edge functions and the inside test (15),
and per covered pixel the interpolated value and the max (7).
"""

import torch

SETUP_OPS = 30
PAIR_OPS = 15
PIXEL_OPS = 7


def counts(verts, tris, tri_valid, maps):
    """verts (B, V, 2), tris (T, 3), tri_valid (B, T), maps (B, H, W)."""
    tris = tris.long()
    B, H, W = maps.shape
    p = torch.trunc(verts[:, tris].double())  # (B, T, 3, 2)
    v0, v1, v2 = p[..., 0, :], p[..., 1, :], p[..., 2, :]
    area2 = (v1[..., 0] - v0[..., 0]) * (v2[..., 1] - v0[..., 1]) \
        - (v1[..., 1] - v0[..., 1]) * (v2[..., 0] - v0[..., 0])
    draw = tri_valid.bool() & (area2 != 0)
    nx = (p[..., 0].amax(-1).clamp(max=W - 1)
          - p[..., 0].amin(-1).clamp(min=0) + 1).clamp(min=0)
    ny = (p[..., 1].amax(-1).clamp(max=H - 1)
          - p[..., 1].amin(-1).clamp(min=0) + 1).clamp(min=0)
    pairs = float((nx * ny * draw).sum())
    n_draw = int(draw.sum())
    any_draw = draw.any(0)
    used = 0
    for b in range(B):
        used += int(torch.unique(tris[draw[b]]).numel())
    covered = int((~torch.isnan(maps)).sum())
    nbytes = 12 * used + 12 * int(any_draw.sum()) + B * tris.shape[0] \
        + 4 * B * H * W
    ops = SETUP_OPS * n_draw + PAIR_OPS * pairs + PIXEL_OPS * covered
    return nbytes, ops
