"""Display-mesh triangle filters and vertex normals, batched over the mesh.

Port of flame_tpu/mesh/filters.py (reference flame.cc:2207-2361 filters,
:2529-2663 normals). Vertex normals are a sum of adjacent triangle
normals, normalized once.
"""

from typing import NamedTuple

import torch

from flame_tpu_torch.geometry.se3 import _cross
from flame_tpu_torch.params import TriangleFilterParams


class CornerGeometry(NamedTuple):
    uv: torch.Tensor  # (T, 3, 2) corner pixel positions
    ids: torch.Tensor  # (T, 3) corner idepths
    p: torch.Tensor  # (T, 3, 3) camera-frame corner points


def corner_geometry(Kinv, verts, idepths, tris) -> CornerGeometry:
    uv = verts[tris]
    ids = idepths[tris]
    x = Kinv[0, 0] * uv[..., 0] + Kinv[0, 2]
    y = Kinv[1, 1] * uv[..., 1] + Kinv[1, 2]
    rays = torch.stack([x, y, torch.ones_like(x)], dim=-1)
    safe = torch.where(ids > 0, ids, torch.ones_like(ids))[..., None]
    return CornerGeometry(uv=uv, ids=ids, p=rays / safe)


def _normalize(v):
    return v / torch.clamp(torch.linalg.norm(v, dim=-1, keepdim=True),
                           min=1e-12)


def oblique_filter(params: TriangleFilterParams, geom: CornerGeometry,
                   validity):
    """Drop triangles seen too obliquely or spanning too much idepth."""
    p0, p1, p2 = geom.p[:, 0], geom.p[:, 1], geom.p[:, 2]
    nn = _normalize(_cross(p1 - p0, p2 - p0))
    ray = _normalize((p0 + p1 + p2) / 3.0)
    cosang = torch.clamp(torch.sum(ray * nn, dim=-1), -1.0, 1.0)
    bad = torch.abs(torch.arccos(cosang)) > params.oblique_normal_thresh
    min_id = torch.amin(geom.ids, dim=-1)
    max_id = torch.amax(geom.ids, dim=-1)
    safe_max = torch.where(max_id != 0, max_id, torch.ones_like(max_id))
    bad |= (max_id - min_id) / safe_max > params.oblique_idepth_diff_factor
    bad |= (max_id - min_id) > params.oblique_idepth_diff_abs
    return validity & ~bad


def edge_length_filter(params: TriangleFilterParams, width: int,
                       geom: CornerGeometry, validity):
    """Drop triangles with an edge longer than a fraction of the width."""
    uv = geom.uv
    thresh2 = (params.edge_length_thresh * width) ** 2
    d01 = torch.sum((uv[:, 0] - uv[:, 1]) ** 2, dim=-1)
    d02 = torch.sum((uv[:, 0] - uv[:, 2]) ** 2, dim=-1)
    d12 = torch.sum((uv[:, 1] - uv[:, 2]) ** 2, dim=-1)
    return validity & ~((d01 > thresh2) | (d02 > thresh2) | (d12 > thresh2))


def idepth_filter(params: TriangleFilterParams, geom: CornerGeometry,
                  validity):
    """Drop far-away triangles (mean idepth below the threshold)."""
    return validity & ~(torch.mean(geom.ids, dim=-1)
                        < params.min_triangle_idepth)


def apply_filters(params: TriangleFilterParams, width: int,
                  geom: CornerGeometry, tri_mask):
    v = tri_mask
    if params.do_oblique_filter:
        v = oblique_filter(params, geom, v)
    if params.do_edge_length_filter:
        v = edge_length_filter(params, width, geom, v)
    if params.do_idepth_filter:
        v = idepth_filter(params, geom, v)
    return v


def vertex_normals(geom: CornerGeometry, tris, tri_mask,
                   n_vertices: int) -> torch.Tensor:
    """Triangle-averaged outward unit normals (V, 3); triangles with a
    non-positive corner idepth are skipped; zero where no triangle."""
    p0, p1, p2 = geom.p[:, 0], geom.p[:, 1], geom.p[:, 2]
    normal = _normalize(_cross(p2 - p0, p1 - p0))
    ok = tri_mask & torch.all(geom.ids > 0, dim=-1)
    normal = torch.where(ok[:, None], normal, torch.zeros_like(normal))
    acc = torch.zeros((n_vertices, 3), dtype=normal.dtype,
                      device=normal.device)
    for k in range(3):
        acc.index_add_(0, tris[:, k], normal)
    norms = torch.linalg.norm(acc, dim=-1, keepdim=True)
    return torch.where(norms > 1e-8, acc / torch.clamp(norms, min=1e-12),
                       torch.zeros_like(acc))


def plane_param_normal(K, uv, idepth, w1, w2) -> torch.Tensor:
    """Outward unit normal from the NLTGV2 plane parameters (w1, w2)
    (reference flame.cc:2643-2663), batched over vertices."""
    fx, fy = K[0, 0], K[1, 1]
    a = w1 * uv[..., 0] + w2 * uv[..., 1] - w1 * fx - w2 * fy
    b = fx * fx * w1 * w1 + fy * fy * w2 * w2 + (idepth - a) ** 2
    d = 1.0 / torch.sqrt(torch.clamp(b, min=1e-24))
    n = torch.stack([fx * w1 * d, fy * w2 * d, (idepth - a) * d], dim=-1)
    n = n / torch.clamp(torch.linalg.norm(n, dim=-1, keepdim=True),
                        min=1e-12)
    return -n
