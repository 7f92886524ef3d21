"""Plain checks of a Delaunay triangulation.

A triangulation of points P is Delaunay when no point of P lies inside
the circumcircle of any of its triangles, and it is whole when its
triangles tile the convex hull of P. Both are checked in float64 from
the points and the triangle list alone, with no triangulator:

  violation(P, tris)  the largest (r - |p - c|) / r over the triangles of
                      nonzero area (circumcentre c, radius r) and the
                      points p that are not their corners, 0 where no
                      point lies inside
  hull_miss(P, tris)  |hull area - the triangles' positive areas| plus
                      their negative areas, over the hull area

`lowp_triangulation` is the control's triangulator: the Delaunay
triangulation of the points rounded to a lower precision (scipy's
Qhull, in float64, on the rounded points), oriented like the program's
(positive signed area in y-down pixels).

Plain torch and numpy; imports nothing of the port.
"""

import numpy as np
import torch

CHUNK = 512  # triangles per block of the point test


def _circles(p: torch.Tensor, tris: torch.Tensor):
    """Circumcentres (T, 2), radii (T,) and signed areas (T,) in float64."""
    a, b, c = p[tris[:, 0]], p[tris[:, 1]], p[tris[:, 2]]
    bx, by = b[:, 0] - a[:, 0], b[:, 1] - a[:, 1]
    cx, cy = c[:, 0] - a[:, 0], c[:, 1] - a[:, 1]
    d = 2.0 * (bx * cy - by * cx)
    safe = torch.where(d != 0, d, torch.ones_like(d))
    b2, c2 = bx * bx + by * by, cx * cx + cy * cy
    ux = (cy * b2 - by * c2) / safe
    uy = (bx * c2 - cx * b2) / safe
    centre = torch.stack([ux + a[:, 0], uy + a[:, 1]], dim=1)
    return centre, torch.sqrt(ux * ux + uy * uy), 0.25 * d


def violation(points, tris) -> float:
    """Largest relative depth of a point inside a triangle's circumcircle
    (0 where none is)."""
    p = torch.as_tensor(points).double()
    t = torch.as_tensor(tris).long().to(p.device)
    if t.shape[0] == 0:
        return 0.0
    centre, r, area = _circles(p, t)
    worst = torch.zeros((), dtype=torch.float64, device=p.device)
    idx = torch.arange(p.shape[0], device=p.device)
    for s in range(0, t.shape[0], CHUNK):
        sl = slice(s, s + CHUNK)
        d = torch.cdist(centre[sl], p,  # (C, N)
                        compute_mode="donot_use_mm_for_euclid_dist")
        depth = (r[sl, None] - d) / r[sl, None].clamp(min=1e-300)
        corner = (idx[None] == t[sl, 0:1]) | (idx[None] == t[sl, 1:2]) \
            | (idx[None] == t[sl, 2:3])
        live = (area[sl] > 0)[:, None] & ~corner
        depth = torch.where(live, depth, torch.zeros_like(depth))
        worst = torch.maximum(worst, depth.max())
    return float(worst)


def _hull_area(p: np.ndarray) -> float:
    """Area of the convex hull (monotone chain)."""
    pts = np.unique(p, axis=0)
    if pts.shape[0] < 3:
        return 0.0

    def cross(o, a, b):
        return (a[0] - o[0]) * (b[1] - o[1]) - (a[1] - o[1]) * (b[0] - o[0])

    def chain(seq):
        out = []
        for q in seq:
            while len(out) >= 2 and cross(out[-2], out[-1], q) <= 0:
                out.pop()
            out.append(q)
        return out[:-1]
    hull = np.array(chain(pts) + chain(pts[::-1]))
    x, y = hull[:, 0], hull[:, 1]
    return 0.5 * abs(float(np.dot(x, np.roll(y, -1))
                           - np.dot(y, np.roll(x, -1))))


def hull_miss(points, tris) -> float:
    """Share of the hull that the triangles miss or cover twice, with
    negatively oriented triangles counted whole."""
    p = torch.as_tensor(points).double()
    t = torch.as_tensor(tris).long().to(p.device)
    hull = _hull_area(p.cpu().numpy())
    if hull <= 0:
        return float("inf")
    if t.shape[0] == 0:
        return 1.0
    _, _, area = _circles(p, t)
    pos = float(area.clamp(min=0).sum())
    neg = float((-area).clamp(min=0).sum())
    return (abs(hull - pos) + neg) / hull


def lowp_triangulation(points, dtype) -> np.ndarray:
    """(T, 3) Delaunay triangles of the points rounded to dtype, indices
    into points, each with positive signed area on the rounded points
    (y-down pixels)."""
    from scipy.spatial import Delaunay
    p = torch.as_tensor(points).to(dtype).double().cpu().numpy()
    tris = Delaunay(p).simplices.astype(np.int64)
    a, b, c = p[tris[:, 0]], p[tris[:, 1]], p[tris[:, 2]]
    s = (b[:, 0] - a[:, 0]) * (c[:, 1] - a[:, 1]) \
        - (b[:, 1] - a[:, 1]) * (c[:, 0] - a[:, 0])
    tris[s < 0] = tris[s < 0][:, [0, 2, 1]]
    return tris
