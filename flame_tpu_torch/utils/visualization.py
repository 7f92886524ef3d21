"""Debug-image rendering: wireframes, feature overlays, colormapped depth.

A numpy copy of flame_tpu/utils/visualization.py. Re-design of the
reference's debug drawing (draw* functions,
src/flame/flame.cc:2363-2527, 2667-2736, and
utils/visualization.h line/wireframe painting): numpy rasterization of
colormapped overlays onto grayscale frames. Host-side and on-demand only —
never on the hot path.
"""

from typing import Optional

import numpy as np

from flame_tpu_torch.utils import colormaps


def to_rgb(gray: np.ndarray) -> np.ndarray:
    g = np.asarray(gray)
    g8 = np.clip(g, 0, 255).astype(np.uint8)
    return np.stack([g8, g8, g8], axis=-1)


def draw_line(img: np.ndarray, p0, p1, color) -> None:
    """In-place integer line draw (Bresenham-ish via dense sampling)."""
    H, W = img.shape[:2]
    p0 = np.asarray(p0, np.float64)
    p1 = np.asarray(p1, np.float64)
    n = int(max(2, np.ceil(np.abs(p1 - p0).max()) + 1))
    ts = np.linspace(0.0, 1.0, n)
    pts = p0[None, :] * (1 - ts[:, None]) + p1[None, :] * ts[:, None]
    xi = np.clip(np.round(pts[:, 0]).astype(int), 0, W - 1)
    yi = np.clip(np.round(pts[:, 1]).astype(int), 0, H - 1)
    img[yi, xi] = color


def draw_wireframe(gray: np.ndarray, vertices: np.ndarray,
                   idepths: np.ndarray, triangles: np.ndarray,
                   tri_validity: Optional[np.ndarray] = None,
                   scale: float = 1.0) -> np.ndarray:
    """Mesh wireframe colored by idepth (reference drawWireframe,
    flame.cc:2462-2527)."""
    img = to_rgb(gray)
    if tri_validity is None:
        tri_validity = np.ones(len(triangles), bool)
    for t, ok in zip(np.asarray(triangles), np.asarray(tri_validity)):
        if not ok:
            continue
        for a, b in ((t[0], t[1]), (t[1], t[2]), (t[2], t[0])):
            c = colormaps.idepth_color(
                np.array(0.5 * (idepths[a] + idepths[b])), scale)
            draw_line(img, vertices[a], vertices[b], c)
    return img


def draw_features(gray: np.ndarray, xy: np.ndarray, idepths: np.ndarray,
                  scale: float = 1.0, radius: int = 2) -> np.ndarray:
    """Feature dots colored by idepth (reference drawFeatures,
    flame.cc:2405-2460)."""
    img = to_rgb(gray)
    H, W = img.shape[:2]
    colors = colormaps.idepth_color(np.asarray(idepths), scale)
    for (x, y), c in zip(np.asarray(xy), colors):
        xi, yi = int(round(x)), int(round(y))
        # Clamp BOTH slice ends to >= 0: a negative stop (feature well
        # outside the frame) would wrap around and flood-fill most of
        # the image.
        y0, y1 = max(0, yi - radius), max(0, min(H, yi + radius + 1))
        x0, x1 = max(0, xi - radius), max(0, min(W, xi + radius + 1))
        img[y0:y1, x0:x1] = c
    return img


def draw_idepthmap(gray: np.ndarray, idepthmap: np.ndarray,
                   scale: float = 1.0, alpha: float = 0.7) -> np.ndarray:
    """Dense colormapped idepth overlay (reference drawInverseDepthMap,
    flame.cc:2667-2700)."""
    img = to_rgb(gray).astype(np.float64)
    idm = np.asarray(idepthmap)
    color = colormaps.idepth_color(idm, scale).astype(np.float64)
    ok = np.isfinite(idm) & (idm > 0)
    img = np.where(ok[..., None], (1 - alpha) * img + alpha * color, img)
    return img.astype(np.uint8)


def draw_detections(gray: np.ndarray, score_map: np.ndarray,
                    winners_xy: np.ndarray, max_score: float = 30.0
                    ) -> np.ndarray:
    """Detection scores + winners (reference drawDetections,
    flame.cc:2363-2403)."""
    img = to_rgb(gray).astype(np.float64)
    s = np.asarray(score_map)
    ok = np.isfinite(s)
    jetc = colormaps.jet(np.where(ok, s, 0.0), 0, max_score).astype(np.float64)
    img = np.where(ok[..., None], 0.5 * img + 0.5 * jetc, img)
    img = img.astype(np.uint8)
    H, W = img.shape[:2]
    for x, y in np.asarray(winners_xy).reshape(-1, 2):
        xi, yi = int(round(x)), int(round(y))
        img[max(0, yi - 2):min(H, yi + 3),
            max(0, xi - 2):min(W, xi + 3)] = (255, 255, 255)
    return img


def draw_normals(gray: np.ndarray, vertices: np.ndarray,
                 normals: np.ndarray, triangles: np.ndarray,
                 tri_validity: Optional[np.ndarray] = None) -> np.ndarray:
    """Triangle fill by mean vertex normal color (reference drawNormals,
    flame.cc:2702-2736 renders from w1/w2 maps; here from mesh normals)."""
    img = to_rgb(gray)
    if tri_validity is None:
        tri_validity = np.ones(len(triangles), bool)
    H, W = img.shape[:2]
    for t, ok in zip(np.asarray(triangles), np.asarray(tri_validity)):
        if not ok:
            continue
        n = normals[t].mean(axis=0)
        nn = np.linalg.norm(n)
        if nn < 1e-6:
            continue
        c = colormaps.normal_map(n / nn)
        # Fill via bbox + barycentric test (small triangles; host debug).
        v = vertices[t]
        x0, y0 = np.floor(v.min(axis=0)).astype(int)
        x1, y1 = np.ceil(v.max(axis=0)).astype(int)
        x0, y0 = max(x0, 0), max(y0, 0)
        x1, y1 = min(x1, W - 1), min(y1, H - 1)
        if x1 <= x0 or y1 <= y0:
            continue
        yy, xx = np.mgrid[y0:y1 + 1, x0:x1 + 1]
        d = ((v[1, 1] - v[2, 1]) * (v[0, 0] - v[2, 0])
             + (v[2, 0] - v[1, 0]) * (v[0, 1] - v[2, 1]))
        if abs(d) < 1e-9:
            continue
        w0 = ((v[1, 1] - v[2, 1]) * (xx - v[2, 0])
              + (v[2, 0] - v[1, 0]) * (yy - v[2, 1])) / d
        w1 = ((v[2, 1] - v[0, 1]) * (xx - v[2, 0])
              + (v[0, 0] - v[2, 0]) * (yy - v[2, 1])) / d
        w2 = 1 - w0 - w1
        inside = (w0 >= 0) & (w1 >= 0) & (w2 >= 0)
        region = img[y0:y1 + 1, x0:x1 + 1]
        region[inside] = c
    return img
