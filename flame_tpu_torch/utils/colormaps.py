"""Colormaps for depth/normal visualization, vectorized over whole images.

A numpy copy of flame_tpu/utils/colormaps.py. Re-design of the
reference's per-pixel colormap helpers
(src/flame/utils/visualization.h: jet :142-167,
idepthColor/HSL ramp :94-214, normalMap :119-130, blendColor :172-188) as
numpy array ops. All outputs are uint8 RGB (H, W, 3) or (N, 3).
"""

import numpy as np


def jet(v, vmin: float = 0.0, vmax: float = 1.0) -> np.ndarray:
    """Classic 4-segment jet colormap (reference visualization.h:142-167)."""
    v = np.asarray(v, np.float64)
    v = np.clip((v - vmin) / max(vmax - vmin, 1e-12), 0.0, 1.0)
    r = np.clip(1.5 - np.abs(4.0 * v - 3.0), 0, 1)
    g = np.clip(1.5 - np.abs(4.0 * v - 2.0), 0, 1)
    b = np.clip(1.5 - np.abs(4.0 * v - 1.0), 0, 1)
    return (np.stack([r, g, b], axis=-1) * 255).astype(np.uint8)


def hsl_to_rgb(h, s, l) -> np.ndarray:
    """HSL -> RGB, h in [0, 360) (reference visualization.h:94-114)."""
    h = np.asarray(h, np.float64) % 360.0
    s = np.asarray(s, np.float64)
    l = np.asarray(l, np.float64)
    c = (1 - np.abs(2 * l - 1)) * s
    hp = h / 60.0
    x = c * (1 - np.abs(hp % 2 - 1))
    z = np.zeros_like(c)
    conds = [(hp < 1)[..., None], (hp < 2)[..., None], (hp < 3)[..., None],
             (hp < 4)[..., None], (hp < 5)[..., None], (hp >= 5)[..., None]]
    rgb = np.select(
        conds,
        [np.stack([c, x, z], -1), np.stack([x, c, z], -1),
         np.stack([z, c, x], -1), np.stack([z, x, c], -1),
         np.stack([x, z, c], -1), np.stack([c, z, x], -1)])
    m = (l - c / 2)[..., None]
    return ((rgb + m) * 255).astype(np.uint8)


def idepth_color(idepth, scale: float = 1.0) -> np.ndarray:
    """Hue ramp over inverse depth (reference visualization.h:198-214):
    near = red-ish, far = blue-ish; NaN/non-positive -> black."""
    v = np.asarray(idepth, np.float64) * scale
    ok = np.isfinite(v) & (v > 0)
    vv = np.where(ok, v, 1.0)
    hue = np.clip(360.0 * vv / (vv + 1.0), 0, 359)
    rgb = hsl_to_rgb(hue, np.full_like(vv, 1.0), np.full_like(vv, 0.5))
    return np.where(ok[..., None], rgb, 0).astype(np.uint8)


def normal_map(normals) -> np.ndarray:
    """Unit normals -> RGB (reference visualization.h:119-130)."""
    n = np.asarray(normals, np.float64)
    return ((n * 0.5 + 0.5) * 255).clip(0, 255).astype(np.uint8)


def blend(c0, c1, v, vmin: float = 0.0, vmax: float = 1.0) -> np.ndarray:
    """Linear blend between two colors (reference visualization.h:172-188)."""
    t = np.clip((np.asarray(v, np.float64) - vmin) / max(vmax - vmin, 1e-12),
                0, 1)[..., None]
    c0 = np.asarray(c0, np.float64)
    c1 = np.asarray(c1, np.float64)
    return ((1 - t) * c0 + t * c1).astype(np.uint8)
