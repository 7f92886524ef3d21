"""Gradient-grid feature detection as a dense computation.

Port of flame_tpu/core/detection.py (reference flame.cc:1192-1262): the
epipolar-projected gradient score of every pixel at once, masked by the
border and the gradient threshold, reduced per detection cell with a
reshape + argmax. The reference epiline is evaluated at (x, y), not at the
reference's swapped (row, col).
"""

from typing import NamedTuple

import torch
import torch.nn.functional as F

from flame_tpu_torch.geometry import epipolar


class DetectionResult(NamedTuple):
    best_xy: torch.Tensor  # (Cy, Cx, 2) best pixel per cell
    best_score: torch.Tensor  # (Cy, Cx) epipolar gradient^2 (0 = none)
    score_map: torch.Tensor  # (H, W) |epigrad|, NaN where masked


def _cells(geo_ref_to_prev: epipolar.EpiGeo, gradx: torch.Tensor,
           grady: torch.Tensor, min_grad_mag: float, win_size: int,
           border: int, row_offset: int):
    """(best_xy, best_score, ok, epigrad): the per-cell winners, and the
    per-pixel mask and epipolar gradient they were chosen from."""
    H, W = gradx.shape
    dev = gradx.device
    thresh2 = min_grad_mag * min_grad_mag
    yy, xx = torch.meshgrid(torch.arange(H, dtype=torch.float32, device=dev),
                            torch.arange(W, dtype=torch.float32, device=dev),
                            indexing="ij")
    t = geo_ref_to_prev.t_cmp_to_ref
    K = geo_ref_to_prev.K
    tz = t[2]
    ex = -K[0, 0] * t[0] + tz * (xx - K[0, 2])
    ey = -K[1, 1] * t[1] + tz * (yy - K[1, 2])
    en = torch.sqrt(torch.clamp(ex * ex + ey * ey, min=1e-24))
    ex = ex / en
    ey = ey / en

    gmag2 = gradx * gradx + grady * grady
    epigrad = gradx * ex + grady * ey
    epigrad2 = epigrad * epigrad
    in_border = ((xx >= border) & (xx < W - border)
                 & (yy >= border + row_offset)
                 & (yy < H - border - row_offset))
    ok = in_border & (gmag2 >= thresh2) & (epigrad2 >= thresh2)
    score = torch.where(ok, epigrad2, torch.zeros_like(epigrad2))

    Cy = -(-H // win_size)
    Cx = -(-W // win_size)
    score_p = F.pad(score, (0, Cx * win_size - W, 0, Cy * win_size - H))
    cells = score_p.reshape(Cy, win_size, Cx, win_size).permute(0, 2, 1, 3)
    cells = cells.reshape(Cy, Cx, win_size * win_size)
    best = torch.argmax(cells, dim=-1)
    best_score = torch.gather(cells, -1, best[..., None])[..., 0]
    by = best // win_size + torch.arange(Cy, device=dev)[:, None] * win_size
    bx = best % win_size + torch.arange(Cx, device=dev)[None, :] * win_size
    return torch.stack([bx, by], dim=-1).float(), best_score, ok, epigrad


def detect(geo_ref_to_prev: epipolar.EpiGeo, gradx: torch.Tensor,
           grady: torch.Tensor, min_grad_mag: float, win_size: int,
           border: int, row_offset: int = 0) -> DetectionResult:
    """Per-cell best epipolar-gradient pixel, and the per-pixel score map
    the debug image draws. geo_ref_to_prev: the geometry from the
    detection (reference) frame to the comparison frame."""
    best_xy, best_score, ok, epigrad = _cells(
        geo_ref_to_prev, gradx, grady, min_grad_mag, win_size, border,
        row_offset)
    score_map = torch.where(ok, torch.abs(epigrad),
                            torch.full_like(epigrad, float("nan")))
    return DetectionResult(best_xy, best_score, score_map)


def occupied_cells(feat_xy: torch.Tensor, feat_valid: torch.Tensor,
                   win_size: int, n_cells_y: int,
                   n_cells_x: int) -> torch.Tensor:
    """Mask of detection cells already holding a valid feature
    (reference flame.cc:1194-1204)."""
    cx = torch.clamp(torch.div(feat_xy[:, 0], win_size,
                               rounding_mode="floor").long(), 0,
                     n_cells_x - 1)
    cy = torch.clamp(torch.div(feat_xy[:, 1], win_size,
                               rounding_mode="floor").long(), 0,
                     n_cells_y - 1)
    occ = torch.zeros(n_cells_y * n_cells_x, dtype=torch.int32,
                      device=feat_xy.device)
    occ.index_add_(0, cy * n_cells_x + cx, feat_valid.int())
    return (occ > 0).reshape(n_cells_y, n_cells_x)


def detect_packed(geo_ref_to_prev: epipolar.EpiGeo, gradx: torch.Tensor,
                  grady: torch.Tensor, feat_xy: torch.Tensor,
                  feat_valid: torch.Tensor, min_grad_mag: float,
                  win_size: int, border: int,
                  row_offset: int = 0) -> torch.Tensor:
    """detect()'s winners + occupied-cell masking: (Cy*Cx, 3) rows
    [x, y, take]."""
    best_xy, best_score, _, _ = _cells(geo_ref_to_prev, gradx, grady,
                                       min_grad_mag, win_size, border,
                                       row_offset)
    cy, cx = best_score.shape
    occ = occupied_cells(feat_xy, feat_valid, win_size, cy, cx)
    take = (best_score > 0) & ~occ
    return torch.cat([best_xy.reshape(-1, 2),
                      take.reshape(-1, 1).float()], dim=1)
