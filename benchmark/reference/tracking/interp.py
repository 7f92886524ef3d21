"""Frozen copy of flame_tpu_torch/ops/interp.py for the benchmark's
tracking reference: imports rewired, float32 replaced by torch's default
dtype (the reference sets float64, the control bfloat16); the corner
indices are clamped to the image in integers, which changes nothing in
float64 and keeps bfloat16 positions (W - 1.001 rounds to W) inside it;
a NaN position (bfloat16 only) samples the corner (0, 0).

Bilinear and nearest sampling by gathers.

Port of flame_tpu/ops/interp.py without its packed-corner tables (a TPU
gather workaround): each sample gathers its four corners directly. The
value at integer (x0, y0) is img[y0, x0]; bilinear positions are clamped
to the interior [0, W-1.001] x [0, H-1.001] so masked lanes stay total.
"""

from __future__ import annotations


import torch


def _sample(flat: torch.Tensor, W: int, base: torch.Tensor,
            x: torch.Tensor, y: torch.Tensor, x0: torch.Tensor,
            y0: torch.Tensor) -> torch.Tensor:
    dx = x - x0
    dy = y - y0
    idx = base + y0.long() * W + x0.long()
    v00 = flat[idx]
    v01 = flat[idx + 1]
    v10 = flat[idx + W]
    v11 = flat[idx + W + 1]
    return (v00 * ((1 - dx) * (1 - dy)) + v01 * (dx * (1 - dy))
            + v10 * ((1 - dx) * dy) + v11 * (dx * dy))


def bilinear(img: torch.Tensor, x: torch.Tensor,
             y: torch.Tensor) -> torch.Tensor:
    """Sample img (H, W) at float positions (x, y) of any batch shape."""
    H, W = img.shape
    x = torch.clamp(torch.nan_to_num(x), 0.0, W - 1.001)
    y = torch.clamp(torch.nan_to_num(y), 0.0, H - 1.001)
    return _sample(img.reshape(-1).to(torch.get_default_dtype()), W, 0, x,
                   y, torch.floor(x).long().clamp(0, W - 2),
                   torch.floor(y).long().clamp(0, H - 2))


def bilinear_stack(imgs: torch.Tensor, frame_idx: torch.Tensor,
                   x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Sample a stack (F, H, W), image frame_idx per sample."""
    F, H, W = imgs.shape
    x = torch.clamp(torch.nan_to_num(x), 0.0, W - 1.001)
    y = torch.clamp(torch.nan_to_num(y), 0.0, H - 1.001)
    base = torch.clamp(frame_idx, 0, F - 1).long() * (H * W)
    return _sample(imgs.reshape(-1).to(torch.get_default_dtype()), W, base,
                   x, y, torch.floor(x).long().clamp(0, W - 2),
                   torch.floor(y).long().clamp(0, H - 2))



def bilinear_uv(img: torch.Tensor, uv: torch.Tensor) -> torch.Tensor:
    """bilinear() at stacked (..., 2) positions in (x, y) order."""
    return bilinear(img, uv[..., 0], uv[..., 1])


def nearest(img: torch.Tensor, x: torch.Tensor,
            y: torch.Tensor) -> torch.Tensor:
    """Nearest-pixel lookup, rounding half up and clamping to the image
    (reference fast_roundf, flame.cc:749-752)."""
    H, W = img.shape
    xi = torch.clamp(torch.floor(x + 0.5).long(), 0, W - 1)
    yi = torch.clamp(torch.floor(y + 0.5).long(), 0, H - 1)
    return img.reshape(-1)[yi * W + xi]
