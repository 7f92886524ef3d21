"""Frozen copy of flame_tpu_torch/ops/gradients.py for the benchmark's
tracking reference: imports rewired, float32 replaced by torch's default
dtype (the reference sets float64, the control bfloat16).

Image gradient stencils (port of flame_tpu/ops/gradients.py): central
differences 0.5*(right-left) inside with forward/backward differences at
the borders, the 3x3 Sobel operator and the 3x3 max filter (reference
image_utils.h)."""

from __future__ import annotations


import torch
import torch.nn.functional as F


def central_gradient(img: torch.Tensor):
    """Per-pixel (gradx, grady) of an (H, W) image, float32."""
    f = img.to(torch.get_default_dtype())
    gradx = torch.cat([f[:, 1:2] - f[:, 0:1], 0.5 * (f[:, 2:] - f[:, :-2]),
                       f[:, -1:] - f[:, -2:-1]], dim=1)
    grady = torch.cat([f[1:2] - f[0:1], 0.5 * (f[2:] - f[:-2]),
                       f[-1:] - f[-2:-1]], dim=0)
    return gradx, grady


def gradient_mag_sq(gradx: torch.Tensor, grady: torch.Tensor) -> torch.Tensor:
    """Squared gradient magnitude (reference getGradientMag)."""
    return gradx * gradx + grady * grady


_SOBEL_X = ((-1.0, 0.0, 1.0), (-2.0, 0.0, 2.0), (-1.0, 0.0, 1.0))


def sobel(img: torch.Tensor):
    """3x3 Sobel gradients (gradx, grady) with a zero border (reference
    image_utils.h:391-409), summed tap by tap in row-major order."""
    f = img.to(torch.get_default_dtype())
    H, W = f.shape
    pad = F.pad(f, (1, 1, 1, 1))

    def conv3(k):
        out = torch.zeros_like(f)
        for dy in range(3):
            for dx in range(3):
                out = out + k[dy][dx] * pad[dy:dy + H, dx:dx + W]
        return out
    return conv3(_SOBEL_X), conv3(tuple(zip(*_SOBEL_X)))


def max_filter3(img: torch.Tensor) -> torch.Tensor:
    """3x3 max filter with replicated edges (reference
    image_utils.h:333-379)."""
    H, W = img.shape
    rows = torch.arange(-1, H + 1, device=img.device).clamp(0, H - 1)
    cols = torch.arange(-1, W + 1, device=img.device).clamp(0, W - 1)
    p = img[rows][:, cols]  # edge padding for any dtype
    out = img
    for dy in range(3):
        for dx in range(3):
            out = torch.maximum(out, p[dy:dy + H, dx:dx + W])
    return out
