"""Gaussian image pyramids (port of flame_tpu/ops/pyramid.py).

The reference's cv::pyrDown pyramid (utils/pyramids.h:42-127): the 5-tap
binomial kernel [1 4 6 4 1]/16 applied separably with reflect-101
borders, then 2x decimation.
"""

from typing import List

import numpy as np
import torch
import torch.nn.functional as F

from flame_tpu_torch.ops.gradients import central_gradient

_KERNEL5 = (1.0 / 16.0, 4.0 / 16.0, 6.0 / 16.0, 4.0 / 16.0, 1.0 / 16.0)


def _blur5(img: torch.Tensor) -> torch.Tensor:
    """Separable 5-tap binomial blur with reflect-101 borders (cv::pyrDown's
    default), rows first, each pass summed tap by tap."""
    f = img.float()
    H, W = f.shape
    p = F.pad(f[None, None], (0, 0, 2, 2), mode="reflect")[0, 0]
    out = torch.zeros_like(f)
    for k, w in enumerate(_KERNEL5):
        out = out + w * p[k:k + H, :]
    p = F.pad(out[None, None], (2, 2, 0, 0), mode="reflect")[0, 0]
    out2 = torch.zeros_like(f)
    for k, w in enumerate(_KERNEL5):
        out2 = out2 + w * p[:, k:k + W]
    return out2


def pyr_down(img: torch.Tensor) -> torch.Tensor:
    """One level down: blur, then the even rows and columns."""
    return _blur5(img)[::2, ::2]


def gaussian_pyramid(img: torch.Tensor, num_levels: int) -> List[torch.Tensor]:
    """Level 0 is the input image itself (reference pyramids.h:42-51)."""
    levels = [img.float()]
    for _ in range(num_levels - 1):
        levels.append(pyr_down(levels[-1]))
    return levels


def gradient_pyramid(levels: List[torch.Tensor]):
    """Central gradients of each level (reference pyramids.h:71-115):
    (gradx list, grady list)."""
    grads = [central_gradient(lvl) for lvl in levels]
    return [g[0] for g in grads], [g[1] for g in grads]


def montage(levels: List) -> np.ndarray:
    """Debug montage of a pyramid (reference pyramids.cc:29-70's layout):
    level 0 on the left, the next levels stacked top-down in a half-width
    right column. Host numpy; a float32 (H, W + ceil(W/2)) image, zero
    where unused."""
    lv = [l.cpu().numpy().astype(np.float32) if isinstance(l, torch.Tensor)
          else np.asarray(l, np.float32) for l in levels]
    H, W = lv[0].shape
    cw = (W + 1) // 2
    out = np.zeros((H, W + cw), np.float32)
    out[:, :W] = lv[0]
    y = 0
    for l in lv[1:]:
        h, w = l.shape
        if y + h > H:
            break
        out[y:y + h, W:W + min(w, cw)] = l[:, :min(w, cw)]
        y += h
    return out
