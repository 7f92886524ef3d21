"""Central-gradient stencil (port of flame_tpu/ops/gradients.py):
0.5*(right-left) inside, forward/backward differences at the borders."""

import torch


def central_gradient(img: torch.Tensor):
    """Per-pixel (gradx, grady) of an (H, W) image, float32."""
    f = img.float()
    gradx = torch.cat([f[:, 1:2] - f[:, 0:1], 0.5 * (f[:, 2:] - f[:, :-2]),
                       f[:, -1:] - f[:, -2:-1]], dim=1)
    grady = torch.cat([f[1:2] - f[0:1], 0.5 * (f[2:] - f[:-2]),
                       f[-1:] - f[-2:-1]], dim=0)
    return gradx, grady
