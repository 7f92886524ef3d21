"""Pinhole intrinsics helpers (port of flame_tpu/geometry/camera.py).
Pixel coordinates are (x, y), x along image columns."""

import torch


def make_k(fx: float, fy: float, cx: float, cy: float,
           device=None) -> torch.Tensor:
    return torch.tensor([[fx, 0.0, cx], [0.0, fy, cy], [0.0, 0.0, 1.0]],
                        dtype=torch.float32, device=device)


def inv_k(K: torch.Tensor) -> torch.Tensor:
    fx, fy, cx, cy = K[0, 0], K[1, 1], K[0, 2], K[1, 2]
    z = torch.zeros((), dtype=K.dtype, device=K.device)
    o = torch.ones((), dtype=K.dtype, device=K.device)
    return torch.stack([torch.stack([1.0 / fx, z, -cx / fx]),
                        torch.stack([z, 1.0 / fy, -cy / fy]),
                        torch.stack([z, z, o])])


def project(K: torch.Tensor, p_cam: torch.Tensor) -> torch.Tensor:
    """Camera-frame points (..., 3) -> pixels (..., 2). No depth check."""
    x = K[0, 0] * p_cam[..., 0] + K[0, 2] * p_cam[..., 2]
    y = K[1, 1] * p_cam[..., 1] + K[1, 2] * p_cam[..., 2]
    return torch.stack([x, y], dim=-1) / p_cam[..., 2:3]


def backproject(Kinv: torch.Tensor, uv: torch.Tensor) -> torch.Tensor:
    """Pixels (..., 2) -> unit-depth rays (..., 3) in the camera frame."""
    x = Kinv[0, 0] * uv[..., 0] + Kinv[0, 2]
    y = Kinv[1, 1] * uv[..., 1] + Kinv[1, 2]
    return torch.stack([x, y, torch.ones_like(x)], dim=-1)
