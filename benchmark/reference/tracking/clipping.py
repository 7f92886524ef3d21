"""Frozen copy of flame_tpu_torch/ops/clipping.py for the benchmark's
tracking reference: imports rewired, float32 replaced by torch's default
dtype (the reference sets float64, the control bfloat16).

Branchless Liang-Barsky line clipping (port of flame_tpu/ops/clipping.py)."""

from __future__ import annotations


import torch


def clip_line(xmin, xmax, ymin, ymax, x0, y0, x1, y1):
    """Clip segments (x0,y0)-(x1,y1) to [xmin,xmax] x [ymin,ymax].

    Returns (valid, x0c, y0c, x1c, y1c); segments entirely outside get
    valid=False and endpoints clamped to the box."""
    dx = x1 - x0
    dy = y1 - y0
    p = torch.stack([-dx, dx, -dy, dy], dim=-1)
    q = torch.stack([x0 - xmin, xmax - x0, y0 - ymin, ymax - y0], dim=-1)
    r = q / torch.where(p == 0, torch.ones_like(p), p)
    reject_parallel = torch.any((p == 0) & (q < 0), dim=-1)
    t0 = torch.amax(torch.where(p < 0, r, torch.zeros_like(r)), dim=-1)
    t1 = torch.amin(torch.where(p > 0, r, torch.ones_like(r)), dim=-1)
    valid = ~reject_parallel & (t0 <= t1)
    return (valid,
            torch.clamp(x0 + t0 * dx, xmin, xmax),
            torch.clamp(y0 + t0 * dy, ymin, ymax),
            torch.clamp(x0 + t1 * dx, xmin, xmax),
            torch.clamp(y0 + t1 * dy, ymin, ymax))
