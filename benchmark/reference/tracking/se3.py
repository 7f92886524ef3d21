"""Frozen copy of flame_tpu_torch/geometry/se3.py for the benchmark's
tracking reference: imports rewired, float32 replaced by torch's default
dtype (the reference sets float64, the control bfloat16).

SE(3) rigid-body transforms as (quaternion, translation) pairs.

Port of flame_tpu/geometry/se3.py. Quaternions are wxyz; every function
broadcasts over leading batch dimensions. A transform T = (q, t) maps
points p to R(q) @ p + t (camera-to-world when p is in camera coordinates).
"""

from __future__ import annotations


import torch


def _cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Cross product over the last axis, broadcasting the leading axes."""
    ax, ay, az = a[..., 0], a[..., 1], a[..., 2]
    bx, by, bz = b[..., 0], b[..., 1], b[..., 2]
    return torch.stack([ay * bz - az * by, az * bx - ax * bz,
                        ax * by - ay * bx], dim=-1)


def quat_identity(device=None) -> torch.Tensor:
    return torch.tensor([1.0, 0.0, 0.0, 0.0], dtype=torch.get_default_dtype(),
                        device=device)


def quat_normalize(q: torch.Tensor) -> torch.Tensor:
    return q / torch.linalg.norm(q, dim=-1, keepdim=True)


def quat_mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Hamilton product a*b."""
    aw, ax, ay, az = a.unbind(-1)
    bw, bx, by, bz = b.unbind(-1)
    return torch.stack([
        aw * bw - ax * bx - ay * by - az * bz,
        aw * bx + ax * bw + ay * bz - az * by,
        aw * by - ax * bz + ay * bw + az * bx,
        aw * bz + ax * by - ay * bx + az * bw,
    ], dim=-1)


def quat_conj(q: torch.Tensor) -> torch.Tensor:
    return torch.cat([q[..., :1], -q[..., 1:]], dim=-1)


def quat_rotate(q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Rotate v by unit quaternion q: v + 2*w*(u x v) + 2*(u x (u x v))."""
    u = q[..., 1:]
    w = q[..., :1]
    uv = _cross(u, v)
    return v + 2.0 * (w * uv + _cross(u, uv))


def quat_to_matrix(q: torch.Tensor) -> torch.Tensor:
    w, x, y, z = q.unbind(-1)
    xx, yy, zz = x * x, y * y, z * z
    xy, xz, yz = x * y, x * z, y * z
    wx, wy, wz = w * x, w * y, w * z
    m = torch.stack([
        1 - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy),
        2 * (xy + wz), 1 - 2 * (xx + zz), 2 * (yz - wx),
        2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (xx + yy),
    ], dim=-1)
    return m.reshape(m.shape[:-1] + (3, 3))


def quat_from_matrix(m: torch.Tensor) -> torch.Tensor:
    """Rotation matrices -> unit quaternions (branchless Shepperd)."""
    m00, m01, m02 = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    m10, m11, m12 = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    m20, m21, m22 = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]
    tr = m00 + m11 + m22
    qw = torch.stack([1.0 + tr, 1.0 + m00 - m11 - m22,
                      1.0 - m00 + m11 - m22, 1.0 - m00 - m11 + m22], dim=-1)
    qw = torch.clamp(qw, min=1e-12)
    s = 2.0 * torch.sqrt(qw)
    s0, s1, s2, s3 = s.unbind(-1)
    cand = torch.stack([
        torch.stack([s0 / 4, (m21 - m12) / s0, (m02 - m20) / s0,
                     (m10 - m01) / s0], dim=-1),
        torch.stack([(m21 - m12) / s1, s1 / 4, (m01 + m10) / s1,
                     (m02 + m20) / s1], dim=-1),
        torch.stack([(m02 - m20) / s2, (m01 + m10) / s2, s2 / 4,
                     (m12 + m21) / s2], dim=-1),
        torch.stack([(m10 - m01) / s3, (m02 + m20) / s3, (m12 + m21) / s3,
                     s3 / 4], dim=-1),
    ], dim=-2)
    best = torch.argmax(qw, dim=-1)
    idx = best[..., None, None].expand(best.shape + (1, 4))
    q = torch.gather(cand, -2, idx)[..., 0, :]
    return quat_normalize(q)


def identity(device=None):
    return quat_identity(device), torch.zeros(
        3, dtype=torch.get_default_dtype(), device=device)


def make(q: torch.Tensor, t: torch.Tensor):
    return quat_normalize(q), t


def mul(a, b):
    """(a*b)(p) = a(b(p))."""
    qa, ta = a
    qb, tb = b
    return quat_mul(qa, qb), quat_rotate(qa, tb) + ta


def inverse(T):
    q, t = T
    qinv = quat_conj(q)
    return qinv, -quat_rotate(qinv, t)


def act(T, p: torch.Tensor) -> torch.Tensor:
    q, t = T
    return quat_rotate(q, p) + t


def relative(T_a, T_b):
    """Transform taking frame-b coordinates into frame a: T_a^-1 * T_b."""
    return mul(inverse(T_a), T_b)


def to_matrix(T) -> torch.Tensor:
    q, t = T
    R = quat_to_matrix(q)
    top = torch.cat([R, t[..., :, None]], dim=-1)
    bottom = torch.tensor([0.0, 0.0, 0.0, 1.0], dtype=top.dtype,
                          device=top.device).expand(top.shape[:-2] + (1, 4))
    return torch.cat([top, bottom], dim=-2)


def from_matrix(m: torch.Tensor):
    return quat_from_matrix(m[..., :3, :3]), m[..., :3, 3]


# Small-angle series threshold (theta < 0.03): the direct formulas lose
# every mantissa bit of 1-cos and theta-sin in float32 below ~3e-4.
_SMALL_THETA2 = 9e-4


def _so3_exp(w: torch.Tensor):
    theta2 = torch.sum(w * w, dim=-1, keepdim=True)
    theta = torch.sqrt(torch.clamp(theta2, min=1e-24))
    small = theta2 < _SMALL_THETA2
    half = 0.5 * theta
    sinc_half = torch.where(small,
                            0.5 - theta2 / 48.0 + theta2 * theta2 / 3840.0,
                            torch.sin(half) / theta)
    t2 = theta2[..., 0]
    qw = torch.where(small[..., 0], 1.0 - t2 / 8.0 + t2 * t2 / 384.0,
                     torch.cos(half[..., 0]))
    q = torch.cat([qw[..., None], sinc_half * w], dim=-1)
    return quat_normalize(q), theta, theta2, small


def exp(xi: torch.Tensor):
    """se(3) tangent [v, w] -> (q, t), with t = V @ v."""
    v, w = xi[..., :3], xi[..., 3:]
    q, theta, theta2, small = _so3_exp(w)
    A = torch.where(small, 0.5 - theta2 / 24.0 + theta2 * theta2 / 720.0,
                    (1.0 - torch.cos(theta)) / torch.clamp(theta2, min=1e-24))
    B = torch.where(small,
                    1.0 / 6.0 - theta2 / 120.0 + theta2 * theta2 / 5040.0,
                    (theta - torch.sin(theta))
                    / torch.clamp(theta2 * theta, min=1e-24))
    wxv = _cross(w, v)
    return q, v + A * wxv + B * _cross(w, wxv)


def log(T) -> torch.Tensor:
    """(q, t) -> tangent [v, w]; inverse of exp."""
    q, t = T
    qw = torch.clamp(torch.abs(q[..., 0]), 0.0, 1.0)
    sign = torch.where(q[..., 0] < 0, -1.0, 1.0)[..., None]
    u = q[..., 1:] * sign
    un = torch.linalg.norm(u, dim=-1, keepdim=True)
    theta = 2.0 * torch.atan2(un[..., 0], qw)[..., None]
    small = un < 1e-9
    w = torch.where(small, 2.0 * u, theta * u / torch.clamp(un, min=1e-24))
    theta2 = torch.sum(w * w, dim=-1, keepdim=True)
    th = torch.sqrt(torch.clamp(theta2, min=1e-24))
    small2 = theta2 < _SMALL_THETA2
    coef = torch.where(
        small2, 1.0 / 12.0 + theta2 / 720.0 + theta2 * theta2 / 30240.0,
        (1.0 - th * torch.sin(th)
         / torch.clamp(2.0 * (1.0 - torch.cos(th)), min=1e-24))
        / torch.clamp(theta2, min=1e-24))
    wxt = _cross(w, t)
    v = t - 0.5 * wxt + coef * _cross(w, wxt)
    return torch.cat([v, w], dim=-1)


def rotation_angle(q: torch.Tensor) -> torch.Tensor:
    return 2.0 * torch.atan2(torch.linalg.norm(q[..., 1:], dim=-1),
                             torch.abs(q[..., 0]))


def stack(transforms):
    """A list of (q, t) transforms as batched (qs, ts)."""
    return (torch.stack([T[0] for T in transforms]),
            torch.stack([T[1] for T in transforms]))


def index(T, i):
    """Transform i of a batched (q, t)."""
    q, t = T
    return q[i], t[i]
