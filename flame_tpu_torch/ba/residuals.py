"""Reprojection residuals and Jacobian blocks for windowed BA.

Port of flame_tpu/ba/residuals.py. Poses are camera-to-world (q, t) per
keyframe, perturbed on the left in the world frame (T <- exp(xi) T,
xi = [v, w]); a landmark is a scalar inverse depth d anchored at pixel
u_ref of an anchor keyframe. For observation (anchor a, observer o):

  p_w = T_a (ray(u_ref) / d),  p_o = T_o^-1 p_w,  r = pi(K, p_o) - u_obs.

The JAX package differentiates r with jax.jacfwd inside a vmap; here the
Jacobians are the closed-form first-order terms over all observations at
once:

  dp_o/dxi_a = R_o^T [I | -[p_w]x],   dp_o/dxi_o = -dp_o/dxi_a,
  dp_o/dd    = -R_o^T R_a ray / d^2   (0 where d is clamped to 1e-6),

chained with the projection's d pi / d p_o (whose z column is 0 where
|z| is clamped to 1e-6, as the JAX version's safe_z makes it).
"""

from typing import NamedTuple

import torch

from flame_tpu_torch.geometry import se3


class BAObservations(NamedTuple):
    """Padded observation set [M]."""

    anchor_idx: torch.Tensor  # (M,) int64 index into window poses
    obs_idx: torch.Tensor  # (M,) int64 index into window poses
    lm_idx: torch.Tensor  # (M,) int64 landmark index
    u_ref: torch.Tensor  # (M, 2)
    u_obs: torch.Tensor  # (M, 2)
    valid: torch.Tensor  # (M,) bool


def _skew(p: torch.Tensor) -> torch.Tensor:
    """(M, 3) -> (M, 3, 3) with _skew(p) @ w = p x w."""
    z = torch.zeros_like(p[:, 0])
    x, y, w = p.unbind(1)
    return torch.stack([torch.stack([z, -w, y], 1),
                        torch.stack([w, z, -x], 1),
                        torch.stack([-y, x, z], 1)], 1)


def residuals_and_jacobians(K, Kinv, q_w, t_w, obs: BAObservations,
                            lm_idepth, huber_delta: float, sqrtW=None):
    """Batched residuals + Jacobian blocks + robust weights.

    q_w, t_w: (P, 4), (P, 3) window poses. lm_idepth: (L,). sqrtW:
    optional (M, 2, 2) residual whitening, applied to the residual and
    every Jacobian block. Returns (r (M, 2), Ja (M, 2, 6), Jo (M, 2, 6),
    Jd (M, 2), w (M,)); invalid or behind-camera observations get zero
    weight.
    """
    qa, ta = q_w[obs.anchor_idx], t_w[obs.anchor_idx]
    qo, to = q_w[obs.obs_idx], t_w[obs.obs_idx]
    d = lm_idepth[obs.lm_idx]
    u_ref = obs.u_ref
    rx = Kinv[0, 0] * u_ref[:, 0] + Kinv[0, 2]
    ry = Kinv[1, 1] * u_ref[:, 1] + Kinv[1, 2]
    ray = torch.stack([rx, ry, torch.ones_like(rx)], dim=1)
    depth = 1.0 / torch.clamp(d, min=1e-6)
    p_w = se3.act((qa, ta), ray * depth[:, None])
    qo_inv = se3.quat_conj(qo)
    p_o = se3.act(se3.inverse((qo, to)), p_w)
    x, y, z = p_o.unbind(1)
    big = torch.abs(z) > 1e-6
    safe_z = torch.where(big, z, torch.full_like(z, 1e-6))
    fx, fy = K[0, 0], K[1, 1]
    u = torch.stack([fx * x / safe_z + K[0, 2], fy * y / safe_z + K[1, 2]],
                    dim=1)
    r = u - obs.u_obs

    # d pi / d p_o (M, 2, 3).
    zero = torch.zeros_like(z)
    dz = torch.where(big, -1.0 / (safe_z * safe_z), zero)
    Jp = torch.stack([
        torch.stack([fx / safe_z, zero, fx * x * dz], 1),
        torch.stack([zero, fy / safe_z, fy * y * dz], 1)], 1)
    R_oT = se3.quat_to_matrix(qo_inv)  # (M, 3, 3)
    dpo_a = torch.cat([R_oT, -R_oT @ _skew(p_w)], dim=2)  # (M, 3, 6)
    Ja = Jp @ dpo_a
    Jo = -Ja
    dpo_d = se3.quat_rotate(qo_inv, se3.quat_rotate(qa, ray)) \
        * torch.where(d > 1e-6, -depth * depth, zero)[:, None]
    Jd = (Jp @ dpo_d[:, :, None])[:, :, 0]
    if sqrtW is not None:
        r = (sqrtW @ r[:, :, None])[:, :, 0]
        Ja = sqrtW @ Ja
        Jo = sqrtW @ Jo
        Jd = (sqrtW @ Jd[:, :, None])[:, :, 0]
    # Robust (Huber) weight on the residual norm.
    rn = torch.linalg.norm(r, dim=1)
    w_h = torch.where(rn <= huber_delta, torch.ones_like(rn),
                      huber_delta / torch.clamp(rn, min=1e-12))
    w = torch.where(obs.valid & (z > 1e-3), w_h, torch.zeros_like(rn))
    return r, Ja, Jo, Jd, w
