"""Unconstrained 2-D re-matching of BA observations.

Port of flame_tpu/ba/rematch.py. Tracking matches along the epipolar
line of the (possibly noisy) input poses, so its matches have zero
residual across the line by construction and BA is nearly blind to the
pose error. Before each solve, each observation is re-matched by a small
unconstrained 2-D SSD search around the current estimate's prediction:
its (2*(radius+hp)+1)^2 window is sampled once and the SSD field over
the (2*radius+1)^2 centres is a sum of shifted differences. Quadratic
subpixel refinement, a max-cost gate, an interior-minimum gate and a
corner gate (the anchor patch's structure tensor) decide which
observations take the new match; the rest keep their epipolar one.

Samples come straight from the stack's padded images (the JAX package's
img_pack table is a TPU gather workaround; its parity with the direct
sampler is tests/test_rematch.py::test_rematch_img_pack_parity).
"""

import torch

from flame_tpu_torch.geometry import epipolar, se3
from flame_tpu_torch.ops import interp


def _anchor_patch(imgs_pad, pad: int, anchor_slot, u_ref, hp: int):
    """(M, 2hp+1, 2hp+1) bilinear patch around u_ref in the anchor image."""
    M = u_ref.shape[0]
    Pn = 2 * hp + 1
    poffs = torch.arange(-hp, hp + 1, dtype=torch.float32,
                         device=u_ref.device)
    px = (u_ref[:, 0, None, None] + poffs[None, None, :] + pad) \
        .expand(M, Pn, Pn)
    py = (u_ref[:, 1, None, None] + poffs[None, :, None] + pad) \
        .expand(M, Pn, Pn)
    fanc = anchor_slot[:, None, None].expand(M, Pn, Pn)
    return interp.bilinear_stack(imgs_pad, fanc, px, py)


def _structure_tensor(patch):
    """Central-difference gradient sums over the patch interior."""
    gx = 0.5 * (patch[:, 1:-1, 2:] - patch[:, 1:-1, :-2])
    gy = 0.5 * (patch[:, 2:, 1:-1] - patch[:, :-2, 1:-1])
    return ((gx * gx).sum(dim=(1, 2)), (gy * gy).sum(dim=(1, 2)),
            (gx * gy).sum(dim=(1, 2)))


def rematch_observations(K, Kinv, imgs_pad, pad: int, qw, tw, anchor_idx,
                         obs_idx, anchor_slot, obs_slot, u_ref, u_obs,
                         lm_idx, lm_idepth, valid, radius: int = 3,
                         hp: int = 2, max_cost: float = 6500.0,
                         min_eig: float = 625.0):
    """Returns (u_obs_refined (M, 2), refined (M,) bool).

    qw/tw: (P, 4)/(P, 3) window poses (camera-to-world); anchor_idx /
    obs_idx: (M,) indices into them; anchor_slot/obs_slot: (M,) stack
    slots for image sampling; u_ref/u_obs: (M, 2) unpadded pixels;
    lm_idepth: (L,) anchor-frame inverse depths, lm_idx: (M,).
    """
    M = u_ref.shape[0]
    dev = u_ref.device
    Hp, Wp = imgs_pad.shape[1:]
    H, W = Hp - 2 * pad, Wp - 2 * pad

    # Predict each observation's pixel from the current estimates.
    q_rel, t_rel = se3.mul(se3.inverse((qw[obs_idx], tw[obs_idx])),
                           (qw[anchor_idx], tw[anchor_idx]))
    geos = epipolar.load(K, Kinv, q_rel, t_rel)
    u_pred, _ = epipolar.project_idepth(geos, u_ref, lm_idepth[lm_idx])

    # Window samples around the prediction (observed frame).
    r = radius + hp
    Wn = 2 * r + 1
    offs = torch.arange(-r, r + 1, dtype=torch.float32, device=dev)
    wx = (u_pred[:, 0, None, None] + offs[None, None, :] + pad) \
        .expand(M, Wn, Wn)
    wy = (u_pred[:, 1, None, None] + offs[None, :, None] + pad) \
        .expand(M, Wn, Wn)
    win = interp.bilinear_stack(imgs_pad,
                                obs_slot[:, None, None].expand(M, Wn, Wn),
                                wx, wy)
    patch = _anchor_patch(imgs_pad, pad, anchor_slot, u_ref, hp)

    # SSD field over candidate centres: costs[cy, cx] =
    # sum_patch (win[cy+py, cx+px] - patch[py, px])^2.
    Pn = 2 * hp + 1
    Cn = 2 * radius + 1
    costs = torch.zeros((M, Cn, Cn), device=dev)
    for dy in range(Pn):
        for dx in range(Pn):
            d = win[:, dy:dy + Cn, dx:dx + Cn] \
                - patch[:, dy:dy + 1, dx:dx + 1]
            costs = costs + d * d

    flat = costs.reshape(M, Cn * Cn)
    best = torch.argmin(flat, dim=1)
    by = best // Cn
    bx = best % Cn
    cmin = torch.gather(flat, 1, best[:, None])[:, 0]

    # Quadratic subpixel in x and y around the (interior) minimum.
    byc = torch.clamp(by, 1, Cn - 2)
    bxc = torch.clamp(bx, 1, Cn - 2)
    ii = torch.arange(M, device=dev)

    def at(dy, dx):
        return costs[ii, byc + dy, bxc + dx]

    def parab(cm, c0, cp):
        denom = cm - 2.0 * c0 + cp
        return torch.where(denom > 1e-12,
                           0.5 * (cm - cp) / torch.clamp(denom, min=1e-12),
                           torch.zeros_like(denom))

    sx = torch.clamp(parab(at(0, -1), at(0, 0), at(0, 1)), -0.5, 0.5)
    sy = torch.clamp(parab(at(-1, 0), at(0, 0), at(1, 0)), -0.5, 0.5)
    u_new = torch.stack([
        u_pred[:, 0] + (bx.float() - radius) + sx,
        u_pred[:, 1] + (by.float() - radius) + sy], dim=1)

    interior = (by >= 1) & (by <= Cn - 2) & (bx >= 1) & (bx <= Cn - 2)
    in_bounds = ((u_pred[:, 0] >= r) & (u_pred[:, 0] < W - r)
                 & (u_pred[:, 1] >= r) & (u_pred[:, 1] < H - r))

    # Aperture gate: trust a 2-D match only where the anchor patch
    # constrains both directions (min eigenvalue of its structure tensor
    # at least min_eig); edge-like patches keep their epipolar match.
    gxx, gyy, gxy = _structure_tensor(patch)
    tr = 0.5 * (gxx + gyy)
    det = gxx * gyy - gxy * gxy
    lam_min = tr - torch.sqrt(torch.clamp(tr * tr - det, min=0.0))
    corner = lam_min >= min_eig

    refined = valid & interior & in_bounds & (cmin <= max_cost) & corner
    return torch.where(refined[:, None], u_new, u_obs), refined


def observation_weights(imgs_pad, pad: int, anchor_slot, u_ref, hp: int = 2,
                        eps: float = 1e-3):
    """Per-observation 2x2 residual whitening sqrtW (M, 2, 2) from the
    anchor patch's gradient structure tensor, W = G / lambda_max: an
    edge-like patch constrains only its normal (W -> n n^T), a corner
    both directions (W -> I)."""
    patch = _anchor_patch(imgs_pad, pad, anchor_slot, u_ref, hp)
    gxx, gyy, gxy = _structure_tensor(patch)
    tr = 0.5 * (gxx + gyy)
    disc = torch.sqrt(torch.clamp(tr * tr - (gxx * gyy - gxy * gxy),
                                  min=0.0))
    s = 1.0 / torch.clamp(tr + disc, min=1e-12)
    Wxx, Wyy, Wxy = gxx * s, gyy * s, gxy * s
    # Analytic PSD square root of the 2x2 W (eigenvalues in [0, 1]):
    # sqrt(W) = (W + sqrt(det W) I) / sqrt(tr W + 2 sqrt(det W)).
    sdet = torch.sqrt(torch.clamp(Wxx * Wyy - Wxy * Wxy, min=0.0))
    denom = torch.sqrt(torch.clamp(Wxx + Wyy + 2.0 * sdet, min=eps))
    return torch.stack([
        torch.stack([(Wxx + sdet) / denom, Wxy / denom], dim=-1),
        torch.stack([Wxy / denom, (Wyy + sdet) / denom], dim=-1)], dim=-2)
