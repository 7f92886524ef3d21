"""Frozen copy of flame_tpu_torch/stereo/meas_model.py for the benchmark's
tracking reference: imports rewired, float32 replaced by torch's default
dtype (the reference sets float64, the control bfloat16).

Inverse-depth measurement model (LSD-SLAM noise model), batched.

Port of flame_tpu/stereo/meas_model.py (reference
inverse_depth_meas_model.cc:49-156): a correspondence (u_ref, u_cmp)
becomes a measurement (mu, var); failures return mu=0, var=1e10,
ok=False. Coordinates are unpadded.
"""

from __future__ import annotations


import torch

from reference.tracking import epipolar
from reference.tracking import interp


def _noise_model(params: MeasModelParams, geo, u_ref, u_inf, epi, disp, mu,
                 gx, gy):
    bad_disp = disp < 1e-3
    bad_mu = mu < 0.0
    gnorm = torch.sqrt(gx * gx + gy * gy)
    bad_grad = gnorm < 1e-3
    safe_gnorm = torch.where(bad_grad, torch.ones_like(gnorm), gnorm)

    epi_dot_ngrad = (gx * epi[..., 0] + gy * epi[..., 1]) / safe_gnorm
    bad_epigrad = torch.abs(epi_dot_ngrad) < 1e-3
    safe_edn = torch.where(bad_epigrad, torch.ones_like(epi_dot_ngrad),
                           epi_dot_ngrad)
    geo_var = params.epipolar_line_var / (safe_edn * safe_edn)

    epi_dot_grad = gx * epi[..., 0] + gy * epi[..., 1]
    safe_edg = torch.where(torch.abs(epi_dot_grad) > 0, epi_dot_grad,
                           torch.ones_like(epi_dot_grad))
    photo_var = 2.0 * params.pixel_var / (safe_edg * safe_edg)

    # Disparity -> idepth slope by a +/-10% finite difference
    # (inverse_depth_meas_model.cc:133-139).
    disp_min = disp - disp / 10.0
    disp_max = disp + disp / 10.0
    id_min = epipolar.disparity_to_idepth(geo, u_ref, u_inf, epi, disp_min)
    id_max = epipolar.disparity_to_idepth(geo, u_ref, u_inf, epi, disp_max)
    span = disp_max - disp_min
    alpha = (id_max - id_min) / torch.where(torch.abs(span) > 0, span,
                                            torch.ones_like(span))
    var = alpha * alpha * (geo_var + photo_var)

    ok = ~(bad_disp | bad_mu | bad_grad | bad_epigrad)
    return (ok, torch.where(ok, mu, torch.zeros_like(mu)),
            torch.where(ok, var, torch.full_like(var, 1e10)))


def idepth_measurement(params: MeasModelParams, geo: epipolar.EpiGeo,
                       gradx_cmp: torch.Tensor, grady_cmp: torch.Tensor,
                       u_ref: torch.Tensor, u_cmp: torch.Tensor):
    """Batched measurement; returns (ok, mu, var)."""
    disp, u_inf, epi = epipolar.disparity(geo, u_ref, u_cmp)
    mu = epipolar.disparity_to_idepth(geo, u_ref, u_inf, epi, disp)
    gx = interp.bilinear(gradx_cmp, u_cmp[..., 0], u_cmp[..., 1])
    gy = interp.bilinear(grady_cmp, u_cmp[..., 0], u_cmp[..., 1])
    return _noise_model(params, geo, u_ref, u_inf, epi, disp, mu, gx, gy)


def idepth_measurement_stacked(params: MeasModelParams,
                               geo_batch: epipolar.EpiGeo,
                               gradx_stack: torch.Tensor,
                               grady_stack: torch.Tensor,
                               frame_idx: torch.Tensor,
                               u_ref: torch.Tensor, u_cmp: torch.Tensor):
    """idepth_measurement with a geometry per feature (geo_batch has a
    leading batch dim N) and the comparison gradients of each feature
    taken from the (F, H, W) stacks at frame_idx (N,): the JAX package's
    vmap over features, as a batch dimension. Returns (ok, mu, var)."""
    disp, u_inf, epi = epipolar.disparity(geo_batch, u_ref, u_cmp)
    mu = epipolar.disparity_to_idepth(geo_batch, u_ref, u_inf, epi, disp)
    gx = interp.bilinear_stack(gradx_stack, frame_idx, u_cmp[..., 0],
                               u_cmp[..., 1])
    gy = interp.bilinear_stack(grady_stack, frame_idx, u_cmp[..., 0],
                               u_cmp[..., 1])
    return _noise_model(params, geo_batch, u_ref, u_inf, epi, disp, mu, gx,
                        gy)
