"""Frozen copy of flame_tpu_torch/stereo/filter.py for the benchmark's
tracking reference: imports rewired, float32 replaced by torch's default
dtype (the reference sets float64, the control bfloat16).

Batched LSD-SLAM-style inverse-depth filtering.

Port of flame_tpu/stereo/filter.py (reference inverse_depth_filter.cc):
predict, the +/-sigma epipolar search region with Liang-Barsky clipping
and length clamps, the patch search (one reference image, or each
feature's own poseframe of a stack), and Gaussian fusion with a chi^2
gate. Every function is total over the feature batch; the
reference's early returns become masks.
"""

from __future__ import annotations


from typing import NamedTuple

import torch

from reference.tracking import epipolar
from reference.tracking import clipping, interp
from reference.tracking import line_stereo

SUCCESS = 0
FAIL_REF_PATCH_GRADIENT = 1
FAIL_AMBIGUOUS_MATCH = 2
FAIL_MAX_COST = 3


def predict(geo: epipolar.EpiGeo, process_var_factor: float,
            u_ref: torch.Tensor, mu: torch.Tensor, var: torch.Tensor):
    """Project means into the cmp frame and inflate the variance by
    (mu'/mu)^4 (reference :35-63). Returns (ok, u_cmp, mu_pred, var_pred);
    lanes behind the camera get mu 0, var 1e10."""
    u_cmp, mu_pred = epipolar.project_idepth(geo, u_ref, mu)
    behind = mu_pred < 0.0
    ratio = mu_pred / torch.where(torch.abs(mu) > 0, mu, torch.ones_like(mu))
    var_factor4 = torch.where(mu < 1e-6, torch.ones_like(ratio), ratio ** 4)
    var_pred = process_var_factor * var_factor4 * var
    mu_pred = torch.where(behind, torch.zeros_like(mu_pred), mu_pred)
    var_pred = torch.where(behind, torch.full_like(var_pred, 1e10), var_pred)
    return ~behind, u_cmp, mu_pred, var_pred


class SearchRegion(NamedTuple):
    ok: torch.Tensor  # (N,) bool
    start: torch.Tensor  # (N, 2)
    end: torch.Tensor  # (N, 2)
    epi: torch.Tensor  # (N, 2) unit direction


def _clip(width, height, start, end):
    cv, sx, sy, ex, ey = clipping.clip_line(
        1.0, float(width - 1), 1.0, float(height - 1),
        start[..., 0], start[..., 1], end[..., 0], end[..., 1])
    return cv, torch.stack([sx, sy], dim=-1), torch.stack([ex, ey], dim=-1)


def _length(start, end):
    d = end - start
    return torch.sqrt(torch.sum(d * d, dim=-1))


def get_search_region(params: FilterParams, geo: epipolar.EpiGeo,
                      width: int, height: int, u_ref: torch.Tensor,
                      mu_prior: torch.Tensor,
                      var_prior: torch.Tensor) -> SearchRegion:
    """The +/- search_sigma epipolar segment, clipped to the 1-px border
    and padded/clamped in length (reference :65-182)."""
    sigma = torch.sqrt(torch.clamp(var_prior, min=0.0))
    has_prior = ~(torch.isnan(mu_prior) | torch.isnan(var_prior))
    id_min = torch.where(has_prior, mu_prior - params.search_sigma * sigma,
                         torch.full_like(mu_prior, params.idepth_min))
    id_max = torch.where(has_prior, mu_prior + params.search_sigma * sigma,
                         torch.full_like(mu_prior, params.idepth_max))
    id_min = torch.clamp(id_min, min=params.idepth_min)
    id_max = torch.clamp(id_max, max=params.idepth_max)
    ok = id_max >= id_min

    start, _ = epipolar.project_idepth(geo, u_ref, id_min)
    end, _ = epipolar.project_idepth(geo, u_ref, id_max)
    epilength = _length(start, end)
    ok = ok & (epilength > 0)
    epi = (end - start) / torch.clamp(epilength, min=1e-12)[..., None]

    cv, start, end = _clip(width, height, start, end)
    ok = ok & cv
    epilength = _length(start, end)
    ok = ok & (epilength > 0)

    pad = torch.clamp((params.epilength_min - epilength) / 2.0, min=0.0)
    start = start - pad[..., None] * epi
    end = end + pad[..., None] * epi
    too_long = epilength > params.epilength_max
    end = torch.where(too_long[..., None],
                      start + params.epilength_max * epi, end)

    cv, start, end = _clip(width, height, start, end)
    return SearchRegion(ok=ok & cv, start=start, end=end, epi=epi)


class SearchResult(NamedTuple):
    status: torch.Tensor  # (N,) int32 filter status codes
    u_cmp: torch.Tensor  # (N, 2) match in img_cmp (padded coordinates)
    residual: torch.Tensor  # (N,)


def _patch_positions(epi_ref, rescale_factor, u_ref_padded):
    """The 5-tap reference-patch positions u_ref_padded + j * epi_ref *
    rescale, j in -2..2: (N, 5, 2)."""
    taps = torch.arange(-2.0, 3.0, device=u_ref_padded.device)
    off = taps[None, :, None] * (epi_ref * rescale_factor[:, None])[:, None]
    return u_ref_padded[:, None, :] + off


def _gate_and_match(params: FilterParams, ref_patch, img_cmp, u_start,
                    u_end, rescale_factor, n_steps: int) -> SearchResult:
    """The patch-gradient gate, the line-stereo match and the status
    mapping, shared by search and search_stacked so that both map
    failures alike."""
    grads = torch.abs(ref_patch[:, 1:] - ref_patch[:, :-1])
    ref_grad_ok = torch.amax(grads, dim=-1) >= params.min_grad_mag
    m = line_stereo.match(ref_patch, img_cmp, u_start, u_end,
                          rescale_factor, params.sparams, n_steps)
    status = torch.where(
        ~ref_grad_ok, FAIL_REF_PATCH_GRADIENT,
        torch.where(m.status == line_stereo.FAIL_AMBIGUOUS_MATCH,
                    FAIL_AMBIGUOUS_MATCH,
                    torch.where(m.status == line_stereo.FAIL_MAX_COST,
                                FAIL_MAX_COST, SUCCESS)))
    return SearchResult(status=status.int(), u_cmp=m.u_cmp,
                        residual=m.residual)


def search(params: FilterParams, geo: epipolar.EpiGeo,
           rescale_factor: torch.Tensor, img_ref: torch.Tensor,
           img_cmp: torch.Tensor, u_ref: torch.Tensor,
           u_ref_padded: torch.Tensor, u_start: torch.Tensor,
           u_end: torch.Tensor, n_steps: int) -> SearchResult:
    """search_stacked for features that share one reference image (H, W)
    and one geometry (reference inverse_depth_filter.cc:184-266). u_ref
    (unpadded) gives the reference epiline direction; u_start / u_end are
    in padded img_cmp coordinates."""
    epi_ref = epipolar.reference_epiline(geo, u_ref)  # (N, 2)
    ppos = _patch_positions(epi_ref, rescale_factor, u_ref_padded)
    ref_patch = interp.bilinear(img_ref, ppos[..., 0], ppos[..., 1])
    return _gate_and_match(params, ref_patch, img_cmp, u_start, u_end,
                           rescale_factor, n_steps)


def search_stacked(params: FilterParams, geo_batch: epipolar.EpiGeo,
                   rescale_factor: torch.Tensor, imgs_ref: torch.Tensor,
                   ref_frame_idx: torch.Tensor, img_cmp: torch.Tensor,
                   u_ref: torch.Tensor, u_ref_padded: torch.Tensor,
                   u_start: torch.Tensor, u_end: torch.Tensor,
                   n_steps: int) -> SearchResult:
    """Sample each feature's 5-tap reference patch from its own anchor
    poseframe in the stack (F, H, W), gate on the patch gradient and run
    the line-stereo match (reference :184-266)."""
    epi_ref = epipolar.reference_epiline(geo_batch, u_ref)  # (N, 2)
    ppos = _patch_positions(epi_ref, rescale_factor, u_ref_padded)
    fidx = ref_frame_idx[:, None].expand(-1, 5)
    ref_patch = interp.bilinear_stack(imgs_ref, fidx, ppos[..., 0],
                                      ppos[..., 1])
    return _gate_and_match(params, ref_patch, img_cmp, u_start, u_end,
                           rescale_factor, n_steps)


def update(mu_pred: torch.Tensor, var_pred: torch.Tensor,
           mu_meas: torch.Tensor, var_meas: torch.Tensor,
           outlier_sigma_thresh: float = 2.0):
    """Gaussian fusion with a chi^2 gate on the predicted variance
    (reference :268-305). Lanes without a valid prior take the raw
    measurement; a NaN prior is accepted, as in the reference."""
    w = var_pred + var_meas
    safe_w = torch.where(w > 0, w, torch.ones_like(w))
    mu_fused = (var_meas * mu_pred + var_pred * mu_meas) / safe_w
    var_fused = (var_pred * var_meas) / safe_w
    first = torch.isnan(mu_pred) | (mu_pred <= 0.0)
    mu_post = torch.where(first, mu_meas, mu_fused)
    var_post = torch.where(first, var_meas, var_fused)
    res = mu_meas - mu_pred
    dist = res * res / torch.where(var_pred > 0, var_pred,
                                   torch.full_like(var_pred, 1e-24))
    ok = first | ~(dist > outlier_sigma_thresh * outlier_sigma_thresh)
    return ok, torch.clamp(mu_post, min=0.0), var_post
