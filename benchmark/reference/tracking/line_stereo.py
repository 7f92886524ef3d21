"""Frozen copy of flame_tpu_torch/stereo/line_stereo.py for the benchmark's
tracking reference: imports rewired, float32 replaced by torch's default
dtype (the reference sets float64, the control bfloat16); the cost of a
step past the segment's end is the largest finite value of that dtype.

Batched epipolar line stereo matching.

Port of flame_tpu/stereo/line_stereo.py (the reference's LSD-SLAM
matcher, line_stereo.h:75-385): the epiline walk becomes a dense
[N_features, N_steps] computation. All samples along each segment are
gathered at once, per-step SSD and consecutive-step cross terms are
reductions over the 5-tap axis, and best/second-best selection, the
ambiguity test and the subpixel zero-crossing step are masked arithmetic.
Steps past the end of a segment cost float32 max.
"""

from __future__ import annotations


import math
from typing import NamedTuple

import torch

from reference.tracking import interp

SUCCESS = 0
FAIL_AMBIGUOUS_MATCH = 1
FAIL_MAX_COST = 2



class MatchResult(NamedTuple):
    status: torch.Tensor  # (N,) int32
    u_cmp: torch.Tensor  # (N, 2) matched pixel in img_cmp coordinates
    residual: torch.Tensor  # (N,) final SSD
    best_idx: torch.Tensor  # (N,) int32 integer step of the best match


def n_steps_for(epilength_max: float, sample_dist: float = 1.0) -> int:
    """Static step-count bound for the longest epiline."""
    return int(math.ceil(epilength_max / sample_dist)) + 2


def _take(arr: torch.Tensor, i: torch.Tensor) -> torch.Tensor:
    return torch.gather(arr, 1, i[:, None])[:, 0]


def match(ref_patch: torch.Tensor, img_cmp: torch.Tensor,
          start: torch.Tensor, end: torch.Tensor,
          rescale_factor: torch.Tensor, params: LineStereoParams,
          n_steps: int) -> MatchResult:
    """Match 5-tap reference patches (N, 5) along segments start->end
    (N, 2) in img_cmp (padded coordinates)."""
    N = ref_patch.shape[0]
    dev = ref_patch.device
    diff = end - start
    length = torch.sqrt(torch.sum(diff * diff, dim=-1))
    inc = diff * (params.sample_dist / torch.clamp(length, min=1e-12))[:, None]

    # Loop-entry condition of the reference walk (line_stereo.h:168-169):
    # continue while the position has not passed `end` in both
    # coordinates; step 0 always runs.
    ks = torch.arange(n_steps, dtype=torch.get_default_dtype(), device=dev)
    pos = start[:, None, :] + ks[None, :, None] * inc[:, None, :]
    past_x = (inc[:, None, 0] < 0) != (pos[:, :, 0] > end[:, None, 0])
    past_y = (inc[:, None, 1] < 0) != (pos[:, :, 1] > end[:, None, 1])
    active = ~(past_x | past_y)
    active[:, 0] = True

    ms = torch.arange(-2, n_steps + 2, dtype=torch.get_default_dtype(),
                      device=dev)
    spos = start[:, None, :] + ms[None, :, None] * inc[:, None, :]
    S = interp.bilinear(img_cmp, spos[..., 0], spos[..., 1])  # (N, S+4)

    windows = torch.stack([S[:, j:j + n_steps] for j in range(5)], dim=-1)
    E = windows - ref_patch[:, None, :]  # (N, S, 5)
    ee = torch.sum(E * E, dim=-1)
    CC = torch.cat([torch.zeros((N, 1), dtype=torch.get_default_dtype(),
                                device=dev),
                    torch.sum(E[:, 1:, :] * E[:, :-1, :], dim=-1)], dim=1)

    big = torch.full_like(ee, torch.finfo(ee.dtype).max)
    ee_masked = torch.where(active, ee, big)
    best = torch.argmin(ee_masked, dim=1)
    best_err = _take(ee_masked, best)
    steps = torch.arange(n_steps, device=dev)[None, :]
    second_masked = torch.where(steps == best[:, None], big, ee_masked)
    second_idx = torch.argmin(second_masked, dim=1)
    second_err = _take(second_masked, second_idx)

    has_pre = best >= 1
    post_step = torch.clamp(best + 1, 0, n_steps - 1)
    has_post = _take(active, post_step) & (best + 1 <= n_steps - 1)
    minus1 = torch.full_like(best_err, -1.0)
    err_pre = torch.where(has_pre, _take(ee, torch.clamp(best - 1, min=0)),
                          minus1)
    diff_err_pre = _take(CC, best)
    err_post = torch.where(has_post, _take(ee, post_step), minus1)
    diff_err_post = _take(CC, post_step)

    fail_max_cost_1 = best_err > 4.0 * params.max_cost
    non_adjacent = torch.abs(best - second_idx) > 1
    fail_ambiguous = non_adjacent & (
        params.second_best_factor * best_err > second_err)

    # Subpixel refinement (line_stereo.h:286-343).
    grad_pre_pre = -(err_pre - diff_err_pre)
    grad_pre_this = best_err - diff_err_pre
    grad_post_this = -(best_err - diff_err_post)
    grad_post_post = err_post - diff_err_post
    oob = (err_pre < 0) | (err_post < 0)
    inconsistent = (grad_post_this < 0) != (grad_pre_this < 0)
    pre_crossing = (grad_pre_pre < 0) != (grad_pre_this < 0)
    post_crossing = (grad_post_post < 0) != (grad_post_this < 0)
    interp_pre = ~oob & ~inconsistent & pre_crossing & ~post_crossing
    interp_post = ~oob & ~inconsistent & ~pre_crossing & post_crossing

    def safe(v):
        return torch.where(torch.abs(v) > 0, v, torch.ones_like(v))

    d_pre = grad_pre_this / safe(grad_pre_this - grad_pre_pre)
    d_post = grad_post_this / safe(grad_post_this - grad_post_post)
    err_sub_pre = best_err - 2 * d_pre * grad_pre_this - \
        (grad_pre_pre - grad_pre_this) * d_pre * d_pre
    err_sub_post = best_err + 2 * d_post * grad_post_this + \
        (grad_post_post - grad_post_this) * d_post * d_post

    best_pos = torch.gather(pos, 1, best[:, None, None].expand(N, 1, 2))[:, 0]
    if params.do_subpixel:
        shift = torch.where(interp_pre[:, None], -d_pre[:, None] * inc,
                            torch.where(interp_post[:, None],
                                        d_post[:, None] * inc,
                                        torch.zeros_like(inc)))
        final_pos = best_pos + shift
        final_err = torch.where(interp_pre, err_sub_pre,
                                torch.where(interp_post, err_sub_post,
                                            best_err))
    else:
        final_pos, final_err = best_pos, best_err

    # Gradient-slack threshold after subpixel (line_stereo.h:347-372).
    sample_dist = params.sample_dist * rescale_factor
    dref = ref_patch[:, 1:] - ref_patch[:, :-1]
    grad_along_line = torch.sum(dref * dref, dim=-1) / torch.clamp(
        sample_dist * sample_dist, min=1e-24)
    fail_max_cost_2 = final_err > params.max_cost + \
        torch.sqrt(grad_along_line) * 20.0

    status = torch.where(
        fail_max_cost_1, FAIL_MAX_COST,
        torch.where(fail_ambiguous, FAIL_AMBIGUOUS_MATCH,
                    torch.where(fail_max_cost_2, FAIL_MAX_COST, SUCCESS)))
    return MatchResult(status=status.int(), u_cmp=final_pos,
                       residual=final_err, best_idx=best.int())
