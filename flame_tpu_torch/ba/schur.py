"""Schur-complement Gauss-Newton solve for the BA window.

Port of flame_tpu/ba/schur.py. The normal equations have the two-block
structure

    [ Hpp  Hpl ] [dx_p]   [ -bp ]
    [ Hpl' Hll ] [dx_l] = [ -bl ]

with scalar landmark blocks (inverse depths), so Hll is diagonal and the
reduced pose system S = Hpp - Hpl Hll^-1 Hpl' is 6P x 6P. Assembly sums
per-observation blocks into their pose and landmark rows (index_add_,
the JAX package's segment sums). The first n_fixed poses are frozen
(gauge: global SE(3) and monocular scale). Products are full float32:
the caller keeps TF32 off, as Flame does.
"""

from typing import NamedTuple, Optional

import torch

from flame_tpu_torch.ba import residuals as resid
from flame_tpu_torch.geometry import se3
from flame_tpu_torch.params import BAParams


class BAProblem(NamedTuple):
    q: torch.Tensor  # (P, 4) window poses (camera-to-world)
    t: torch.Tensor  # (P, 3)
    lm_idepth: torch.Tensor  # (L,)
    lm_valid: torch.Tensor  # (L,) bool
    obs: resid.BAObservations
    prior_q: Optional[torch.Tensor] = None  # (P, 4) pose-prior anchors
    prior_t: Optional[torch.Tensor] = None  # (P, 3)


def _assemble(K, Kinv, q, t, lm_idepth, obs, huber_delta, n_poses: int,
              n_lms: int, sqrtW=None):
    """Normal-equation pieces from all observations."""
    r, Ja, Jo, Jd, w = resid.residuals_and_jacobians(
        K, Kinv, q, t, obs, lm_idepth, huber_delta, sqrtW=sqrtW)
    P, L = n_poses, n_lms
    a, o, lm = obs.anchor_idx, obs.obs_idx, obs.lm_idx
    wr = w[:, None] * r
    Jaw = Ja * w[:, None, None]
    Jow = Jo * w[:, None, None]

    def pp(Jiw, Jj):
        return torch.einsum("mki,mkj->mij", Jiw, Jj)

    z = Ja.new_zeros
    Hpp = (z((P * P, 6, 6)).index_add_(0, a * P + a, pp(Jaw, Ja))
           .index_add_(0, a * P + o, pp(Jaw, Jo))
           .index_add_(0, o * P + a, pp(Jow, Ja))
           .index_add_(0, o * P + o, pp(Jow, Jo))).reshape(P, P, 6, 6)
    bp = z((P, 6)).index_add_(0, a, torch.einsum("mki,mk->mi", Ja, wr)) \
        .index_add_(0, o, torch.einsum("mki,mk->mi", Jo, wr))
    Hll = z(L).index_add_(0, lm, w * torch.sum(Jd * Jd, dim=1))
    bl = z(L).index_add_(0, lm, torch.sum(Jd * wr, dim=1))
    W = (z((P * L, 6)).index_add_(0, a * L + lm,
                                  torch.einsum("mki,mk->mi", Jaw, Jd))
         .index_add_(0, o * L + lm, torch.einsum("mki,mk->mi", Jow, Jd))
         ).reshape(P, L, 6)
    cost = 0.5 * torch.sum(w * torch.sum(r * r, dim=1))
    return Hpp, bp, Hll, bl, W, cost


def _solve_reduced(Hpp, bp, Hll, bl, W, damping, n_fixed, lm_valid):
    """Schur reduction + dense solve + landmark back-substitution."""
    P = bp.shape[0]
    live = (Hll > 1e-12) & lm_valid
    inv_Hll = torch.where(live, 1.0 / torch.where(live, Hll + damping,
                                                  torch.ones_like(Hll)),
                          torch.zeros_like(Hll))
    S = Hpp - torch.einsum("pli,l,qlj->pqij", W, inv_Hll, W)
    rhs = bp - torch.einsum("pli,l,l->pi", W, inv_Hll, bl)
    Sm = S.permute(0, 2, 1, 3).reshape(6 * P, 6 * P)
    rv = rhs.reshape(6 * P)
    # Gauge: freeze the first n_fixed poses (identity rows).
    free = torch.arange(6 * P, device=Sm.device) >= 6 * n_fixed
    Sm = torch.where(free[:, None] & free[None, :], Sm, torch.zeros_like(Sm))
    Sm = Sm + torch.diag(torch.where(free, torch.full_like(rv, damping),
                                     torch.ones_like(rv)))
    rv = torch.where(free, rv, torch.zeros_like(rv))
    # solve_ex: no error check, so no wait for the card (and capturable).
    dx_p = -torch.linalg.solve_ex(Sm, rv)[0].reshape(P, 6)
    # Back-substitute landmarks: dx_l = -inv_Hll (bl + W^T dx_p).
    dx_l = -inv_Hll * (bl + torch.einsum("pli,pi->l", W, dx_p))
    return dx_p, dx_l


def gn_solve(params: BAParams, problem: BAProblem, n_fixed: int, lm_valid,
             assemble):
    """n_gn_iters damped Gauss-Newton iterations with the pose prior, the
    manifold update and the idepth clip [1e-4, 1e3]. assemble(q, t, lm)
    -> (Hpp, bp, Hll, bl, W, cost). Returns (q', t', lm', final_cost)."""
    P = problem.q.shape[0]
    prior_q = problem.prior_q if problem.prior_q is not None else problem.q
    prior_t = problem.prior_t if problem.prior_t is not None else problem.t
    q, t, lm = problem.q, problem.t, problem.lm_idepth
    eye = torch.eye(6, device=q.device)[None, None] \
        * torch.eye(P, device=q.device)[:, :, None, None]
    for _ in range(params.n_gn_iters):
        Hpp, bp, Hll, bl, W, _ = assemble(q, t, lm)
        if params.pose_prior_weight > 0:
            # Prior residual e = log(T_curr * T_prior^-1), identity
            # Jacobian under the left perturbation.
            e = se3.log(se3.mul((q, t), se3.inverse((prior_q, prior_t))))
            wp = params.pose_prior_weight
            bp = bp + wp * e
            Hpp = Hpp + wp * eye
        dx_p, dx_l = _solve_reduced(Hpp, bp, Hll, bl, W, params.damping,
                                    n_fixed, lm_valid)
        q, t = se3.mul(se3.exp(dx_p), (q, t))
        lm = torch.where(lm_valid, torch.clamp(lm + dx_l, 1e-4, 1e3), lm)
    *_, cost = assemble(q, t, lm)
    return q, t, lm, cost


def solve_window(params: BAParams, K, Kinv, problem: BAProblem,
                 n_fixed: int = 2, sqrtW=None):
    """Run n_gn_iters damped Gauss-Newton iterations on the window.
    sqrtW: optional (M, 2, 2) residual whitening. Returns (q', t',
    lm_idepth', final_cost)."""
    P = problem.q.shape[0]
    L = problem.lm_idepth.shape[0]

    def assemble(q, t, lm):
        return _assemble(K, Kinv, q, t, lm, problem.obs, params.huber_delta,
                         P, L, sqrtW=sqrtW)

    return gn_solve(params, problem, n_fixed, problem.lm_valid, assemble)


def window_cost(params: BAParams, K, Kinv, problem: BAProblem):
    P = problem.q.shape[0]
    L = problem.lm_idepth.shape[0]
    *_, cost = _assemble(K, Kinv, problem.q, problem.t, problem.lm_idepth,
                         problem.obs, params.huber_delta, P, L)
    return cost
