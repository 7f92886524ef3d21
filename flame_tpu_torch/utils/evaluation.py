"""Trajectory and depth evaluation metrics (a numpy copy of
flame_tpu/utils/evaluation.py).

The benchmark configs (BASELINE.json) measure ATE RMSE on TUM/EuRoC-style
sequences and inverse-depth error against ground truth; these are the
standard implementations (Umeyama similarity alignment as in the TUM
benchmark tooling, plus masked idepth error stats).
"""

from typing import Dict, Optional, Tuple

import numpy as np


def umeyama_alignment(src: np.ndarray, dst: np.ndarray,
                      with_scale: bool = False
                      ) -> Tuple[np.ndarray, np.ndarray, float]:
    """Least-squares similarity transform aligning src -> dst.

    src, dst: (N, 3). Returns (R (3,3), t (3,), s). dst ~ s * R @ src + t.
    """
    src = np.asarray(src, np.float64)
    dst = np.asarray(dst, np.float64)
    mu_s = src.mean(axis=0)
    mu_d = dst.mean(axis=0)
    xs = src - mu_s
    xd = dst - mu_d
    cov = xd.T @ xs / src.shape[0]
    U, D, Vt = np.linalg.svd(cov)
    S = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vt) < 0:
        S[2, 2] = -1
    R = U @ S @ Vt
    if with_scale:
        var_s = (xs ** 2).sum() / src.shape[0]
        s = float(np.trace(np.diag(D) @ S) / max(var_s, 1e-12))
    else:
        s = 1.0
    t = mu_d - s * R @ mu_s
    return R, t, s


def ate_rmse(est_t: np.ndarray, gt_t: np.ndarray, align: bool = True,
             with_scale: bool = False) -> float:
    """Absolute trajectory error RMSE over matched translation sequences
    (the TUM benchmark's evaluate_ate)."""
    est_t = np.asarray(est_t, np.float64)
    gt_t = np.asarray(gt_t, np.float64)
    assert est_t.shape == gt_t.shape
    if align and est_t.shape[0] >= 3:
        R, t, s = umeyama_alignment(est_t, gt_t, with_scale)
        est_t = (s * (R @ est_t.T)).T + t
    err = est_t - gt_t
    return float(np.sqrt((err ** 2).sum(axis=1).mean()))


def depth_error_stats(est_idepth: np.ndarray, gt_idepth: np.ndarray
                      ) -> Dict[str, float]:
    """Masked inverse-depth error statistics between dense maps (NaN =
    no estimate)."""
    est = np.asarray(est_idepth, np.float64)
    gt = np.asarray(gt_idepth, np.float64)
    gt_ok = np.isfinite(gt) & (gt > 0)
    ok = np.isfinite(est) & gt_ok
    if not ok.any():
        return {"coverage": 0.0, "mae": np.inf, "rmse": np.inf,
                "median_rel": np.inf, "mean_rel": np.inf}
    e = est[ok] - gt[ok]
    rel = np.abs(e) / gt[ok]
    return {
        # Fraction of VALID-ground-truth pixels the estimator covered:
        # dividing by all pixels would conflate GT sensor holes with
        # estimator coverage and make cross-sequence numbers track the
        # hole rate instead of the estimator.
        "coverage": float(ok.sum() / gt_ok.sum()),
        "mae": float(np.abs(e).mean()),
        "rmse": float(np.sqrt((e ** 2).mean())),
        "median_rel": float(np.median(rel)),
        "mean_rel": float(rel.mean()),
    }


def pose_errors(est_q: np.ndarray, est_t: np.ndarray,
                gt_q: np.ndarray, gt_t: np.ndarray) -> Dict[str, float]:
    """Per-pose translation/rotation error stats (no alignment)."""
    est_t = np.asarray(est_t, np.float64)
    gt_t = np.asarray(gt_t, np.float64)
    terr = np.linalg.norm(est_t - gt_t, axis=1)
    # Rotation angle of q_err = conj(gt) * est.
    eq = np.asarray(est_q, np.float64)
    gq = np.asarray(gt_q, np.float64)
    dots = np.abs((eq * gq).sum(axis=1))
    ang = 2 * np.arccos(np.clip(dots, 0, 1))
    return {
        "t_rmse": float(np.sqrt((terr ** 2).mean())),
        "t_max": float(terr.max()),
        "r_rmse_deg": float(np.degrees(np.sqrt((ang ** 2).mean()))),
        "r_max_deg": float(np.degrees(ang.max())),
    }
