"""Frozen copy of flame_tpu_torch/geometry/epipolar.py for the benchmark's
tracking reference: imports rewired, float32 replaced by torch's default
dtype (the reference sets float64, the control bfloat16).

Two-view epipolar geometry: a tuple of cached tensors plus batched queries.

Port of flame_tpu/geometry/epipolar.py. Where the JAX package vmaps a
per-feature geometry, the port carries the batch as a leading dimension
of q_ref_to_cmp, t_ref_to_cmp, t_cmp_to_ref, KRKinv, Kt and epipole (K
and Kinv stay (3, 3)); every query broadcasts a geometry batch of N
against pixel batches of N. Depths live in the reference camera; epilines
point from infinite depth toward minimum depth.
"""

from __future__ import annotations


from typing import NamedTuple

import torch

from reference.tracking import se3


class EpiGeo(NamedTuple):
    K: torch.Tensor  # (3, 3)
    Kinv: torch.Tensor  # (3, 3)
    q_ref_to_cmp: torch.Tensor  # ([N,] 4) wxyz
    t_ref_to_cmp: torch.Tensor  # ([N,] 3)
    t_cmp_to_ref: torch.Tensor  # ([N,] 3)
    KRKinv: torch.Tensor  # ([N,] 3, 3)
    Kt: torch.Tensor  # ([N,] 3)
    epipole: torch.Tensor  # ([N,] 2), valid when t_ref_to_cmp.z > 0


def _nonzero_or_one(v: torch.Tensor) -> torch.Tensor:
    return torch.where(torch.abs(v) > 0, v, torch.ones_like(v))


def _epipole(K, t):
    tz = t[..., 2]
    safe_tz = _nonzero_or_one(tz)
    return torch.stack([(K[0, 0] * t[..., 0] + K[0, 2] * tz) / safe_tz,
                        (K[1, 1] * t[..., 1] + K[1, 2] * tz) / safe_tz],
                       dim=-1)


def load(K, Kinv, q_ref_to_cmp, t_ref_to_cmp) -> EpiGeo:
    """Precompute the cached quantities (epipolar_geometry.h:86-103).
    Full float32: TF32 is off for every matmul of the port."""
    R = se3.quat_to_matrix(q_ref_to_cmp)
    KRKinv = torch.matmul(K, torch.matmul(R, Kinv))
    Kt = torch.matmul(K, t_ref_to_cmp[..., None])[..., 0]
    t_cmp_to_ref = -se3.quat_rotate(se3.quat_conj(q_ref_to_cmp),
                                    t_ref_to_cmp)
    return EpiGeo(K=K, Kinv=Kinv, q_ref_to_cmp=q_ref_to_cmp,
                  t_ref_to_cmp=t_ref_to_cmp, t_cmp_to_ref=t_cmp_to_ref,
                  KRKinv=KRKinv, Kt=Kt, epipole=_epipole(K, t_ref_to_cmp))


def load_relative(K, Kinv, T_ref, T_cmp) -> EpiGeo:
    """Geometry from the world poses of the two cameras."""
    q, t = se3.relative(T_cmp, T_ref)
    return load(K, Kinv, q, t)


def compose(geo2: EpiGeo, geos: EpiGeo) -> EpiGeo:
    """ref->cmp2 from (batched) ref->cmp geometries and ONE cmp->cmp2
    geometry: KRKinv' = KRKinv_2 @ KRKinv, Kt' = KRKinv_2 @ Kt + Kt_2."""
    q = se3.quat_mul(geo2.q_ref_to_cmp, geos.q_ref_to_cmp)
    t = se3.quat_rotate(geo2.q_ref_to_cmp, geos.t_ref_to_cmp) \
        + geo2.t_ref_to_cmp
    KRKinv = torch.matmul(geo2.KRKinv, geos.KRKinv)
    Kt = torch.matmul(geos.Kt, geo2.KRKinv.T) + geo2.Kt
    t_cmp_to_ref = -se3.quat_rotate(se3.quat_conj(q), t)
    return EpiGeo(K=geos.K, Kinv=geos.Kinv, q_ref_to_cmp=q,
                  t_ref_to_cmp=t, t_cmp_to_ref=t_cmp_to_ref,
                  KRKinv=KRKinv, Kt=Kt, epipole=_epipole(geos.K, t))


def select(mask: torch.Tensor, a: EpiGeo, b: EpiGeo) -> EpiGeo:
    """Per-lane choice between a batched geometry a and a single geometry
    b: b where mask (N,) is set (K and Kinv are shared)."""
    def sel(x, y):
        m = mask.reshape(mask.shape + (1,) * (x.dim() - 1))
        return torch.where(m, y.expand_as(x), x)
    return a._replace(**{f: sel(getattr(a, f), getattr(b, f))
                         for f in a._fields[2:]})


def _apply33(M: torch.Tensor, uv: torch.Tensor) -> torch.Tensor:
    x = M[..., 0, 0] * uv[..., 0] + M[..., 0, 1] * uv[..., 1] + M[..., 0, 2]
    y = M[..., 1, 0] * uv[..., 0] + M[..., 1, 1] * uv[..., 1] + M[..., 1, 2]
    w = M[..., 2, 0] * uv[..., 0] + M[..., 2, 1] * uv[..., 1] + M[..., 2, 2]
    return torch.stack([x, y, w], dim=-1)


def max_depth_projection(geo: EpiGeo, u_ref: torch.Tensor) -> torch.Tensor:
    """Projection of u_ref at infinite depth (reference :191-201)."""
    h = _apply33(geo.KRKinv, u_ref)
    return h[..., :2] / h[..., 2:3]


def min_depth_projection(geo: EpiGeo, u_ref: torch.Tensor) -> torch.Tensor:
    """Projection of u_ref at minimum depth (reference :237-263): the
    epipole when tz > 0, a far point along the parallel epiline when
    tz == 0, the point of cmp depth 1 when tz < 0."""
    K, Kinv, t = geo.K, geo.Kinv, geo.t_ref_to_cmp
    tz = t[..., 2]
    u_inf = max_depth_projection(geo, u_ref)

    epi_par = torch.stack([K[0, 0] * t[..., 0], K[1, 1] * t[..., 1]], dim=-1)
    u_par = u_inf + 1e6 * epi_par

    qp_x = Kinv[0, 0] * u_ref[..., 0] + Kinv[0, 2]
    qp_y = Kinv[1, 1] * u_ref[..., 1] + Kinv[1, 2]
    qp = torch.stack([qp_x, qp_y, torch.ones_like(qp_x)], dim=-1)
    qp = se3.quat_rotate(geo.q_ref_to_cmp, qp)
    min_depth = (1.0 - tz) / _nonzero_or_one(qp[..., 2])
    p_cmp = min_depth[..., None] * qp + t
    safe_pz = _nonzero_or_one(p_cmp[..., 2])
    u_neg = torch.stack([
        (K[0, 0] * p_cmp[..., 0] + K[0, 2] * p_cmp[..., 2]) / safe_pz,
        (K[1, 1] * p_cmp[..., 1] + K[1, 2] * p_cmp[..., 2]) / safe_pz,
    ], dim=-1)
    tzb = tz[..., None]
    return torch.where(tzb > 0, geo.epipole.expand_as(u_inf),
                       torch.where(tzb == 0, u_par, u_neg))


def project_idepth(geo: EpiGeo, u_ref: torch.Tensor, idepth: torch.Tensor):
    """Project u_ref into the cmp frame at inverse depth idepth; returns
    (u_cmp (..., 2), idepth in cmp). idepth <= 0 maps to the
    infinite-depth projection with new idepth 0 (reference :153-180)."""
    K, Kinv = geo.K, geo.Kinv
    safe_id = torch.where(idepth > 0, idepth, torch.ones_like(idepth))
    depth = 1.0 / safe_id
    p_ref_x = Kinv[0, 0] * u_ref[..., 0] + Kinv[0, 2]
    p_ref_y = Kinv[1, 1] * u_ref[..., 1] + Kinv[1, 2]
    p_ref = torch.stack([p_ref_x, p_ref_y, torch.ones_like(p_ref_x)],
                        dim=-1) * depth[..., None]
    p_cmp = se3.quat_rotate(geo.q_ref_to_cmp, p_ref) + geo.t_ref_to_cmp
    new_idepth = 1.0 / _nonzero_or_one(p_cmp[..., 2])
    u_cmp = torch.stack([
        (K[0, 0] * p_cmp[..., 0] + K[0, 2] * p_cmp[..., 2]) * new_idepth,
        (K[1, 1] * p_cmp[..., 1] + K[1, 2] * p_cmp[..., 2]) * new_idepth,
    ], dim=-1)
    u_inf = max_depth_projection(geo, u_ref)
    zero = idepth <= 0
    u_out = torch.where(zero[..., None], u_inf, u_cmp)
    id_out = torch.where(zero, torch.zeros_like(new_idepth), new_idepth)
    return u_out, id_out


def epiline(geo: EpiGeo, u_ref: torch.Tensor):
    """(u_inf, unit direction toward minimum depth); zero direction when
    degenerate (reference :282-300)."""
    u_zero = min_depth_projection(geo, u_ref)
    u_inf = max_depth_projection(geo, u_ref)
    epi = u_zero - u_inf
    norm2 = torch.sum(epi * epi, dim=-1, keepdim=True)
    ok = norm2 > 1e-10
    unit = epi / torch.sqrt(torch.where(ok, norm2, torch.ones_like(norm2)))
    return u_inf, torch.where(ok, unit, torch.zeros_like(unit))


def reference_epiline(geo: EpiGeo, u_ref: torch.Tensor) -> torch.Tensor:
    """Unit epiline direction in the reference image at u_ref, from near
    to far depth (reference :311-331)."""
    K, t = geo.K, geo.t_cmp_to_ref
    ex = -K[0, 0] * t[..., 0] + t[..., 2] * (u_ref[..., 0] - K[0, 2])
    ey = -K[1, 1] * t[..., 1] + t[..., 2] * (u_ref[..., 1] - K[1, 2])
    e = torch.stack([ex, ey], dim=-1)
    n2 = torch.sum(e * e, dim=-1, keepdim=True)
    return e / torch.sqrt(torch.clamp(n2, min=1e-24))


def disparity(geo: EpiGeo, u_ref: torch.Tensor, u_cmp: torch.Tensor):
    """Signed disparity along the epiline: (disp, u_inf, epi_unit)."""
    u_inf, epi = epiline(geo, u_ref)
    return torch.sum(epi * (u_cmp - u_inf), dim=-1), u_inf, epi


def disparity_to_idepth(geo: EpiGeo, u_ref, u_inf, epi, disp):
    """Reference-frame inverse depth from disparity, by 1-D least squares
    (reference :392-407)."""
    M, Kt = geo.KRKinv, geo.Kt
    w = M[..., 2, 0] * u_ref[..., 0] + M[..., 2, 1] * u_ref[..., 1] \
        + M[..., 2, 2]
    u_d = u_inf + disp[..., None] * epi
    A = torch.stack([Kt[..., 0] - Kt[..., 2] * u_d[..., 0],
                     Kt[..., 1] - Kt[..., 2] * u_d[..., 1]], dim=-1)
    b = (w * disp)[..., None] * epi
    return torch.sum(A * b, dim=-1) / torch.clamp(
        torch.sum(A * A, dim=-1), min=1e-24)


def disparity_to_depth(geo: EpiGeo, u_ref, u_inf, epi, disp):
    """Depth from disparity (reference :365-379)."""
    M, Kt = geo.KRKinv, geo.Kt
    w = M[..., 2, 0] * u_ref[..., 0] + M[..., 2, 1] * u_ref[..., 1] \
        + M[..., 2, 2]
    u_d = u_inf + disp[..., None] * epi
    A = (w * disp)[..., None] * epi
    b = torch.stack([Kt[..., 0] - Kt[..., 2] * u_d[..., 0],
                     Kt[..., 1] - Kt[..., 2] * u_d[..., 1]], dim=-1)
    return torch.sum(A * b, dim=-1) / torch.clamp(
        torch.sum(A * A, dim=-1), min=1e-24)
