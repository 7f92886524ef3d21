"""Comparison-poseframe scoring.

Port of flame_tpu/core/keyframe.py, after the reference's
KeyFrameSelector (keyframe_selector.cc:73-255) and getPoseFrame
(flame.cc:775-820). A candidate's score is the orientation term (cos of
the relative angle, hard cutoff at 60 degrees), the overlap of the new
image's frustum with the candidate's image, and a disparity term; a hard
rejection scores float32 lowest.

Where the JAX package vmaps a scalar score over candidates, score_batch
takes the candidates as a leading dimension; best_comparison_pose runs it
on the device inside the detection step. The host half (score,
test_disparity, KeyframeSelector) serves automatic poseframe selection
and API parity: score runs score_batch on CPU float32 tensors, as the JAX
package runs score_jax on its CPU backend; test_disparity and the
selector's relative pose are float64 numpy.
"""

import math

import numpy as np
import torch

from flame_tpu_torch.step_graph import row
from flame_tpu_torch.geometry import se3

SCORE_LOWEST = float(-torch.finfo(torch.float32).max)
CLIP_CAP = 12  # >= 4 corners + one added vertex per rect half-plane clip


def _filled(values, device) -> torch.Tensor:
    """torch.tensor(values, float32) written on the device by fills: a
    CUDA graph's capture admits no copy from host memory."""
    vals = np.asarray(values, np.float32)
    out = torch.empty(vals.shape, dtype=torch.float32, device=device)
    flat = out.view(-1)
    for i, v in enumerate(vals.reshape(-1).tolist()):
        flat[i].fill_(v)
    return out


def _prev_index(n: torch.Tensor, M: int) -> torch.Tensor:
    """(B, M) index of each vertex's predecessor in a polygon of n[b]
    live vertices (the last live one for vertex 0)."""
    idx = torch.arange(M, device=n.device)[None]
    return torch.where(idx == 0, torch.clamp(n - 1, min=0)[:, None], idx - 1)


def _gather_rows(pts: torch.Tensor, index: torch.Tensor) -> torch.Tensor:
    return torch.gather(pts, 1, index[..., None].expand(index.shape + (2,)))


def _clip_halfplane(pts, n, d_s, d_p):
    """One half-plane clip over fixed-capacity polygons.

    pts (B, M, 2) padded polygons with n (B,) live vertices; d_s / d_p
    (B, M) signed distances (>= 0 inside) of each vertex's predecessor and
    of the vertex itself. Returns (pts', n')."""
    B, M, _ = pts.shape
    valid = torch.arange(M, device=pts.device)[None] < n[:, None]
    s = _gather_rows(pts, _prev_index(n, M))
    in_s = d_s >= 0
    in_p = d_p >= 0
    denom = d_s - d_p
    tiny = torch.where(denom < 0, torch.full_like(denom, -1e-12),
                       torch.full_like(denom, 1e-12))
    safe = torch.where(torch.abs(denom) < 1e-12, tiny, denom)
    tt = d_s / safe
    inter = s + tt[..., None] * (pts - s)
    # Per subject edge s->p: emit the crossing point, then p when inside.
    emit_a = valid & (in_s ^ in_p)
    emit_b = valid & in_p
    out_pts = torch.stack([inter, pts], dim=2).reshape(B, 2 * M, 2)
    emit = torch.stack([emit_a, emit_b], dim=2).reshape(B, 2 * M)
    rank = torch.cumsum(emit.long(), dim=1) - 1
    # Unused entries land in the trash row M, cut off below.
    dst = torch.where(emit, torch.clamp(rank, max=M), M)
    res = torch.zeros((B, M + 1, 2), dtype=pts.dtype, device=pts.device)
    res.scatter_(1, dst[..., None].expand(B, 2 * M, 2), out_pts)
    return res[:, :M], emit.long().sum(dim=1)


def _clip_rect_area(poly4, width: float, height: float) -> torch.Tensor:
    """Area of each convex quad (B, 4, 2) clipped to
    [0, width-1] x [0, height-1]."""
    B = poly4.shape[0]
    M = CLIP_CAP
    pts = torch.zeros((B, M, 2), dtype=torch.float32, device=poly4.device)
    pts[:, :4] = poly4
    n = torch.full((B,), 4, dtype=torch.int64, device=poly4.device)
    for sd in (lambda p: p[..., 0],
               lambda p: (width - 1.0) - p[..., 0],
               lambda p: p[..., 1],
               lambda p: (height - 1.0) - p[..., 1]):
        prev = _gather_rows(pts, _prev_index(n, M))
        pts, n = _clip_halfplane(pts, n, sd(prev), sd(pts))
    idx = torch.arange(M, device=poly4.device)[None]
    valid = idx < n[:, None]
    nxt = _gather_rows(pts, torch.where(idx + 1 >= n[:, None],
                                        torch.zeros_like(idx), idx + 1))
    t = pts[..., 0] * nxt[..., 1] - pts[..., 1] * nxt[..., 0]
    return 0.5 * torch.abs(torch.where(valid, t, torch.zeros_like(t))
                           .sum(dim=1))


def score_batch(width: int, height: int, K, Kinv, q_rel, t_rel,
                min_depth: float = 1.0, max_depth: float = 50.0,
                max_disparity: float = 100.0) -> torch.Tensor:
    """Scores of B candidate poses: q_rel (B, 4) wxyz and t_rel (B, 3)
    take new-frame coordinates into each candidate's frame. Float32
    lowest marks a hard rejection (orientation past 60 degrees, an image
    corner behind the candidate, a non-convex or empty overlap, a
    degenerate disparity test point)."""
    dev = q_rel.device
    q_rel = q_rel.float()
    t_rel = t_rel.float()
    K = K.float()
    Kinv = Kinv.float()

    # Orientation score with the 60-degree hard cutoff.
    w = torch.clamp(torch.abs(q_rel[:, 0]), 0.0, 1.0)
    s_orient = 0.5 * (torch.cos(2.0 * torch.arccos(w)) + 1.0)
    ok = s_orient >= 0.5 * (math.cos(math.radians(60.0)) + 1.0)

    # Overlap: the new image's corners at max_depth, in the candidate.
    corners = _filled([[0.0, 0.0, 1.0], [0.0, height - 1.0, 1.0],
                       [width - 1.0, height - 1.0, 1.0],
                       [width - 1.0, 0.0, 1.0]], dev)
    rays = corners @ Kinv.T
    cam = se3.quat_rotate(q_rel[:, None], max_depth * rays) + t_rel[:, None]
    p = cam @ K.T  # (B, 4, 3)
    ok = ok & torch.all(p[..., 2] > 0, dim=1)
    z = torch.where(torch.abs(p[..., 2]) > 1e-12, p[..., 2],
                    torch.full_like(p[..., 2], 1e-12))
    ref_poly = p[..., :2] / z[..., None]

    # Convexity bail-out (keyframe_selector.cc:194-199).
    nxt = torch.roll(ref_poly, -1, dims=1)
    e1 = nxt - ref_poly
    e2 = torch.roll(ref_poly, -2, dims=1) - nxt
    cr = e1[..., 0] * e2[..., 1] - e1[..., 1] * e2[..., 0]
    ok = ok & (torch.all(cr >= -1e-9, dim=1) | torch.all(cr <= 1e-9, dim=1))

    # Wind counter-clockwise for the half-plane clips.
    signed = 0.5 * torch.sum(ref_poly[..., 0] * nxt[..., 1]
                             - ref_poly[..., 1] * nxt[..., 0], dim=1)
    poly = torch.where((signed >= 0)[:, None, None], ref_poly,
                       torch.flip(ref_poly, dims=[1]))
    area = _clip_rect_area(poly, float(width), float(height))
    ok = ok & (area > 0)
    s_overlap = area / ((width - 1.0) * (height - 1.0))

    # Disparity of the test point at min vs infinite depth.
    u = _filled([width / 4.0, height / 4.0, 1.0], dev)
    r = Kinv @ u
    p_inf = se3.quat_rotate(q_rel, r) @ K.T
    p_min = (se3.quat_rotate(q_rel, min_depth * r) + t_rel) @ K.T
    ok = ok & (torch.abs(p_inf[:, 2]) > 1e-12) & (torch.abs(p_min[:, 2])
                                                  > 1e-12)

    def dehom(h):
        zz = torch.where(torch.abs(h[:, 2]) > 1e-12, h[:, 2],
                         torch.full_like(h[:, 2], 1e-12))
        return h[:, :2] / zz[:, None]
    disparity = torch.linalg.norm(dehom(p_min) - dehom(p_inf), dim=1)
    s_disparity = -torch.abs(1.0 - disparity / max_disparity)
    return torch.where(ok, s_orient + s_overlap + s_disparity,
                       torch.full_like(s_orient, SCORE_LOWEST))


def best_comparison_pose(width: int, height: int, K, Kinv, stack_q,
                         stack_t, stack_fid, stack_valid, ref_slot: int,
                         max_pfs: int):
    """Score the max_pfs newest resident poseframes (the reference frame
    itself excluded) against the poseframe at ref_slot. Returns
    (q_cmp, t_cmp, ok) as device tensors; ok is False when no candidate
    survives and the caller falls back to the previous frame. Ties go to
    the lowest slot, as jnp.argmax and torch.argmax both pick the first
    maximum. ref_slot: a Python int, or a (1,) device index under a CUDA
    graph; no value is read on the host."""
    q_ref = row(stack_q, ref_slot)
    t_ref = row(stack_t, ref_slot)
    q_rel, t_rel = se3.mul(se3.inverse((stack_q, stack_t)), (q_ref, t_ref))
    scores = score_batch(width, height, K, Kinv, q_rel, t_rel)

    cand = stack_valid & (stack_fid != row(stack_fid, ref_slot)) \
        & (stack_fid >= 0)
    # Recency rank by frame id: keep the max_pfs newest candidates (the
    # reference walks its id-ordered map backwards).
    newer = (stack_fid[None, :] > stack_fid[:, None]) & cand[None, :]
    recency_rank = (newer & cand[:, None]).sum(dim=1)
    cand = cand & (recency_rank < max_pfs)

    masked = torch.where(cand, scores, torch.full_like(scores, SCORE_LOWEST))
    best = torch.argmax(masked).reshape(1)
    ok = cand.any() & (row(masked, best) > SCORE_LOWEST / 2)
    return row(stack_q, best), row(stack_t, best), ok


def score(width: int, height: int, K, Kinv, q_new_to_ref, t_new_to_ref,
          min_depth: float = 1.0, max_depth: float = 50.0,
          max_disparity: float = 100.0) -> float:
    """Score one candidate reference poseframe for stereo against a new
    frame: q_new_to_ref (wxyz) / t_new_to_ref take new-frame coordinates
    into the candidate's frame. Higher is better; float32 lowest for a
    hard rejection (callers compare against -float32max / 2). score_batch
    of one candidate on the CPU in float32."""
    def f32(a, shape):
        return torch.as_tensor(np.asarray(a, np.float32).reshape(shape))
    s = score_batch(width, height, f32(K, (3, 3)), f32(Kinv, (3, 3)),
                    f32(q_new_to_ref, (1, 4)), f32(t_new_to_ref, (1, 3)),
                    min_depth, max_depth, max_disparity)
    return float(s[0])


def _rotation(q) -> np.ndarray:
    """Rotation matrix of a unit quaternion (wxyz), float64."""
    w, x, y, z = np.asarray(q, np.float64)
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)]])


def test_disparity(K, Kinv, q_rel, t_rel, u_test, depth: float) -> float:
    """Disparity (px) of the test pixel u_test at the given depth against
    infinity under the relative transform (the probe of score()'s
    disparity term, reference keyframe_selector.cc:222-247); +inf on
    degenerate geometry."""
    K = np.asarray(K, np.float64)
    Kinv = np.asarray(Kinv, np.float64)
    R = _rotation(q_rel)
    t = np.asarray(t_rel, np.float64)
    u = np.array([u_test[0], u_test[1], 1.0])
    p_inf = K @ (R @ (Kinv @ u))
    p_d = K @ (R @ (depth * (Kinv @ u)) + t)
    if abs(p_inf[2]) < 1e-12 or abs(p_d[2]) < 1e-12:
        return float("inf")
    return float(np.linalg.norm(p_d[:2] / p_d[2] - p_inf[:2] / p_inf[2]))


class KeyframeSelector:
    """Pool-managing keyframe selection (reference
    KeyFrameSelector::select, keyframe_selector.cc:73-122; the reference's
    own pipeline does not use it, it is kept for API parity).

    select() returns the index into the pool of the best-scoring keyframe
    for the new pose (-1 when the pool is empty) and adds the new frame to
    the pool when it has moved more than new_kf_thresh from the last
    keyframe, evicting the oldest beyond max_kfs. The reference decrements
    the returned index after every addition (keyframe_selector.cc:121);
    here, as in the JAX package, only when an eviction shifted the pool.
    """

    def __init__(self, K, max_kfs: int = 10, new_kf_thresh: float = 0.1):
        self.K = np.asarray(K, np.float64)
        self.Kinv = np.linalg.inv(self.K)
        self.max_kfs = max_kfs
        self.new_kf_thresh = new_kf_thresh
        self.times: list = []
        self.imgs: list = []
        self.poses: list = []  # (q wxyz, t) camera-to-world

    @staticmethod
    def _relative(q_a, t_a, q_b, t_b):
        """The new-to-ref transform T_a^-1 * T_b as float64 (q, t)."""
        R_a = _rotation(q_a)
        R = R_a.T @ _rotation(q_b)
        t = R_a.T @ (np.asarray(t_b, np.float64)
                     - np.asarray(t_a, np.float64))
        # Rotation matrix -> quaternion (wxyz).
        tr = np.trace(R)
        if tr > 0:
            s = 2 * np.sqrt(tr + 1)
            q = np.array([s / 4, (R[2, 1] - R[1, 2]) / s,
                          (R[0, 2] - R[2, 0]) / s, (R[1, 0] - R[0, 1]) / s])
        else:
            i = int(np.argmax(np.diag(R)))
            j, k = (i + 1) % 3, (i + 2) % 3
            s = 2 * np.sqrt(max(1 + R[i, i] - R[j, j] - R[k, k], 1e-12))
            q = np.zeros(4)
            q[0] = (R[k, j] - R[j, k]) / s
            q[1 + i] = s / 4
            q[1 + j] = (R[j, i] + R[i, j]) / s
            q[1 + k] = (R[k, i] + R[i, k]) / s
        return q / np.linalg.norm(q), t

    def select(self, new_time: float, new_img, new_pose) -> int:
        q_new, t_new = new_pose
        h, w = np.asarray(new_img).shape[:2]
        best_idx, best_score = -1, -np.inf
        for i, (q_kf, t_kf) in enumerate(self.poses):
            q_rel, t_rel = self._relative(q_kf, t_kf, q_new, t_new)
            s = score(w, h, self.K, self.Kinv, q_rel, t_rel)
            if s > best_score:
                best_score, best_idx = s, i
        moved = (not self.poses or
                 np.linalg.norm(np.asarray(t_new, np.float64)
                                - np.asarray(self.poses[-1][1], np.float64))
                 > self.new_kf_thresh)
        if moved:
            self.times.append(new_time)
            self.imgs.append(new_img)
            self.poses.append((np.asarray(q_new), np.asarray(t_new)))
            if len(self.times) > self.max_kfs:
                self.times.pop(0)
                self.imgs.pop(0)
                self.poses.pop(0)
                best_idx -= 1
        return best_idx

    def get_keyframe(self, idx: int):
        return self.times[idx], self.imgs[idx], self.poses[idx]
