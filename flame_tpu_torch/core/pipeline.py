"""Per-frame pipeline steps over fixed-capacity state.

Port of the single-device parts of flame_tpu/core/pipeline.py
(reference flame.cc: updateFeatureIDepths :1280-1534, trackFeature
:1536-1752, projectFeatures :1754-1860, projectGraph :1862-1938,
syncGraph :1940-2188, prunePoseFrames :554-706), the batched step of the
throughput path and bundle adjustment's widened transfer included.
Feature slot i is graph vertex slot i. Functions are plain torch on
whatever device the state lives on; the JAX package's vmaps are a leading
feature dimension here.
"""

import contextlib
import dataclasses
from dataclasses import dataclass, replace
from typing import NamedTuple

import numpy as np
import torch

from flame_tpu_torch import step_graph
from flame_tpu_torch.core import detection, keyframe
from flame_tpu_torch.core import frame as frame_mod
from flame_tpu_torch.core.frame import Frame, FrameStack
from flame_tpu_torch.geometry import epipolar, se3
from flame_tpu_torch.mesh import filters as mesh_filters
from flame_tpu_torch.ops import raster_kernel
from flame_tpu_torch.optimize import nltgv2, smoother_kernel
from flame_tpu_torch.optimize import topology as topo_mod
from flame_tpu_torch.parallel import halo, halo_kernel, sharding
from flame_tpu_torch.params import Params
from flame_tpu_torch.stereo import filter as idfilter
from flame_tpu_torch.stereo import line_stereo, meas_model

# Failure-type counter indices (reference flame.cc:1301-1305, 1498-1504).
STAT_UPDATES = 0
STAT_FAIL_MAX_VAR = 1
STAT_FAIL_MAX_DROPOUTS = 2
STAT_FAIL_REF_PATCH = 3
STAT_FAIL_AMBIGUOUS = 4
STAT_FAIL_MAX_COST = 5
N_STATS = 6

# Packed snapshot: [x*32, y*32, flags] u16 per feature (1/32 px, < 2048 px).
PACK_XY_SCALE = 32.0
PACK_MEMBER = 1
PACK_CURR_VALID = 2
PACK_FEAT_VALID = 4


@dataclass
class FeatureState:
    """Per-feature filter state [N] (reference FeatureWithIDepth)."""

    xy: torch.Tensor  # (N, 2) position in the anchor poseframe
    pf_slot: torch.Tensor  # (N,) int64 anchor poseframe slot
    idepth_mu: torch.Tensor  # (N,)
    idepth_var: torch.Tensor  # (N,)
    valid: torch.Tensor  # (N,) bool
    num_updates: torch.Tensor  # (N,) int32
    num_dropouts: torch.Tensor  # (N,) int32
    search_status: torch.Tensor  # (N,) int32 last failure taxonomy
    feat_id: torch.Tensor  # (N,) int32 globally unique id

    def replace(self, **kw) -> "FeatureState":
        return replace(self, **kw)


@dataclass
class CurrFeatures:
    """Features projected into the current frame [N]."""

    xy: torch.Tensor  # (N, 2)
    idepth: torch.Tensor  # (N,)
    var: torch.Tensor  # (N,)
    valid: torch.Tensor  # (N,) bool


class TrackObs(NamedTuple):
    success: torch.Tensor  # (N,) bool
    u_ref: torch.Tensor  # (N, 2) anchor-frame pixel
    u_obs: torch.Tensor  # (N, 2) matched pixel in the new frame
    idepth: torch.Tensor  # (N,)
    var: torch.Tensor  # (N,)


def empty_features(capacity: int, device) -> FeatureState:
    N = capacity

    def z(*shape, dtype=torch.float32):
        return torch.zeros(shape, dtype=dtype, device=device)
    return FeatureState(
        xy=z(N, 2), pf_slot=z(N, dtype=torch.int64), idepth_mu=z(N),
        idepth_var=z(N), valid=z(N, dtype=torch.bool),
        num_updates=z(N, dtype=torch.int32),
        num_dropouts=z(N, dtype=torch.int32),
        search_status=z(N, dtype=torch.int32),
        feat_id=torch.full((N,), -1, dtype=torch.int32, device=device))


def empty_curr(capacity: int, device) -> CurrFeatures:
    z = torch.zeros(capacity, dtype=torch.float32, device=device)
    return CurrFeatures(xy=torch.zeros((capacity, 2), device=device),
                        idepth=z, var=z.clone(),
                        valid=torch.zeros(capacity, dtype=torch.bool,
                                          device=device))


def _feature_geos(K, Kinv, stack: FrameStack, feats: FeatureState, q_new,
                  t_new) -> epipolar.EpiGeo:
    """Per-feature anchor->new geometries (leading dim N)."""
    qa = stack.q[feats.pf_slot]
    ta = stack.t[feats.pf_slot]
    q_rel, t_rel = se3.mul(se3.inverse((q_new, t_new)), (qa, ta))
    return epipolar.load(K, Kinv, q_rel, t_rel)


def _feature_tensors(feats: FeatureState) -> list:
    return [getattr(feats, f.name) for f in dataclasses.fields(feats)]


def track_project_sync(params: Params, K, Kinv, stack: FrameStack,
                       feats: FeatureState, fnew: Frame, curr_pf_slot: int):
    """Track -> measure -> fuse -> project -> graph-membership gate over
    all feature slots. Returns (feats', curr, member (N,) bool, stats
    (N_STATS,) int32, obs). On a CUDA device the step replays a CUDA
    graph of _track_project_sync (flame_tpu_torch/step_graph.py); the
    returned tensors are the caller's own."""
    def eager():
        return _track_project_sync(params, K, Kinv, stack, feats, fnew,
                                   curr_pf_slot)

    def body(ins, scalars):
        f = Frame(frame_id=-1, q=ins[12], t=ins[13], img=None,
                  img_pad=ins[9], gradx=ins[10], grady=ins[11])
        return _track_project_sync(params, K, Kinv, stack,
                                   FeatureState(*ins[:9]), f, scalars[0])
    steps = step_graph.steps_for(stack)
    if steps is None:
        return eager()
    return steps.run(
        "track", body,
        _feature_tensors(feats) + [fnew.img_pad, fnew.gradx, fnew.grady,
                                   fnew.q, fnew.t],
        (curr_pf_slot,), params, (K, Kinv, *_feature_tensors(stack)), eager)


def _track_project_sync(params: Params, K, Kinv, stack: FrameStack,
                        feats: FeatureState, fnew: Frame, curr_pf_slot):
    """track_project_sync's body; curr_pf_slot: a Python int, or a (1,)
    int64 device index under a graph."""
    H, W = fnew.gradx.shape
    pad = (fnew.img_pad.shape[0] - H) // 2
    fp = params.fparams
    border = params.border
    row_offset = H // 3 if params.detection.do_letterbox else 0
    n_steps = line_stereo.n_steps_for(fp.epilength_max,
                                      fp.sparams.sample_dist)
    q_new, t_new = fnew.q, fnew.t
    geos = _feature_geos(K, Kinv, stack, feats, q_new, t_new)

    def vr_contains(xy):
        return ((xy[..., 0] >= border) & (xy[..., 0] < W - border)
                & (xy[..., 1] >= border + row_offset)
                & (xy[..., 1] < H - border - row_offset))

    def nz(v):  # v where nonzero-positive, else 1 (safe divisor)
        return torch.where(v > 0, v, torch.ones_like(v))

    alive = feats.valid
    mu0 = feats.idepth_mu

    # Baseline gate (flame.cc:1319-1324): skip, not a failure.
    baseline = torch.linalg.norm(geos.t_ref_to_cmp, dim=-1)
    do_track = alive & (baseline >= params.min_baseline)

    ok_pred, _, mu_pred, _ = idfilter.predict(
        geos, fp.process_var_factor, feats.xy, mu0, feats.idepth_var)

    # Rescale factor (flame.cc:1583-1659): an out-of-range warp moves the
    # feature to the current poseframe and fails the track.
    rescale = torch.where((mu0 > 0) & (mu_pred > 0), mu_pred / nz(mu0),
                          torch.ones_like(mu0))
    bad_rescale = (rescale <= params.rescale_factor_min) | \
        (rescale >= params.rescale_factor_max)

    q_pf = step_graph.row(stack.q, curr_pf_slot)
    t_pf = step_graph.row(stack.t, curr_pf_slot)
    geo_n2pf = epipolar.load(K, Kinv, *se3.mul(se3.inverse((q_pf, t_pf)),
                                               (q_new, t_new)))
    geos_mv = epipolar.compose(geo_n2pf, geos)
    ok_mv, u_pf, id_pf, _ = idfilter.predict(
        geos_mv, fp.process_var_factor, feats.xy, mu0, feats.idepth_var)
    mv_in = vr_contains(u_pf)
    do_move = do_track & ok_pred & bad_rescale
    move_ok = do_move & ok_mv & mv_in
    move_fail = do_move & ~(ok_mv & mv_in)

    nonzero = torch.abs(mu0) > 0
    ratio_mv = torch.where(
        nonzero, id_pf / torch.where(nonzero, mu0, torch.ones_like(mu0)),
        torch.ones_like(mu0))
    vf4_mv = torch.where(id_pf < 1e-6, torch.ones_like(ratio_mv),
                         ratio_mv ** 4)
    new_xy = torch.where(move_ok[:, None], u_pf, feats.xy)
    new_pf_slot = torch.where(move_ok, curr_pf_slot, feats.pf_slot)
    new_mu = torch.where(move_ok, id_pf, mu0)
    new_var = torch.where(move_ok, feats.idepth_var * vf4_mv,
                          feats.idepth_var)

    # Search region with the pre-update prior (flame.cc:1661-1675).
    attempt = do_track & ok_pred & ~bad_rescale
    reg = idfilter.get_search_region(fp, geos, W, H, feats.xy, mu0,
                                     feats.idepth_var)
    attempt = attempt & reg.ok & vr_contains(feats.xy)

    off = float(pad)
    sres = idfilter.search_stacked(
        fp, geos, rescale, stack.img_pad, feats.pf_slot, fnew.img_pad,
        feats.xy, feats.xy + off, reg.start + off, reg.end + off, n_steps)
    flow = sres.u_cmp - off
    search_ok = attempt & (sres.status == idfilter.SUCCESS)

    ok_meas, mu_meas, var_meas = meas_model.idepth_measurement(
        params.zparams, geos, fnew.gradx, fnew.grady, feats.xy, flow)
    ok_fuse, mu_post, var_post = idfilter.update(
        new_mu, new_var, mu_meas, var_meas, params.outlier_sigma_thresh)

    success = search_ok & ok_meas & ok_fuse
    attempted = do_track & ok_pred
    failed = (do_track & ~ok_pred) | (attempted & ~success)
    if params.do_meas_fusion:
        mu_succ, var_succ = mu_post, var_post
    else:
        mu_succ, var_succ = mu_meas, var_meas
    out_mu = torch.where(success, mu_succ, new_mu)
    out_var = torch.where(success, var_succ,
                          torch.where(failed,
                                      new_var * fp.process_fail_var_factor,
                                      new_var))
    fail_max_var = failed & (out_var > params.idepth_var_max)
    out_dropouts = torch.where(
        success, torch.zeros_like(feats.num_dropouts),
        torch.where(failed, feats.num_dropouts + 1, feats.num_dropouts))
    fail_max_drop = failed & (out_dropouts > params.max_dropouts)
    out_valid = alive & ~move_fail & ~fail_max_var & ~fail_max_drop
    out_updates = torch.where(success, feats.num_updates + 1,
                              feats.num_updates)
    out_status = torch.where(attempt, sres.status, feats.search_status)

    # Project into the current frame (flame.cc:1754-1860); moved lanes
    # are anchored in curr_pf, so they take the single pf->new geometry.
    geo_pf2new = epipolar.load(K, Kinv, *se3.mul(se3.inverse((q_new, t_new)),
                                                 (q_pf, t_pf)))
    geos2 = epipolar.select(move_ok, geos, geo_pf2new)
    xy_cur, id_cur = epipolar.project_idepth(geos2, new_xy, out_mu)
    proj_ok = vr_contains(xy_cur) & (id_cur >= 0)
    ratio_c = torch.where(out_mu > 0, id_cur / nz(out_mu),
                          torch.ones_like(out_mu))
    vf4_c = torch.where(id_cur < 1e-6, torch.ones_like(ratio_c),
                        ratio_c ** 4)
    final_valid = out_valid & proj_ok
    feats3 = FeatureState(
        xy=new_xy, pf_slot=new_pf_slot, idepth_mu=out_mu,
        idepth_var=out_var, valid=final_valid,
        num_updates=out_updates.int(), num_dropouts=out_dropouts.int(),
        search_status=out_status.int(), feat_id=feats.feat_id)
    curr = CurrFeatures(xy=xy_cur, idepth=id_cur, var=vf4_c * out_var,
                        valid=final_valid)

    # Graph membership (flame.cc:1956-1980): variance below the graph
    # threshold and world height within bounds; idepth <= 0 is at
    # infinity and fails the height gate.
    qf = stack.q[new_pf_slot]
    tf = stack.t[new_pf_slot]
    rx = Kinv[0, 0] * new_xy[:, 0] + Kinv[0, 2]
    ry = Kinv[1, 1] * new_xy[:, 1] + Kinv[1, 2]
    ray = torch.stack([rx, ry, torch.ones_like(rx)], dim=-1)
    depth = torch.where(out_mu > 0, 1.0 / nz(out_mu),
                        torch.full_like(out_mu, float("inf")))
    p_world = se3.quat_rotate(qf, ray * depth[:, None]) + tf
    height_ok = ((-p_world[:, 1] >= params.min_height)
                 & (-p_world[:, 1] <= params.max_height))
    member = final_valid & (out_var < params.idepth_var_max_graph) \
        & height_ok
    if params.do_grad_check_after_projection:
        from flame_tpu_torch.ops import interp
        gx = interp.bilinear(fnew.gradx, xy_cur[:, 0], xy_cur[:, 1])
        gy = interp.bilinear(fnew.grady, xy_cur[:, 0], xy_cur[:, 1])
        member = member & (gx * gx + gy * gy
                           >= params.min_grad_mag * params.min_grad_mag)

    stats = torch.stack([
        success.sum(), fail_max_var.sum(), fail_max_drop.sum(),
        (attempt & (sres.status == idfilter.FAIL_REF_PATCH_GRADIENT)).sum(),
        (attempt & (sres.status == idfilter.FAIL_AMBIGUOUS_MATCH)).sum(),
        (attempt & (sres.status == idfilter.FAIL_MAX_COST)).sum()]).int()
    obs = TrackObs(success=success & final_valid, u_ref=new_xy, u_obs=flow,
                   idepth=out_mu, var=out_var)
    return feats3, curr, member, stats, obs


def insert_detections(params: Params, feats: FeatureState,
                      det_out: torch.Tensor, pf_slot: int,
                      seed_map: torch.Tensor, id_base: int) -> FeatureState:
    """Insert detection winners into free feature slots: the r-th winner
    takes the r-th free slot (reference flame.cc:737-757). New features
    seed from seed_map (NaN -> idepth_init); winner r gets id id_base+r.
    pf_slot and id_base: Python ints, or (1,) device scalars under a
    graph."""
    N = feats.valid.shape[0]
    C = det_out.shape[0]
    dev = det_out.device
    take = det_out[:, 2] > 0
    xy = det_out[:, :2]
    free = ~feats.valid
    frank = torch.cumsum(free.long(), 0) - 1
    n_free = frank[-1] + 1
    table = torch.zeros(N + 1, dtype=torch.int64, device=dev)
    table[torch.where(free, frank, N)] = torch.arange(N, device=dev)
    wrank = torch.cumsum(take.long(), 0) - 1
    use = take & (wrank < n_free)
    slot = torch.where(use, table[torch.clamp(wrank, 0, N - 1)], N)

    H, W = seed_map.shape
    xi = torch.clamp(torch.floor(xy[:, 0] + 0.5).long(), 0, W - 1)
    yi = torch.clamp(torch.floor(xy[:, 1] + 0.5).long(), 0, H - 1)
    seed = seed_map[yi, xi]
    mu = torch.where(torch.isnan(seed),
                     torch.full_like(seed, params.idepth_init), seed)

    def scat(arr, vals):  # unused rows go to the dropped row N
        buf = torch.cat([arr, arr[:1]], dim=0)
        buf[slot] = vals.to(arr.dtype)
        return buf[:N]

    zc = torch.zeros(C, dtype=torch.int32, device=dev)
    return FeatureState(
        xy=scat(feats.xy, xy),
        pf_slot=scat(feats.pf_slot, step_graph.full(C, pf_slot,
                                                    torch.int64, dev)),
        idepth_mu=scat(feats.idepth_mu, mu),
        idepth_var=scat(feats.idepth_var,
                        torch.full((C,), params.idepth_var_init,
                                   device=dev)),
        valid=scat(feats.valid, torch.ones(C, dtype=torch.bool,
                                           device=dev)),
        num_updates=scat(feats.num_updates, zc),
        num_dropouts=scat(feats.num_dropouts, zc),
        search_status=scat(feats.search_status, zc),
        feat_id=scat(feats.feat_id, id_base + torch.arange(
            C, dtype=torch.int32, device=dev)))


def _detect(params: Params, K, Kinv, stack: FrameStack, pf_slot: int,
            cmp_q, cmp_t, curr_xy, curr_valid) -> torch.Tensor:
    H = stack.gradx.shape[1]
    row_offset = H // 3 if params.detection.do_letterbox else 0
    row = step_graph.row
    geo = epipolar.load_relative(K, Kinv, (row(stack.q, pf_slot),
                                           row(stack.t, pf_slot)),
                                 (cmp_q, cmp_t))
    return detection.detect_packed(
        geo, row(stack.gradx, pf_slot), row(stack.grady, pf_slot), curr_xy,
        curr_valid, params.detection.min_grad_mag,
        params.detection.win_size, params.border, row_offset)


def _detect_and_insert(params: Params, K, Kinv, stack: FrameStack,
                       curr_pf_slot: int, feats3: FeatureState,
                       curr: CurrFeatures, prev_q, prev_t, id_base: int,
                       seed_map) -> FeatureState:
    """Poseframe detection + insertion. With photo_error_num_pfs > 0 the
    epipolar direction comes from the best-scoring past poseframe
    (keyframe.best_comparison_pose, reference getPoseFrame
    flame.cc:775-820), else, or when no candidate survives, from the
    previous frame. The choice stays on the device. On a CUDA device the
    step replays a CUDA graph of _detect_and_insert_body, as
    track_project_sync does."""
    def eager():
        return _detect_and_insert_body(params, K, Kinv, stack, curr_pf_slot,
                                       feats3, curr.xy, curr.valid, prev_q,
                                       prev_t, id_base, seed_map)

    def body(ins, scalars):
        return _detect_and_insert_body(
            params, K, Kinv, stack, scalars[0], FeatureState(*ins[:9]),
            ins[9], ins[10], ins[11], ins[12], scalars[1], ins[13])
    steps = step_graph.steps_for(stack)
    if steps is None:
        return eager()
    return steps.run(
        "detect", body,
        _feature_tensors(feats3) + [curr.xy, curr.valid, prev_q, prev_t,
                                    seed_map],
        (curr_pf_slot, id_base), params, (K, Kinv, *_feature_tensors(stack)),
        eager)


def _detect_and_insert_body(params: Params, K, Kinv, stack: FrameStack,
                            curr_pf_slot, feats3: FeatureState, curr_xy,
                            curr_valid, prev_q, prev_t, id_base,
                            seed_map) -> FeatureState:
    """_detect_and_insert's body; curr_pf_slot and id_base: Python ints,
    or (1,) int64 device scalars under a graph."""
    cmp_q, cmp_t = prev_q, prev_t
    if params.photo_error_num_pfs > 0:
        H, W = stack.gradx.shape[1:]
        cq, ct, cok = keyframe.best_comparison_pose(
            W, H, K, Kinv, stack.q, stack.t, stack.frame_id, stack.valid,
            curr_pf_slot, params.photo_error_num_pfs)
        cmp_q = torch.where(cok, cq, prev_q)
        cmp_t = torch.where(cok, ct, prev_t)
    det_out = _detect(params, K, Kinv, stack, curr_pf_slot, cmp_q, cmp_t,
                      curr_xy, curr_valid)
    return insert_detections(params, feats3, det_out, curr_pf_slot,
                             seed_map, id_base)


def pack_track_outputs(feats: FeatureState, curr: CurrFeatures,
                       member) -> torch.Tensor:
    """The (N, 3) per-feature [x*32, y*32, flags] snapshot the host
    triangulates (as uint16 values, held in int32: torch has no uint16
    arithmetic)."""
    def fx(v):
        return torch.clamp(v * PACK_XY_SCALE + 0.5, 0, 65535).int()
    flags = (member.int() * PACK_MEMBER
             | curr.valid.int() * PACK_CURR_VALID
             | feats.valid.int() * PACK_FEAT_VALID)
    return torch.stack([fx(curr.xy[:, 0]), fx(curr.xy[:, 1]), flags], dim=1)


# Sentinel u_obs.x of a failed match in the BA section of the packed
# transfer (valid coordinates clip to 65534).
PACK_BA_FAIL = 0xFFFF


def _u16_pairs(a: torch.Tensor) -> torch.Tensor:
    """Values in [0, 65535], taken in pairs (lo, hi) along the flattened
    order, as the int32 words whose little-endian u16 halves they are."""
    a = a.reshape(-1, 2).long()
    hi = a[:, 1]
    return (a[:, 0] + torch.where(hi >= 32768, hi - 65536, hi) * 65536).int()


def _f32_words(a: torch.Tensor) -> torch.Tensor:
    return a.reshape(-1).float().contiguous().view(torch.int32)


def pack_ba_outputs(params: Params, packed: torch.Tensor, obs: TrackObs,
                    feats: FeatureState, stack: FrameStack) -> torch.Tensor:
    """The packed track transfer widened with what the BA host layer needs,
    as one flat int32 tensor (flame_tpu/core/pipeline.py::pack_ba_outputs):

      [ packed u16 (N, 3)        : 3N/2 words
      | u_obs u16 (B, N, 2)      : BN   x, y at 1/32 px; x == PACK_BA_FAIL
                                        marks a failed match
      | feats.xy u16 (N, 2)      : N    the anchor pixels (u_ref)
      | idepth_mu f32 (N,)       : N
      | id_slot (N,)             : N    pf_slot << 24 | feat_id mod 2^24
      | stack.frame_id (P,)      : P
      | stack.q f32 (P, 4)       : 4P
      | stack.t f32 (P, 3)       : 3P ]

    obs: one frame's TrackObs, or B frames' stacked on a leading axis.
    Everything but u_obs is the state after the dispatch, u_ref included:
    a feature re-anchored mid-batch pairs the earlier frames' matches with
    its new anchor's id and pixel. Needs N even and poseframe_capacity
    <= 128 (Flame checks both). ba.window.split_packed decodes it."""
    u_obs = obs.u_obs if obs.u_obs.dim() == 3 else obs.u_obs[None]
    success = obs.success if obs.success.dim() == 2 else obs.success[None]

    def fx(v):
        return torch.clamp(torch.nan_to_num(v, nan=0.0) * PACK_XY_SCALE
                           + 0.5, 0, 65534).long()
    uox = torch.where(success, fx(u_obs[..., 0]),
                      torch.full_like(success, PACK_BA_FAIL, dtype=torch.long))
    uo = torch.stack([uox, fx(u_obs[..., 1])], dim=-1)
    xy = torch.stack([fx(feats.xy[:, 0]), fx(feats.xy[:, 1])], dim=-1)
    id_slot = (feats.pf_slot.int() << 24) | (feats.feat_id.int() & 0xFFFFFF)
    return torch.cat([_u16_pairs(packed), _u16_pairs(uo), _u16_pairs(xy),
                      _f32_words(feats.idepth_mu), id_slot,
                      stack.frame_id.int(), _f32_words(stack.q),
                      _f32_words(stack.t)])


def track_step(params: Params, K, Kinv, stack: FrameStack,
               feats: FeatureState, fnew: Frame, curr_pf_slot: int,
               prev_q, prev_t, do_detect: bool, id_base: int, seed_map,
               mesh=None):
    """track_project_sync + (poseframe) detection + packing (widened by
    pack_ba_outputs under do_ba).

    Over a process group (mesh, sharding.grouped) feats is this rank's
    block and so is the returned feats': tracking runs on the block;
    insertion into free slots needs the whole occupancy, so detection
    and insertion run on the gathered state on every rank, which keeps
    its own rows; the snapshot is packed from the blocks gathered again,
    so that every rank packs the owners' rows bit for bit. curr, member,
    obs and packed come back whole, stats summed over the group."""
    feats3, curr, member, stats, obs = track_project_sync(
        params, K, Kinv, stack, feats, fnew, curr_pf_slot)
    feats_w = feats3
    if sharding.grouped(mesh):
        stats = sharding.psum([stats], mesh)
        if do_detect:
            whole, curr_w = sharding.gather_rows(mesh, feats3, curr)
            feats3 = sharding.shard_rows(_detect_and_insert(
                params, K, Kinv, stack, curr_pf_slot, whole, curr_w, prev_q,
                prev_t, id_base, seed_map), mesh)
        feats_w, curr, member, *rest = sharding.gather_rows(
            mesh, feats3, curr, member, *((obs,) if params.do_ba else ()))
        obs = rest[0] if rest else obs
    elif do_detect:
        feats3 = feats_w = _detect_and_insert(
            params, K, Kinv, stack, curr_pf_slot, feats3, curr, prev_q,
            prev_t, id_base, seed_map)
    packed = pack_track_outputs(feats_w, curr, member)
    if params.do_ba:
        packed = pack_ba_outputs(params, packed, obs, feats_w, stack)
    return feats3, curr, member, stats, obs, packed


def frame_track_step(params: Params, K, Kinv, stack: FrameStack,
                     feats: FeatureState, img, frame_id: int, q, t,
                     curr_pf_slot: int, prev_q, prev_t, id_base: int,
                     seed_map, do_detect: bool, do_insert: bool):
    """Steady-state frame: creation, optional poseframe insertion (in
    place) and track_step. Returns (fnew, feats', curr, member, stats,
    obs, packed)."""
    fnew = frame_mod.create(frame_id, q, t, img, params.pad)
    if do_insert:
        frame_mod.insert(stack, curr_pf_slot, fnew)
    return (fnew,) + track_step(params, K, Kinv, stack, feats, fnew,
                                curr_pf_slot, prev_q, prev_t, do_detect,
                                id_base, seed_map)


def bootstrap_detect(params: Params, K, Kinv, stack: FrameStack,
                     feats: FeatureState, prev_q, prev_t, pf_slot: int,
                     seed_map, id_base: int, curr_xy, curr_valid):
    """First-poseframe detection + insertion (reference flame.cc:174-242)."""
    det_out = _detect(params, K, Kinv, stack, pf_slot, prev_q, prev_t,
                      curr_xy, curr_valid)
    feats2 = insert_detections(params, feats, det_out, pf_slot, seed_map,
                               id_base)
    return feats2, feats2.valid


def _graph_sync_inner(params: Params, graph: nltgv2.GraphState,
                      prev_in_graph, member, curr: CurrFeatures,
                      geo_prev_to_new: epipolar.EpiGeo, graph_scale,
                      topo: topo_mod.Topology, prev_idepthmap=None):
    """Synchronize the solver graph with the tracked features (reference
    projectGraph flame.cc:1862-1938 + syncGraph :1940-2163)."""
    zero = torch.zeros_like(graph.x)
    _, id_new = epipolar.project_idepth(geo_prev_to_new, graph.pos,
                                        graph.x * graph_scale)
    x_surv = torch.where(prev_in_graph, id_new / graph_scale, graph.x)
    new_member = member & ~prev_in_graph
    data_term = curr.idepth / graph_scale
    if params.adaptive_data_weights:
        w = 1.0 / torch.clamp(curr.var, min=1e-12)
    else:
        w = torch.ones_like(curr.var)
    weight = torch.where(member, w, zero)
    if params.rescale_data:
        weight = weight * graph_scale

    if params.init_with_prediction and prev_idepthmap is not None:
        # New vertices start from the previous dense map; where it is NaN,
        # from the mean of their surviving neighbours, then the data term
        # (reference flame.cc:2132-2158).
        H, W = prev_idepthmap.shape
        xi = torch.clamp(torch.floor(curr.xy[:, 0] + 0.5).long(), 0, W - 1)
        yi = torch.clamp(torch.floor(curr.xy[:, 1] + 0.5).long(), 0, H - 1)
        pred = prev_idepthmap[yi, xi] / graph_scale
        lo = topo.edges[:, 0]
        hi = topo.edges[:, 1]
        good = prev_in_graph & member
        w_lo = (topo.edge_mask & good[hi]).float()
        w_hi = (topo.edge_mask & good[lo]).float()
        num = zero.clone().index_add_(0, lo, w_lo * x_surv[hi]) \
            .index_add_(0, hi, w_hi * x_surv[lo])
        den = zero.clone().index_add_(0, lo, w_lo).index_add_(0, hi, w_hi)
        fallback = torch.where(den > 0, num / torch.clamp(den, min=1.0),
                               data_term)
        init_x = torch.where(torch.isnan(pred), fallback, pred)
    else:
        init_x = data_term

    x = torch.where(new_member, init_x, x_surv)
    if params.check_sticky_obstacles:
        x = torch.where(member & (x - data_term > 0.25), data_term, x)

    def keep(v, fresh):
        return torch.where(member, torch.where(new_member, fresh, v), zero)

    return graph.replace(
        pos=torch.where(member[:, None], curr.xy, graph.pos),
        x=torch.where(member, x, zero),
        w1=keep(graph.w1, zero), w2=keep(graph.w2, zero),
        x_bar=keep(graph.x_bar, x),
        w1_bar=keep(graph.w1_bar, zero), w2_bar=keep(graph.w2_bar, zero),
        data_term=torch.where(member, data_term, zero),
        data_weight=weight, vtx_mask=member, edges=topo.edges,
        alpha=topo.alpha, beta=topo.edge_mask.float(),
        q1=topo.q1, q2=topo.q2, q3=topo.q3, edge_mask=topo.edge_mask,
        inc_edge=topo.inc_edge, inc_sign=topo.inc_sign,
        src_slot=topo.src_slot)


def _no_timer(name):
    return contextlib.nullcontext()


SMOOTHERS = ("vertex", "pallas", "halo", "pallas_halo")
RANK_LAYOUT_SMOOTHERS = ("pallas", "halo", "pallas_halo")


def resolve_smoother(params: Params) -> str:
    """The smoother this configuration runs: "auto" is the vertex-centric
    kernel K1 (the JAX package picks its banded Pallas kernel on a TPU
    only); an explicit mode is honoured as given."""
    mode = params.solver.smoother
    if mode == "auto":
        return "vertex"
    if mode not in SMOOTHERS:
        raise ValueError(f"unknown smoother {mode!r}; one of "
                         f"{('auto',) + SMOOTHERS}")
    return mode


def _smooth(params: Params, graph: nltgv2.GraphState, smoother: str,
            edge_ranks, perm, mesh) -> nltgv2.GraphState:
    """n_iters_per_frame iterations of the configured smoother. The
    rank-layout modes need the RCM perm (and "halo" / "pallas_halo" a
    mesh): without them the graph holds no incidence tables, so falling
    back to the vertex smoother would smooth against empty tables."""
    rp = params.rparams
    n_iters = params.solver.n_iters_per_frame
    if smoother == "vertex":
        return smoother_kernel.smooth(rp, graph, n_iters)
    if perm is None or (smoother != "pallas" and mesh is None):
        missing = "perm (the RCM order of the topology)" if perm is None \
            else "mesh"
        raise ValueError(f"smoother={smoother!r} needs {missing}")
    V = graph.x.shape[0]
    perm = perm.long()
    inv_perm = torch.empty_like(perm)
    inv_perm[perm] = torch.arange(V, device=perm.device)
    D = params.solver.max_vertex_degree
    reach = params.solver.pallas_reach
    if smoother == "halo":
        return halo.halo_smooth(rp, graph, perm, inv_perm, edge_ranks,
                                n_iters, D, mesh,
                                halo=halo.strip_width(V, mesh.size, reach))
    if smoother == "pallas":  # the banded kernel with one partition
        mesh = sharding.make_mesh(1, graph.x.device)
    return halo_kernel.smooth_sharded(rp, graph, perm, inv_perm, edge_ranks,
                                      n_iters, D, mesh, reach=reach)


def _sync_body(params: Params, K, Kinv, graph: nltgv2.GraphState, member,
               curr: CurrFeatures, pose_prev, pose_new, graph_scale,
               prev_idepthmap, tris, n_tris, edges, n_edges, edge_ranks,
               degree: int, rank_layout: bool):
    """The section up to the smoother: prev->new geometry, topology with
    dual carry, the member edge mask, graph sync, the rescale and the
    triangle mask. n_tris, n_edges: Python ints, or (1,) device scalars
    under a graph. Reads of graph: pos, the primal and dual vertex state,
    vtx_mask, edges, edge_mask and the duals. Returns (graph',
    graph_scale', tri_mask)."""
    geo_prev_to_new = epipolar.load_relative(K, Kinv, pose_prev, pose_new)
    V = graph.x.shape[0]
    E = graph.q1.shape[0]
    # RCM-order ranks are not incidence ranks: the rank-layout modes skip
    # the incidence tables and build their own layout.
    topo = topo_mod.from_edges(edges, n_edges, curr.xy, graph.edges,
                               graph.edge_mask, graph.q1, graph.q2, graph.q3,
                               E, V, degree,
                               ranks=None if rank_layout else edge_ranks)
    edge_ok = topo.edge_mask & member[topo.edges[:, 0]] \
        & member[topo.edges[:, 1]]

    def mask(v):
        return torch.where(edge_ok, v, torch.zeros_like(v))
    topo = topo._replace(edge_mask=edge_ok, alpha=mask(topo.alpha),
                         q1=mask(topo.q1), q2=mask(topo.q2),
                         q3=mask(topo.q3))
    graph = _graph_sync_inner(params, graph, graph.vtx_mask, member, curr,
                              geo_prev_to_new, graph_scale, topo,
                              prev_idepthmap)

    if params.rescale_data:
        # Renormalize so x stays O(1) (reference flame.cc:328-351).
        cnt = torch.clamp(member.float().sum(), min=1.0)
        new_scale = torch.where(member, graph.data_term,
                                torch.zeros_like(graph.x)).sum() \
            * graph_scale / cnt
        new_scale = torch.where(new_scale > 1e-8, new_scale,
                                torch.as_tensor(graph_scale,
                                                device=new_scale.device))
        ratio = graph_scale / new_scale
        graph = graph.replace(x=graph.x * ratio, x_bar=graph.x_bar * ratio,
                              data_term=graph.data_term * ratio)
        graph_scale = new_scale
    tri_mask = (torch.arange(tris.shape[0], device=tris.device) < n_tris) \
        & torch.all(member[tris], dim=1)
    return graph, graph_scale, tri_mask


def _sync_section(steps, params: Params, K, Kinv, graph: nltgv2.GraphState,
                  member, curr: CurrFeatures, pose_prev, pose_new,
                  graph_scale, prev_idepthmap, tris, n_tris, edges, n_edges,
                  edge_ranks, rank_layout: bool):
    """_sync_body, replayed from the graph of kind "post" when steps is
    given: the graph's buffers take the tensors it reads, its device
    scalars n_tris and n_edges."""
    degree = graph.inc_edge.shape[1]
    if steps is None:
        return _sync_body(params, K, Kinv, graph, member, curr, pose_prev,
                          pose_new, graph_scale, prev_idepthmap, tris,
                          n_tris, edges, n_edges, edge_ranks, degree,
                          rank_layout)
    read = ("pos", "x", "w1", "w2", "x_bar", "w1_bar", "w2_bar", "vtx_mask",
            "edges", "edge_mask", "q1", "q2", "q3")
    given = dict(zip(read, (getattr(graph, k) for k in read)),
                 member=member, xy=curr.xy, idepth=curr.idepth, var=curr.var,
                 q_prev=pose_prev[0], t_prev=pose_prev[1], q_new=pose_new[0],
                 t_new=pose_new[1], tris=tris, edges_in=edges,
                 graph_scale=graph_scale, prev_idepthmap=prev_idepthmap,
                 edge_ranks=None if rank_layout else edge_ranks)
    given = {k: v for k, v in given.items() if v is not None}
    names = tuple(given)

    def body(ins, scalars):
        a = dict(zip(names, ins))
        g = nltgv2.GraphState(**{k: a[k] for k in read}, data_term=None,
                              data_weight=None, alpha=None, beta=None)
        cu = CurrFeatures(xy=a["xy"], idepth=a["idepth"], var=a["var"],
                          valid=None)
        return _sync_body(
            params, K, Kinv, g, a["member"], cu, (a["q_prev"], a["t_prev"]),
            (a["q_new"], a["t_new"]), a["graph_scale"],
            a.get("prev_idepthmap"), a["tris"], scalars[0], a["edges_in"],
            scalars[1], a.get("edge_ranks"), degree, rank_layout)
    return steps.run("post", body, list(given.values()), (n_tris, n_edges),
                     params, (K, Kinv), static=(names, degree, rank_layout))


def _post_delaunay_inner(params: Params, K, Kinv, graph: nltgv2.GraphState,
                         member, curr: CurrFeatures, pose_prev, pose_new,
                         graph_scale, width: int, height: int,
                         prev_idepthmap=None, tris=None, n_tris: int = 0,
                         edges=None, n_edges: int = 0, edge_ranks=None,
                         perm=None, mesh=None, timed=None):
    """Everything between host Delaunay and the next frame: prev->new
    geometry, topology with dual carry, graph sync, the smoother, mesh
    outputs and coverage. tris (T, 3), edges (E, 2) and edge_ranks (E, 2)
    are padded to capacity; n_tris/n_edges count the real rows. The
    vertex smoother takes incidence slot ranks; the rank-layout smoothers
    ("pallas", "halo", "pallas_halo") take RCM-order ranks
    (smoother_kernel.perm_edge_ranks), perm (V,) the RCM rank -> vertex
    slot order, and "halo" / "pallas_halo" the partition mesh
    (parallel.sharding.Mesh). timed: optional context-manager factory,
    called with "smoother" and "raster". Returns (graph', vtx_idepths,
    normals, tri_validity, idepthmap, graph_scale, coverage).

    While the caller has made a step_graph.Steps current (a CUDA stack's,
    step_graph.active), the mesh is not over a process group and
    graph_scale is a device tensor, the torch ops between the calls made
    by name replay CUDA graphs (flame_tpu_torch/step_graph.py): "post"
    up to smoother_kernel.smooth, "smooth" and "raster" inside smooth and
    raster_kernel.rasterize, "mesh" from the one to the other; the
    coverage's four ops run eagerly. Every tensor handed to or returned
    from those calls is the caller's own. (A host float graph_scale runs
    the section eagerly: on the card torch divides by a host scalar as a
    product with its reciprocal, which no device scalar reproduces bit
    for bit.)"""
    timed = timed or _no_timer
    smoother = resolve_smoother(params)
    graphed = isinstance(graph_scale, torch.Tensor) \
        and not sharding.grouped(mesh)
    steps = step_graph.current() if graphed else None
    tris = tris.long()
    with step_graph.active(steps):
        graph, scale, tri_mask = _sync_section(
            steps, params, K, Kinv, graph, member, curr, pose_prev,
            pose_new, graph_scale, prev_idepthmap, tris, n_tris, edges,
            n_edges, edge_ranks, smoother in RANK_LAYOUT_SMOOTHERS)
        if params.do_nltgv2:
            with timed("smoother"):
                graph = _smooth(params, graph, smoother, edge_ranks, perm,
                                mesh)
        else:
            graph = graph.replace(x=graph.data_term)
        outs = mesh_outputs(params, K, Kinv, width, height, graph, tris,
                            tri_mask, scale, timed)
    coverage = (~torch.isnan(outs[-1])).float().mean()
    return (graph,) + outs + (torch.as_tensor(scale, dtype=torch.float32),
                              coverage)


def project_views(K, Kinv, graph: nltgv2.GraphState, graph_scale, sync_q,
                  sync_t, qs, ts, tris, n_tris: int):
    """The mesh in B views: vertex pixels live in the frame at (sync_q,
    sync_t); qs (B, 4) / ts (B, 3) are the views' poses. Returns per-view
    vertex pixels (B, V, 2), idepths (B, V) and triangle validity (B, T):
    the first n_tris triangles whose vertices are graph members in front
    of the camera."""
    # Geometry broadcasts (B, 1) against the V vertices.
    geo = epipolar.load_relative(K, Kinv, (sync_q.float(), sync_t.float()),
                                 (qs[:, None], ts[:, None]))
    pos, idepth = epipolar.project_idepth(geo, graph.pos,
                                          graph.x * graph_scale)
    ok = graph.vtx_mask & (idepth > 0)
    tri_in = torch.arange(tris.shape[0], device=tris.device) < n_tris
    return pos, idepth, tri_in[None] & torch.all(ok[:, tris], dim=2)


def batch_step(params: Params, K, Kinv, stack: FrameStack,
               feats: FeatureState, graph: nltgv2.GraphState, graph_scale,
               imgs, fids, qs, ts, pf_flags, det_flags, pf_slots, id_bases,
               prev_q, prev_t, sync_q, sync_t, seed_map, topo: dict,
               width: int, height: int, mesh=None, timed=None):
    """B frames in one step (flame_tpu/core/pipeline.py::batch_step):
    per-frame tracking with the exact sequential semantics, then one
    post-Delaunay section (topology, graph sync, smoothing, mesh outputs)
    on the last frame's state.

    Each frame gets its own dense map: the batch-start mesh (vertex
    pixels of the sync frame, the previous batch's last frame) is
    projected into every frame's view and all B maps are rasterized up
    front with one shared binning pass
    (raster_kernel.rasterize_batch_with_count: on the GPU one launch of
    the CUDA kernel K2b, binning included). Frame b's detection seeds from
    frame b-1's map (frame 0 from seed_map, the previous output map), and
    a poseframe stashes its own map into the stack. The JAX package runs
    the frames as a lax.scan with masked inserts; here they are a Python
    loop that inserts only on poseframes.

    imgs: B (H, W) uint8 tensors on the state's device; qs/ts: B (4,) /
    (3,) poses; pf_flags, det_flags, pf_slots, id_bases: per-frame Python
    values (pf_slots[b] is the current poseframe slot during frame b).
    prev_q/prev_t: pose of the frame before the batch. topo: the applied
    topology (tris, n_tris, edges, n_edges, edge_ranks), whose triangles
    the per-frame maps draw, and its RCM perm under a rank-layout
    smoother; mesh: the partition mesh of "halo" / "pallas_halo" (see
    _post_delaunay_inner). The stack is updated in place. timed:
    optional context-manager factory for the "raster_batch",
    "update_idepths" and "sync_graph" stages.

    Over a process group (mesh, sharding.grouped) feats and graph are
    this rank's blocks, as in track_step: the graph is gathered once, so
    that the views' projection and the post-Delaunay section read the
    same batch-start graph; K2b draws the B maps whole on every rank;
    each frame tracks on the rank's block, and a detecting frame detects
    and inserts on the gathered state, of which each rank keeps its own
    rows; the snapshot is packed from the owners' rows gathered after the
    last frame (each frame's obs with them, on the feature axis); stats
    are summed over the frames, then over the group.

    Returns (fnew_last, stack, feats', curr_last, member_last, stats
    summed over the batch, packed (widened under do_ba), graph',
    vtx_idepths, normals, tri_validity, idepthmap, graph_scale', coverage,
    max_union): feats', curr_last, member_last, graph', vtx_idepths and
    normals are the rank's blocks over a process group; max_union
    is the largest per-tile count of union-bbox candidates, a device
    scalar; above MAX_PER_TILE_BATCH the per-frame maps lost triangles
    (the lowest-index ones of that tile), as on the TPU."""
    timed = timed or _no_timer
    B = len(imgs)
    qs = torch.stack([q.float() for q in qs])
    ts = torch.stack([t.float() for t in ts])
    tris = topo["tris"].long()
    graph = sharding.gather_rows(mesh, graph)

    with timed("raster_batch"):
        pos_views, id_views, tri_ok_views = project_views(
            K, Kinv, graph, graph_scale, sync_q, sync_t, qs, ts, tris,
            topo["n_tris"])
        dense_views, max_union = raster_kernel.rasterize_batch_with_count(
            pos_views, tris, id_views, tri_ok_views, height, width)

    with timed("update_idepths"):
        pq, pt = prev_q, prev_t
        stats = None
        obs_b = []
        for b in range(B):
            slot = int(pf_slots[b])
            f = frame_mod.create(fids[b], qs[b], ts[b], imgs[b], params.pad)
            if pf_flags[b]:
                frame_mod.insert(stack, slot, f)
            feats, curr, member, st, obs = track_project_sync(
                params, K, Kinv, stack, feats, f, slot)
            obs_b.append(obs)
            if det_flags[b]:
                whole, curr_w = sharding.gather_rows(mesh, feats, curr)
                feats = sharding.shard_rows(_detect_and_insert(
                    params, K, Kinv, stack, slot, whole, curr_w, pq, pt,
                    int(id_bases[b]),
                    seed_map if b == 0 else dense_views[b - 1]), mesh)
            if pf_flags[b]:
                frame_mod.set_idepthmap(stack, slot, dense_views[b])
            stats = st if stats is None else stats + st
            pq, pt = f.q, f.t
        if sharding.grouped(mesh):
            stats = sharding.psum([stats], mesh)
        # The frames' obs stacked on dim 1: gather_rows gathers dim 0.
        obs = (TrackObs(*(torch.stack(o, dim=1) for o in zip(*obs_b))),) \
            if params.do_ba else ()
        feats_w, curr_w, member_w, *obs = sharding.gather_rows(
            mesh, feats, curr, member, *obs)
        packed = pack_track_outputs(feats_w, curr_w, member_w)
        if params.do_ba:
            packed = pack_ba_outputs(params, packed, TrackObs(
                *(o.movedim(1, 0) for o in obs[0])), feats_w, stack)

    with timed("sync_graph"), \
            step_graph.active(step_graph.steps_for(stack)):
        graph, vtx_idepths, normals, *post = _post_delaunay_inner(
            params, K, Kinv, graph, member_w, curr_w, (sync_q, sync_t),
            (f.q, f.t), graph_scale, width, height,
            dense_views[-1] if params.init_with_prediction else None,
            mesh=mesh, timed=timed, **topo)
    graph, vtx_idepths, normals = (sharding.shard_rows(a, mesh)
                                   for a in (graph, vtx_idepths, normals))
    return (f, stack, feats, curr, member, stats, packed, graph,
            vtx_idepths, normals, *post, max_union)


def _mesh_geometry(params: Params, Kinv, width: int, pos, x, vtx_mask,
                   tris, tri_mask, graph_scale):
    """Vertex idepths, normals and the filtered triangle validity."""
    vtx_idepths = torch.where(vtx_mask, x * graph_scale, torch.zeros_like(x))
    geom = mesh_filters.corner_geometry(Kinv, pos, vtx_idepths, tris)
    normals = mesh_filters.vertex_normals(geom, tris, tri_mask, x.shape[0])
    tri_validity = mesh_filters.apply_filters(params.tri_filter, width, geom,
                                              tri_mask)
    return vtx_idepths, normals, tri_validity


def mesh_outputs(params: Params, K, Kinv, width: int, height: int, graph,
                 tris, tri_mask, graph_scale, timed=None):
    """Vertex idepths, normals, triangle filters and the dense map
    (reference flame.cc:353-415). While a step_graph.Steps is current
    (graph_scale then is a device tensor) the part before rasterize
    replays the graph of kind "mesh"."""
    timed = timed or _no_timer
    steps = step_graph.current()
    ins = [graph.pos, graph.x, graph.vtx_mask, tris, tri_mask, graph_scale]

    def body(b, scalars):
        return _mesh_geometry(params, Kinv, width, *b)
    if steps is None:
        vtx_idepths, normals, tri_validity = body(ins, ())
    else:
        vtx_idepths, normals, tri_validity = steps.run(
            "mesh", body, ins, (), params, (Kinv,), static=(width,))
    with timed("raster"):
        idepthmap = raster_kernel.rasterize(graph.pos, tris, vtx_idepths,
                                            tri_mask, height, width)
    return vtx_idepths, normals, tri_validity, idepthmap


def as_numpy_packed(packed: torch.Tensor) -> np.ndarray:
    """The one device->host copy per frame (host_packed gives it the
    JAX package's host dtype)."""
    return packed.cpu().numpy()


def host_packed(arr: np.ndarray) -> np.ndarray:
    """A landed packed transfer in the JAX package's host dtype: the
    (N, 3) snapshot as u16; the flat widened BA transfer stays int32."""
    return arr.astype(np.uint16) if arr.ndim == 2 else arr


def reanchor_features(feats: FeatureState, K, Kinv, stack: FrameStack,
                      kill_pf_mask, target_slot: int, border_lo: float,
                      border_hi_x: float,
                      border_hi_y: float) -> FeatureState:
    """Move the features anchored in pruned poseframes (kill_pf_mask (F,)
    bool) onto the poseframe at target_slot (reference prunePoseFrames,
    flame.cc:603-700): predict through the old->target geometry, scale
    the variance by (mu'/mu)^4, invalidate on a failed or out-of-border
    move."""
    needs_move = feats.valid & kill_pf_mask[feats.pf_slot]
    q_rel, t_rel = se3.mul(se3.inverse((stack.q[target_slot],
                                        stack.t[target_slot])),
                           (stack.q[feats.pf_slot], stack.t[feats.pf_slot]))
    geos = epipolar.load(K, Kinv, q_rel, t_rel)
    ok, u_pf, id_pf, _ = idfilter.predict(geos, 1.0, feats.xy,
                                          feats.idepth_mu, feats.idepth_var)
    in_bounds = ((u_pf[:, 0] >= border_lo) & (u_pf[:, 0] < border_hi_x)
                 & (u_pf[:, 1] >= border_lo) & (u_pf[:, 1] < border_hi_y))
    move_ok = needs_move & ok & in_bounds

    mu = feats.idepth_mu
    nonzero = torch.abs(mu) > 0
    ratio = torch.where(nonzero, id_pf / torch.where(nonzero, mu,
                                                     torch.ones_like(mu)),
                        torch.ones_like(mu))
    vf4 = torch.where(id_pf < 1e-6, torch.ones_like(ratio), ratio ** 4)
    return feats.replace(
        xy=torch.where(needs_move[:, None], u_pf, feats.xy),
        pf_slot=torch.where(needs_move, target_slot, feats.pf_slot),
        idepth_mu=torch.where(needs_move, id_pf, mu),
        idepth_var=torch.where(needs_move, feats.idepth_var * vf4,
                               feats.idepth_var),
        valid=torch.where(needs_move, move_ok, feats.valid))
