"""One tracking step of every feature slot, as plain reference.

The track -> measure -> fuse part of flame_tpu_torch/core/pipeline.py's
track_project_sync (reference flame.cc:1319-1752), frozen with the
modules beside it: the baseline gate, the prediction and its rescale
factor (a feature whose warp leaves the range moves to the current
poseframe instead of tracking), the +/- search_sigma epipolar region, the
5-tap line-stereo match against the feature's anchor poseframe, the
inverse-depth measurement and its Gaussian fusion. Computed in torch's
default dtype, which the caller sets (float64 for the reference,
bfloat16 for the control).

The caller builds the frames from the benchmark's own uint8 images:
frame() pads and differentiates an image as the port does (reflect-101
padding of width pad, central gradients). The feature state and the
poseframe poses it starts from are the program's (the step follows the
program from its own state); the images, the camera and the parameters
are the benchmark's.
"""

from types import SimpleNamespace

import torch
import torch.nn.functional as F

from reference.tracking import epipolar, meas_model, se3
from reference.tracking import filter as idfilter
from reference.tracking import line_stereo
from reference.tracking.gradients import central_gradient


def namespace(d):
    """A parameter tree (nested dicts) as attribute namespaces."""
    if isinstance(d, dict):
        return SimpleNamespace(**{k: namespace(v) for k, v in d.items()})
    return d


def frame(img_u8: torch.Tensor, pad: int):
    """(img_pad, gradx, grady) of a uint8 image in the default dtype."""
    f = img_u8.to(torch.get_default_dtype())
    img_pad = F.pad(f[None, None], (pad, pad, pad, pad), mode="reflect")[0, 0]
    gx, gy = central_gradient(f)
    return img_pad, gx, gy


def track(p, K, Kinv, stack_img_pad, stack_q, stack_t, feats, new_pad,
          new_gx, new_gy, q_new, t_new, curr_pf_slot: int):
    """Per slot: (mu, var, updated) after one step. p: the Params tree
    as a namespace; feats: xy, pf_slot, idepth_mu, idepth_var, valid."""
    H, W = new_gx.shape
    pad = (new_pad.shape[0] - H) // 2
    fp = p.fparams
    border = int(p.rescale_factor_max * fp.win_size / 2 + 1)
    row_offset = H // 3 if p.detection.do_letterbox else 0
    n_steps = line_stereo.n_steps_for(fp.epilength_max,
                                      fp.sparams.sample_dist)
    xy, slot = feats["xy"], feats["pf_slot"].long()
    mu0, var0 = feats["idepth_mu"], feats["idepth_var"]
    q_rel, t_rel = se3.mul(se3.inverse((q_new, t_new)),
                           (stack_q[slot], stack_t[slot]))
    geos = epipolar.load(K, Kinv, q_rel, t_rel)

    def vr_contains(u):
        return ((u[..., 0] >= border) & (u[..., 0] < W - border)
                & (u[..., 1] >= border + row_offset)
                & (u[..., 1] < H - border - row_offset))

    def nz(v):
        return torch.where(v > 0, v, torch.ones_like(v))

    alive = feats["valid"].bool()
    baseline = torch.linalg.norm(geos.t_ref_to_cmp, dim=-1)
    do_track = alive & (baseline >= p.min_baseline)
    ok_pred, _, mu_pred, _ = idfilter.predict(
        geos, fp.process_var_factor, xy, mu0, var0)
    rescale = torch.where((mu0 > 0) & (mu_pred > 0), mu_pred / nz(mu0),
                          torch.ones_like(mu0))
    bad_rescale = (rescale <= p.rescale_factor_min) | \
        (rescale >= p.rescale_factor_max)

    q_pf, t_pf = stack_q[curr_pf_slot], stack_t[curr_pf_slot]
    geo_n2pf = epipolar.load(K, Kinv, *se3.mul(se3.inverse((q_pf, t_pf)),
                                               (q_new, t_new)))
    geos_mv = epipolar.compose(geo_n2pf, geos)
    ok_mv, u_pf, id_pf, _ = idfilter.predict(
        geos_mv, fp.process_var_factor, xy, mu0, var0)
    do_move = do_track & ok_pred & bad_rescale
    move_ok = do_move & ok_mv & vr_contains(u_pf)
    nonzero = torch.abs(mu0) > 0
    ratio_mv = torch.where(
        nonzero, id_pf / torch.where(nonzero, mu0, torch.ones_like(mu0)),
        torch.ones_like(mu0))
    vf4_mv = torch.where(id_pf < 1e-6, torch.ones_like(ratio_mv),
                         ratio_mv ** 4)
    new_mu = torch.where(move_ok, id_pf, mu0)
    new_var = torch.where(move_ok, var0 * vf4_mv, var0)

    attempt = do_track & ok_pred & ~bad_rescale
    reg = idfilter.get_search_region(fp, geos, W, H, xy, mu0, var0)
    attempt = attempt & reg.ok & vr_contains(xy)
    off = float(pad)
    sres = idfilter.search_stacked(
        fp, geos, rescale, stack_img_pad, slot, new_pad, xy, xy + off,
        reg.start + off, reg.end + off, n_steps)
    flow = sres.u_cmp - off
    search_ok = attempt & (sres.status == idfilter.SUCCESS)
    ok_meas, mu_meas, var_meas = meas_model.idepth_measurement(
        p.zparams, geos, new_gx, new_gy, xy, flow)
    ok_fuse, mu_post, var_post = idfilter.update(
        new_mu, new_var, mu_meas, var_meas, p.outlier_sigma_thresh)
    success = search_ok & ok_meas & ok_fuse
    mu_s, var_s = (mu_post, var_post) if p.do_meas_fusion \
        else (mu_meas, var_meas)
    return (torch.where(success, mu_s, new_mu),
            torch.where(success, var_s, new_var), success)
