"""Compared numbers of windowed bundle adjustment (the port's ba/window.py)
against the plain float64 solve of reference/ba.py.

Once armed at a sampled read, the listener keeps every window problem
staged after it (the int32 upload ba.window._pack_problem returns, and a
digest of the window poseframes' padded frames as the program's frame
stack holds them when BundleAdjuster._stage_solve has launched the
solve: the solve's own input, summed on the stream behind it) with its
result when it is applied (BundleAdjuster._apply: the flat result, its
meta, the solver's params), until a solve that the program's gate
accepts (mean cost under ba.max_mean_cost) lands: the first solve
staged after the read, and more while they fail the gate, since about
four in five fail it here and a failed solve writes nothing back. A
solve applied reads later, or after the last sampled read, is kept
too. One solve is in flight at a time, so a solve's apply is the next
_apply call.

Per kept solve the reference solves the same upload from the window
poseframes' frames as the run fed them (image(frame_id), padded
reflect-101 as the port pads them) in float64, and measures what
float32 does to this window with the solves of YARDSTICK: float32 on
the upload, by dense normal equations and by the Schur complement as
the port takes it, float32 on uploads moved by float32's rounding
(reference.ba.perturb), and float64 on such an upload. Where Gauss-
Newton drives landmarks seen once into gross residuals or to a bound of
the inverse-depth clip, any float32 solve lands in a spread of ends
(the final cost up to twofold apart) while float64 holds to 1e-5 of the
step; elsewhere float32 lands within about 1e-3 of it. Every number is
taken over every kept solve, accepted or rejected:

  ba_pose_gap      the worst, over the translations and the rotations,
                   of the largest gap between the program's and the
                   float64 reference's solved poses over the largest gap
                   of a yardstick solve plus STEP_FLOOR of the solve's
                   step (the largest move of a free pose from its
                   staged value in the reference)
  ba_lm_gap        as ba_pose_gap, for the refined inverse depths, in
                   the solve's metric: sqrt(sum_i h_i gap_i^2), h_i the
                   landmark's Gauss-Newton information at the
                   reference's result (sum w |dr/dd|^2)
  ba_cost_gap      the relative gap between the float64 costs of the
                   program's and the reference's results, over the
                   largest of a yardstick solve plus COST_FLOOR; each
                   cost at the reference's re-matched pixels, over the
                   observations of the landmarks that no solve drove to
                   a bound of the clip (1e-4, 1e3: at 1e3 a point sits
                   1 mm from its anchor, and whether its observers see
                   it 1 mm in front, and count its residual of hundreds
                   of pixels, turns on rounding)
  ba_accept_miss   the share of the kept solves on which the program's
                   gate (its final cost: mean < max_mean_cost) and the
                   float64 reference's disagree, where no yardstick
                   solve and not the float64 cost of the program's own
                   result (its poses, inverse depths and re-matched
                   pixels) reach the program's decision
  ba_rematch_miss  the worst over the kept solves of the share of valid
                   observations whose re-matched pixel differs from the
                   reference's by more than half a pixel. The graph's
                   replay keeps no re-matched pixel, so the program's
                   are computed again by the port's own re-match
                   (ba.window._rematch_and_weigh, float32, on the same
                   device) from the upload and the fed frames; where
                   the digest of the frames the program's stack held
                   for the solve differs from theirs, every pixel is a
                   miss (1.0)

With control, the reference in bfloat16 stands in for the program (its
re-match and its gate too).
"""

import dataclasses
import sys

import numpy as np
import torch

from harness import checks
from reference import ba as ref_ba

NUMBERS = ("ba_pose_gap", "ba_lm_gap", "ba_cost_gap", "ba_accept_miss",
           "ba_rematch_miss")
PACK = ("flame_tpu_torch.ba.window", "_pack_problem")
STAGE = ("flame_tpu_torch.ba.window", "BundleAdjuster._stage_solve")
APPLY = ("flame_tpu_torch.ba.window", "BundleAdjuster._apply")
HOOKS = [PACK, STAGE, APPLY]
MOVE_PX = 0.5  # a re-matched pixel further off than this is a miss
STEP_FLOOR = 1e-3  # of the solve's step, added to the yardstick's gap
COST_FLOOR = 1e-5  # of the reference's cost, added to the yardstick's gap
LM_BOUNDS = (1e-4, 1e3)  # the solve's inverse-depth clip
# The reference's solves that measure what float32 does to a window:
# (dtype, perturb() seed or None for the upload itself, Schur
# reduction). Float32 on the upload, by both linear solves, and on
# uploads moved by float32's rounding; float64 on such an upload.
YARDSTICK = ((torch.float32, None, False), (torch.float32, None, True),
             (torch.float32, 1, True), (torch.float32, 2, False),
             (torch.float64, 1, False))


class Listener:
    def __init__(self):
        self.armed = False  # an armed read waits for an accepted solve
        self.arms = 0  # armed reads so far
        self.staged = None  # the solve in flight: upload, slots, digest
        self.kept = []

    def arm(self) -> None:
        self.armed = True
        self.arms += 1

    def take(self) -> list:
        self.armed = False
        kept, self.kept = self.kept, []
        return kept

    def before(self, point, args, kwargs):
        if point == PACK:
            return self.armed and self.staged is None \
                and dict(slot=np.array(args[1], np.int64, copy=True))
        if point == STAGE:
            return self.armed and self.staged is None and args[1]
        if self.staged is None:
            return None
        ba, fl, flat, meta = args[:4]
        return dict(ba=ba, flat=np.array(flat, np.float32, copy=True),
                    order=list(meta["order"]), P=int(meta["P"]),
                    L=int(meta["L"]), n_obs=int(meta["n_obs"]),
                    params=ba.params, pad=int(fl.params.pad),
                    K=torch.as_tensor(ba.K).detach().clone(),
                    Kinv=torch.as_tensor(ba.Kinv).detach().clone())

    def after(self, point, token, out) -> None:
        if token is None or token is False:
            return
        if point == PACK:
            self.staged = dict(buf=np.array(out, copy=True),
                               arms=self.arms, **token)
            return
        if point == STAGE:
            if self.staged is not None and "digest" not in self.staged:
                stack = token._stack.img_pad
                self.staged["digest"] = digest(stack[torch.as_tensor(
                    self.staged["slot"], device=stack.device)])
            return
        st, self.staged = self.staged, None
        token["buf"], token["digest"] = st["buf"], st.get("digest")
        # A solve that passed the program's gate serves the armed reads
        # made before it was staged.
        if token.pop("ba").last_accepted and st["arms"] == self.arms:
            self.armed = False
        self.kept.append(token)


def digest(frames: torch.Tensor) -> torch.Tensor:
    """Per frame of (F, H, W) whole-valued pixels, the float64 sums of x,
    x^2 and x times its flat index: exact in any order (every partial
    sum is a whole number under 2^53), computed on the frames' device
    without a wait, one frame at a time."""
    idx = torch.arange(frames[0].numel(), device=frames.device,
                       dtype=torch.float64)
    out = []
    for f in frames:
        f = f.double().flatten()
        out.append(torch.stack([f.sum(), (f * f).sum(), (f * idx).sum()]))
    return torch.stack(out)


def program_result(flat: np.ndarray, P: int, L: int, device) -> dict:
    """The port's flat result [q 4P | t 3P | lm L | cost] as the
    reference's fields."""
    f = torch.as_tensor(flat, device=device).double()
    return dict(R=ref_ba.quat_to_rot(f[:4 * P].reshape(P, 4)),
                t=f[4 * P:7 * P].reshape(P, 3), lm=f[7 * P:7 * P + L],
                cost=f[7 * P + L])


def _largest(gap: torch.Tensor) -> float:
    """The largest entry; inf when one is not finite."""
    if not bool(torch.isfinite(gap).all()):
        return float("inf")
    return float(gap.max()) if gap.numel() else 0.0


def gaps(sol: dict, ref: dict, staged: dict) -> dict:
    """The pose and landmark gaps of one solve, unscaled, and the
    solve's step in each: sol and ref with R, t, lm (the reference's
    fields; ref with lm_info); staged: the decoded upload
    (ref_ba.decode)."""
    R0 = ref_ba.quat_to_rot(staged["q"].to(ref["R"]))
    t0 = staged["t"].to(ref["t"])
    free = torch.arange(R0.shape[0], device=R0.device) >= ref_ba.N_FIXED
    Rr, tr = ref["R"].double(), ref["t"].double()
    dt = _largest((sol["t"].double() - tr).norm(dim=-1))
    dr = _largest(ref_ba.rotation_angle(Rr, sol["R"].double()))
    st = max(_largest((tr - t0)[free].norm(dim=-1)), 1e-30)
    sr = max(_largest(ref_ba.rotation_angle(R0, Rr)[free]), 1e-30)
    m = staged["lm_valid"].to(ref["lm"].device)
    h = ref["lm_info"].double()[m]
    gap = (sol["lm"].double() - ref["lm"].double())[m]
    step = (ref["lm"].double() - staged["lm"].to(ref["lm"]))[m]
    return dict(pose=(dt, dr), pose_step=(st, sr),
                lm=_largest((h * gap * gap).sum().sqrt()[None]),
                lm_step=max(float((h * step * step).sum().sqrt()), 1e-30))


def scaled(got: dict, yard: dict) -> dict:
    """ba_pose_gap and ba_lm_gap: a solve's gaps over the float32
    yardstick's plus STEP_FLOOR of the step (translation and rotation
    apart, the larger of the two)."""
    pose = max(g / (y + STEP_FLOOR * s) for g, y, s in
               zip(got["pose"], yard["pose"], got["pose_step"]))
    lm = got["lm"] / (yard["lm"] + STEP_FLOOR * got["lm_step"])
    return dict(ba_pose_gap=pose, ba_lm_gap=lm)


def clipped(lm: torch.Tensor) -> torch.Tensor:
    """Inverse depths at a bound of the solve's clip."""
    lo, hi = LM_BOUNDS
    lm = lm.double()
    return (lm <= lo * (1 + 1e-6)) | (lm >= hi * (1 - 1e-6))


def rel(a, b) -> float:
    a, b = float(a), float(b)
    return abs(a - b) / max(abs(b), 1e-12) if np.isfinite(a) \
        else float("inf")


def accepted(cost, n_obs: int, max_mean_cost: float) -> bool:
    mean = float(cost) / max(n_obs, 1)
    return bool(np.isfinite(mean) and mean < max_mean_cost)


def rematch_miss(u: torch.Tensor, u_ref: torch.Tensor, valid) -> float:
    far = (u.double() - u_ref.double()).norm(dim=-1) > MOVE_PX
    far |= ~torch.isfinite(u.double()).all(dim=-1)
    return float((far & valid).sum()) / max(int(valid.sum()), 1)


def program_rematch(cap: dict, buf: torch.Tensor, frames, M: int, device):
    """The port's re-matched pixels of the upload (float32; None with
    re-match off): its decode and re-match on the padded frames, in
    window order."""
    if not cap["params"].do_rematch:
        return None
    from flame_tpu_torch.ba import window
    P, L = cap["P"], cap["L"]
    problem, _ = window._decode_packed(buf.to(device), P, L, M)
    problem, _ = window._rematch_and_weigh(
        cap["params"], cap["K"].to(device), cap["Kinv"].to(device), problem,
        torch.arange(P, device=device), frames.to(device), cap["pad"])
    return problem.obs.u_obs


def yardstick(buf, P: int, L: int, M: int, K, p: dict, images,
              pad: int) -> list:
    """The reference's solves in YARDSTICK: how far float32 moves this
    window's solve."""
    return [ref_ba.solve(buf if seed is None else
                         ref_ba.perturb(buf, P, L, M, seed), P, L, M, K, p,
                         images, pad, dtype=dtype, schur=schur)
            for dtype, seed, schur in YARDSTICK]


def cost_over(pb: dict, sol: dict, u_obs, K, delta, keep) -> float:
    """The float64 cost 0.5 sum w |r|^2 at a solve's result over the
    observations of the landmarks in keep (L,) bool."""
    r, w, _ = ref_ba._residuals(pb, sol["R"].double(), sol["t"].double(),
                                sol["lm"].double(), u_obs, K, delta,
                                jac=False)
    return float((0.5 * w * (r * r).sum(-1))[keep[pb["l"]]].sum())


def readings(cap: dict, device, K, image, control=False) -> dict:
    """One kept solve's numbers, per side ("" the program, ".control" the
    bfloat16 reference in its place), with the two gates and the count
    of observations the cost gap left out."""
    P, L = cap["P"], cap["L"]
    buf = torch.as_tensor(cap["buf"])
    M = (buf.numel() - 15 * P - 2 * L) // 8
    p = dataclasses.asdict(cap["params"])
    images = np.stack([image(f) for f in cap["order"]])
    pb = ref_ba._decoded(buf, P, L, M, torch.float64, device)
    ref = ref_ba.solve(buf, P, L, M, K, p, images, cap["pad"])
    yards = yardstick(buf, P, L, M, K, p, images, cap["pad"])
    yard_gaps = [gaps(y, ref, pb) for y in yards]
    yard = dict(pose=tuple(max(g["pose"][i] for g in yard_gaps)
                           for i in range(2)),
                lm=max(g["lm"] for g in yard_gaps))
    n, gate = cap["n_obs"], p["max_mean_cost"]
    ref_gate = accepted(ref["cost"], n, gate)
    prog = program_result(cap["flat"], P, L, device)
    frames = ref_ba.pad_images(images, cap["pad"], torch.float32, device)
    # The stack held the fed frames for the solve, else every re-matched
    # pixel counts as a miss.
    fed = torch.equal(cap["digest"].to(device), digest(frames))
    u = program_rematch(cap, buf, frames, M, device)
    sides = {"": (prog, u)}
    if control:
        ctl = ref_ba.solve(buf, P, L, M, K, p, images, cap["pad"],
                           dtype=torch.bfloat16)
        sides[".control"] = (ctl, ctl["u_obs"] if p["do_rematch"] else None)
    u_ref, delta = ref["u_obs"], p["huber_delta"]
    out = {}
    for side, (sol, u_side) in sides.items():
        # The landmarks that no solve here drove to a bound of the clip.
        keep = pb["lm_valid"] & ~clipped(sol["lm"]) & ~clipped(ref["lm"])
        for y in yards:
            keep &= ~clipped(y["lm"])
        c_ref = cost_over(pb, ref, u_ref, K, delta, keep)
        yard_cost = max(rel(cost_over(pb, y, u_ref, K, delta, keep),
                            c_ref) for y in yards)
        cost = rel(cost_over(pb, sol, u_ref, K, delta, keep), c_ref)
        got = gaps(sol, ref, pb)
        acc = accepted(sol["cost"], n, gate)
        # A gate that float32 tips either way here, or that the float64
        # cost of the side's own result takes the side's way, is no miss.
        tips = [accepted(y["cost"], n, gate) for y in yards]
        tips.append(accepted(cost_over(
            pb, sol, pb["u_obs"] if u_side is None else u_side.double(),
            K, delta, torch.ones_like(keep)), n, gate))
        out[side] = dict(
            scaled(got, yard),
            ba_cost_gap=cost / (yard_cost + COST_FLOOR),
            ba_accept_miss=float(acc != ref_gate and acc not in tips),
            ba_rematch_miss=0.0 if u_side is None else
            rematch_miss(u_side, ref["u_obs"], pb["valid"])
            if side or fed else 1.0,
            accepted=acc, ref_accepted=ref_gate,
            left_out=int((pb["valid"] & ~keep[pb["l"]]).sum()))
    return out


def numbers(captures, device, cfg, image, control=False) -> dict:
    K = checks._camera(cfg, torch.float64, device)[0]
    runs = {"": [], ".control": []} if control else {"": []}
    for cap in captures:
        for side, got in readings(cap, device, K, image, control).items():
            runs[side].append(got)
    out = {}
    for side, solves in runs.items():
        if not solves:
            continue
        out["ba_accept_miss" + side] = float(np.mean(
            [g["ba_accept_miss"] for g in solves]))
        for name in ("ba_pose_gap", "ba_lm_gap", "ba_cost_gap",
                     "ba_rematch_miss"):
            out[name + side] = max(g[name] for g in solves)
    prog = runs[""]
    print(f"benchmark: ba: {len(prog)} solves compared, "
          f"{sum(g['accepted'] for g in prog)} applied by the program, "
          f"{sum(g['ref_accepted'] for g in prog)} accepted by the "
          f"reference, {max((g['left_out'] for g in prog), default=0)} "
          f"observations at most left out of a cost (clipped landmarks)",
          file=sys.stderr, flush=True)
    return out
