"""Plain reference of one windowed bundle-adjustment solve (the port's
ba/window.py _solve_packed, replayed there from one CUDA graph).

It takes the window problem as the port uploads it (one int32 buffer,
float32 sections bitcast; layout in decode()) and the window
poseframes' images, and computes in the dtype it is given (float64 for
the reference, bfloat16 for the control):

1. the 2-D re-match of every valid observation (the port's
   ba/rematch.py): each observation's pixel predicted from the staged
   poses and inverse depth, a (2(radius+2)+1)^2 bilinear window around
   it in the observer's padded image, the 5x5 bilinear patch around
   u_ref in the anchor's, the SSD field over the (2 radius+1)^2 centres,
   its arg-min with a parabola through its neighbours in x and in y
   (each step clipped to half a pixel), and the gates: an interior
   minimum, the prediction at least radius+2 px inside the image, the
   least cost at most rematch_max_cost, and the anchor patch's structure
   tensor (central differences over its interior) with its least
   eigenvalue at least rematch_min_eig. An observation that passes takes
   the new pixel; the rest keep theirs;
2. n_gn_iters Gauss-Newton steps on the reprojection residuals
   r = pi(K, T_o^-1 T_a ray(u_ref) / d) - u_obs, camera-to-world poses
   perturbed on the left (T <- exp(xi) T, xi = [v, w]), each landmark a
   scalar inverse depth d in its anchor frame: Huber weights on |r|
   (delta huber_delta; weight 0 for an invalid row or a point 1 mm or
   less in front of the observer), the pose prior
   pose_prior_weight * |log(T T_prior^-1)|^2 with the identity as its
   Jacobian, the first N_FIXED poses held (the gauge), damping added to
   every unknown's diagonal, a landmark without weight held, and the
   inverse depths clipped to [1e-4, 1e3];
3. the final cost 0.5 * sum(w |r|^2) at the result, with the weights
   taken there.

Departures from the port, each of which changes no result beyond
rounding: the normal equations are the whole dense system J^T W J over
the free poses and the landmarks with weight, assembled by one product
and solved at once, or (schur=True) reduced to the poses by the Schur
complement of the diagonal landmark block, as the port does, and
back-substituted; rotations are 3x3 matrices (the
port keeps quaternions); the camera's inverse is exact (the port's is
float32); the infinite-depth branch of the port's projection is left
out, as the staged inverse depths are positive (the store takes
mu > 1e-6); anisotropic weights (ba.aniso_weights, off by default) are
not written and raise. The bfloat16 control solves its linear system in
float32 (torch has no bfloat16 solver) and rounds the step to bfloat16.

The JAX package's params.py documents each BAParams field. Plain torch;
imports nothing of the port.
"""

import torch
import torch.nn.functional as F

N_FIXED = 2  # the window's two oldest poses hold the gauge
HALF_PATCH = 2  # the re-match patch is 5 x 5


def decode(buf: torch.Tensor, P: int, L: int, M: int) -> dict:
    """The int32 upload [q 4P | t 3P | prior_q 4P | prior_t 3P | lm L |
    lm_valid L | anchor M | observer M | landmark M | u_ref 2M |
    u_obs 2M | valid M | slot P] as float64 and index tensors."""
    sizes = (4 * P, 3 * P, 4 * P, 3 * P, L, L, M, M, M, 2 * M, 2 * M, M, P)
    parts = torch.split(buf.to(torch.int32), sizes)
    keys = ("q", "t", "prior_q", "prior_t", "lm", "lm_valid", "a", "o",
            "l", "u_ref", "u_obs", "valid", "slot")
    d = dict(zip(keys, parts))
    out = {}
    for k, shape in (("q", (P, 4)), ("t", (P, 3)), ("prior_q", (P, 4)),
                     ("prior_t", (P, 3)), ("lm", (L,)), ("u_ref", (M, 2)),
                     ("u_obs", (M, 2))):
        out[k] = d[k].view(torch.float32).reshape(shape).double()
    for k in ("a", "o", "l", "slot"):
        out[k] = d[k].long()
    out["lm_valid"] = d["lm_valid"] > 0
    out["valid"] = d["valid"] > 0
    return out


def perturb(buf, P: int, L: int, M: int, seed: int):
    """A copy of the int32 upload with each of its float32 numbers (the
    poses, their priors, the inverse depths and both pixels of every
    observation) scaled by 1 + u 2^-23, u uniform in [-1, 1], and
    rounded to float32: moved by at most about a unit in its last
    place, an upload as close to buf as float32 can hold."""
    b = torch.as_tensor(buf).to(torch.int32).clone()
    g = torch.Generator().manual_seed(seed)
    s = 14 * P + 2 * L + 3 * M
    for lo, hi in ((0, 14 * P + L), (s, s + 4 * M)):
        f = b[lo:hi].view(torch.float32)
        u = torch.rand(f.shape, generator=g, dtype=torch.float64) * 2 - 1
        f.copy_((f.double() * (1 + u * 2.0 ** -23)).float())
    return b


def quat_to_rot(q: torch.Tensor) -> torch.Tensor:
    """(..., 4) wxyz quaternions (normalised here) -> (..., 3, 3)."""
    q = q / q.norm(dim=-1, keepdim=True)
    w, x, y, z = q.unbind(-1)
    return torch.stack([
        torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z),
                     2 * (x * z + w * y)], -1),
        torch.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z),
                     2 * (y * z - w * x)], -1),
        torch.stack([2 * (x * z - w * y), 2 * (y * z + w * x),
                     1 - 2 * (x * x + y * y)], -1)], -2)


def hat(w: torch.Tensor) -> torch.Tensor:
    """(..., 3) -> (..., 3, 3) with hat(w) @ p = w x p."""
    z = torch.zeros_like(w[..., 0])
    x, y, c = w.unbind(-1)
    return torch.stack([torch.stack([z, -c, y], -1),
                        torch.stack([c, z, -x], -1),
                        torch.stack([-y, x, z], -1)], -2)


def _small(theta2: torch.Tensor) -> torch.Tensor:
    """Where the series below stand in for the closed forms: below 1e-6
    in float64 and float32, below 0.1 in bfloat16, whose closed forms
    cancel to nothing there (the series' error stays under its
    rounding)."""
    low = theta2.dtype not in (torch.float64, torch.float32)
    return theta2 < (0.1 if low else 1e-6)


def _coefs(theta2: torch.Tensor):
    """sin(th)/th, (1-cos th)/th^2, (th-sin th)/th^3, by series near 0."""
    th = theta2.clamp(min=1e-30).sqrt()
    small = _small(theta2)
    a = torch.where(small, 1 - theta2 / 6 + theta2 ** 2 / 120,
                    torch.sin(th) / th)
    b = torch.where(small, 0.5 - theta2 / 24 + theta2 ** 2 / 720,
                    (1 - torch.cos(th)) / th ** 2)
    c = torch.where(small, 1.0 / 6 - theta2 / 120 + theta2 ** 2 / 5040,
                    (th - torch.sin(th)) / th ** 3)
    return a, b, c


def se3_exp(xi: torch.Tensor):
    """(..., 6) [v, w] -> (R, t): R = exp(hat w), t = V v."""
    v, w = xi[..., :3], xi[..., 3:]
    W = hat(w)
    W2 = W @ W
    a, b, c = (x[..., None, None] for x in _coefs((w * w).sum(-1)))
    eye = torch.eye(3, dtype=xi.dtype, device=xi.device)
    R = eye + a * W + b * W2
    V = eye + b * W + c * W2
    return R, (V @ v[..., None])[..., 0]


def se3_log(R: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """(R, t) -> (..., 6) [v, w], the inverse of se3_exp (angles below
    pi)."""
    s = torch.stack([R[..., 2, 1] - R[..., 1, 2], R[..., 0, 2] - R[..., 2, 0],
                     R[..., 1, 0] - R[..., 0, 1]], -1) / 2
    cos = ((R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]) - 1) / 2
    th = torch.atan2(s.norm(dim=-1), cos)
    a, b, _ = _coefs(th * th)
    w = s / a[..., None]
    W = hat(w)
    th2 = (th * th)[..., None, None]
    small = _small(th2)
    # V^-1 = I - W/2 + (1/th^2) (1 - a / (2 b)) W^2.
    k = torch.where(small, 1.0 / 12 + th2 / 720,
                    (1 - a[..., None, None] / (2 * b[..., None, None]))
                    / th2.clamp(min=1e-30))
    eye = torch.eye(3, dtype=R.dtype, device=R.device)
    v = ((eye - W / 2 + k * (W @ W)) @ t[..., None])[..., 0]
    return torch.cat([v, w], -1)


def rotation_angle(Ra: torch.Tensor, Rb: torch.Tensor) -> torch.Tensor:
    """The angle (radians) of Ra^T Rb."""
    D = Ra.transpose(-1, -2) @ Rb
    s = torch.stack([D[..., 2, 1] - D[..., 1, 2], D[..., 0, 2] - D[..., 2, 0],
                     D[..., 1, 0] - D[..., 0, 1]], -1).norm(dim=-1) / 2
    return torch.atan2(s, (D[..., 0, 0] + D[..., 1, 1] + D[..., 2, 2] - 1) / 2)


def pad_images(images, pad: int, dtype, device) -> torch.Tensor:
    """uint8 frames (F, H, W) -> (F, H + 2 pad, W + 2 pad), reflect-101
    (the port's frame.create)."""
    f = torch.as_tensor(images).to(device).double()
    return F.pad(f[:, None], (pad,) * 4, mode="reflect")[:, 0].to(dtype)


def _bilinear(imgs, idx, x, y):
    """imgs (F, Hp, Wp) sampled at (x, y) of image idx (broadcast with
    x and y), positions clamped to [0, Wp - 1.001] x [0, Hp - 1.001] (as
    the port's sampler)."""
    _, Hp, Wp = imgs.shape
    x = x.clamp(0.0, Wp - 1.001)
    y = y.clamp(0.0, Hp - 1.001)
    # The corner's index is held inside too: in bfloat16 the bound above
    # rounds up to the last column (row).
    x0, y0 = torch.floor(x).clamp(max=Wp - 2), torch.floor(y).clamp(max=Hp - 2)
    dx, dy = x - x0, y - y0
    flat = imgs.reshape(-1)
    i = idx.reshape(-1, *([1] * (x.dim() - 1))) * (Hp * Wp) \
        + y0.long() * Wp + x0.long()
    return (flat[i] * (1 - dx) * (1 - dy) + flat[i + 1] * dx * (1 - dy)
            + flat[i + Wp] * (1 - dx) * dy + flat[i + Wp + 1] * dx * dy)


def _rays(K, u):
    return torch.stack([(u[:, 0] - K[0, 2]) / K[0, 0],
                        (u[:, 1] - K[1, 2]) / K[1, 1],
                        torch.ones_like(u[:, 0])], -1)


def rematch(pb: dict, R, t, imgs, K, pad: int, p: dict):
    """(u_obs (M, 2), refined (M,) bool): the 2-D re-match of step 1.
    imgs: the window poses' padded images, in window order."""
    a, o, lm = pb["a"], pb["o"], pb["lm"][pb["l"]]
    u_ref = pb["u_ref"]
    M = u_ref.shape[0]
    dev, dt = u_ref.device, u_ref.dtype
    H, W = imgs.shape[1] - 2 * pad, imgs.shape[2] - 2 * pad
    radius, hp = int(p["rematch_radius"]), HALF_PATCH
    # The observation's pixel predicted from the staged state.
    p_w = (R[a] @ (_rays(K, u_ref) / lm[:, None])[..., None])[..., 0] + t[a]
    p_o = (R[o].transpose(-1, -2) @ (p_w - t[o])[..., None])[..., 0]
    z = torch.where(p_o[:, 2] != 0, p_o[:, 2], torch.ones_like(p_o[:, 2]))
    u_pred = torch.stack([K[0, 0] * p_o[:, 0] / z + K[0, 2],
                          K[1, 1] * p_o[:, 1] / z + K[1, 2]], -1)

    r = radius + hp
    offs = torch.arange(-r, r + 1, device=dev).to(dt)
    n = 2 * r + 1
    win = _bilinear(imgs, o,
                    (u_pred[:, 0, None, None] + offs[None, None, :] + pad)
                    .expand(M, n, n),
                    (u_pred[:, 1, None, None] + offs[None, :, None] + pad)
                    .expand(M, n, n))
    poffs = torch.arange(-hp, hp + 1, device=dev).to(dt)
    m = 2 * hp + 1
    patch = _bilinear(imgs, a,
                      (u_ref[:, 0, None, None] + poffs[None, None, :] + pad)
                      .expand(M, m, m),
                      (u_ref[:, 1, None, None] + poffs[None, :, None] + pad)
                      .expand(M, m, m))
    c = 2 * radius + 1
    # costs[m, cy, cx]: the patch against the window at centre (cy, cx).
    cols = win.unfold(1, m, 1).unfold(2, m, 1)  # (M, c, c, m, m)
    costs = ((cols - patch[:, None, None]) ** 2).sum((-1, -2))
    flat = costs.reshape(M, c * c)
    best = flat.argmin(1)
    by, bx = best // c, best % c
    cmin = flat.gather(1, best[:, None])[:, 0]
    byc, bxc = by.clamp(1, c - 2), bx.clamp(1, c - 2)
    ii = torch.arange(M, device=dev)

    def step(cm, c0, cp):
        den = cm - 2 * c0 + cp
        s = torch.where(den > 1e-12, 0.5 * (cm - cp) / den.clamp(min=1e-12),
                        torch.zeros_like(den))
        return s.clamp(-0.5, 0.5)
    sx = step(costs[ii, byc, bxc - 1], costs[ii, byc, bxc],
              costs[ii, byc, bxc + 1])
    sy = step(costs[ii, byc - 1, bxc], costs[ii, byc, bxc],
              costs[ii, byc + 1, bxc])
    u_new = torch.stack([u_pred[:, 0] + (bx.to(dt) - radius) + sx,
                         u_pred[:, 1] + (by.to(dt) - radius) + sy], -1)
    interior = (by >= 1) & (by <= c - 2) & (bx >= 1) & (bx <= c - 2)
    inside = ((u_pred[:, 0] >= r) & (u_pred[:, 0] < W - r)
              & (u_pred[:, 1] >= r) & (u_pred[:, 1] < H - r))
    gx = 0.5 * (patch[:, 1:-1, 2:] - patch[:, 1:-1, :-2])
    gy = 0.5 * (patch[:, 2:, 1:-1] - patch[:, :-2, 1:-1])
    sxx, syy, sxy = ((g * h).sum((1, 2)) for g, h in
                     ((gx, gx), (gy, gy), (gx, gy)))
    half_tr = 0.5 * (sxx + syy)
    lam_min = half_tr - (half_tr ** 2 - (sxx * syy - sxy ** 2)) \
        .clamp(min=0).sqrt()
    refined = (pb["valid"] & interior & inside
               & (cmin <= p["rematch_max_cost"])
               & (lam_min >= p["rematch_min_eig"]))
    return torch.where(refined[:, None], u_new, pb["u_obs"]), refined


def _residuals(pb, R, t, lm, u_obs, K, delta, jac=True):
    """r (M, 2), weights w (M,) and the rows of J (M, 2, 6P + L); J is
    None unless jac."""
    a, o, li = pb["a"], pb["o"], pb["l"]
    P, L, M = R.shape[0], lm.shape[0], a.shape[0]
    ray = _rays(K, pb["u_ref"])
    d = lm[li]
    depth = 1.0 / d.clamp(min=1e-6)
    p_w = (R[a] @ (ray * depth[:, None])[..., None])[..., 0] + t[a]
    RoT = R[o].transpose(-1, -2)
    p_o = (RoT @ (p_w - t[o])[..., None])[..., 0]
    x, y, z = p_o.unbind(-1)
    zs = torch.where(z.abs() > 1e-6, z, torch.full_like(z, 1e-6))
    fx, fy = K[0, 0], K[1, 1]
    r = torch.stack([fx * x / zs + K[0, 2], fy * y / zs + K[1, 2]], -1) \
        - u_obs
    zero = torch.zeros_like(z)
    dz = torch.where(z.abs() > 1e-6, -1 / zs ** 2, zero)
    rn = r.norm(dim=-1)
    w = torch.where(rn <= delta, torch.ones_like(rn),
                    delta / rn.clamp(min=1e-12))
    w = torch.where(pb["valid"] & (z > 1e-3), w, torch.zeros_like(w))
    if not jac:
        return r, w, None
    Jp = torch.stack([torch.stack([fx / zs, zero, fx * x * dz], -1),
                      torch.stack([zero, fy / zs, fy * y * dz], -1)], -2)
    eye = torch.eye(3, dtype=R.dtype, device=R.device).expand(M, 3, 3)
    # p_w moves by v + w x p_w under the anchor's perturbation; p_o by
    # R_o^T times that, and by minus that under the observer's.
    Ja = Jp @ RoT @ torch.cat([eye, -hat(p_w)], -1)
    dd = RoT @ (R[a] @ ray[..., None]) \
        * torch.where(d > 1e-6, -depth ** 2, zero)[:, None, None]
    Jd = (Jp @ dd)[..., 0]
    J = torch.zeros((M, 2, 6 * P + L), dtype=R.dtype, device=R.device)
    rows = torch.arange(M, device=R.device)[:, None]
    six = torch.arange(6, device=R.device)
    for idx, blk in ((a, Ja), (o, -Ja)):
        cols = 6 * idx[:, None] + six
        for k in range(2):
            J[:, k].index_put_((rows.expand(M, 6), cols), blk[:, k],
                               accumulate=True)
    J[torch.arange(M, device=R.device), :, 6 * P + li] = Jd
    return r, w, J


def _decoded(buf, P, L, M, dtype, device) -> dict:
    pb = decode(torch.as_tensor(buf), P, L, M)
    return {k: v.to(device).to(dtype) if v.is_floating_point()
            else v.to(device) for k, v in pb.items()}


def cost_at(buf, P: int, L: int, M: int, K, p: dict, R, t, lm,
            u_obs) -> torch.Tensor:
    """Step 3's cost in float64 of the upload's problem at the given
    poses R (P, 3, 3), t (P, 3), inverse depths lm (L,) and observed
    pixels u_obs (M, 2)."""
    K = torch.as_tensor(K).double()
    pb = _decoded(buf, P, L, M, torch.float64, K.device)
    r, w, _ = _residuals(pb, R.double(), t.double(), lm.double(),
                         u_obs.double(), K, p["huber_delta"], jac=False)
    return 0.5 * (w * (r * r).sum(-1)).sum()


def _solve_linear(A, b):
    if A.dtype in (torch.float64, torch.float32):
        return torch.linalg.solve(A, b)
    return torch.linalg.solve(A.float(), b.float()).to(A.dtype)


def _solve_reduced(A, b, n: int):
    """A x = b with the unknowns past the first n eliminated first: A's
    block over them is diagonal (each landmark is one scalar, and no
    observation sees two), so x[:n] solves the Schur complement
    A[:n, :n] - A[:n, n:] D^-1 A[n:, :n] and x[n:] follows by
    back-substitution."""
    d = torch.diagonal(A)[n:]
    B = A[:n, n:]
    S = A[:n, :n] - (B / d) @ B.T
    xp = _solve_linear(S, b[:n] - B @ (b[n:] / d))
    return torch.cat([xp, (b[n:] - B.T @ xp) / d])


def solve(buf, P: int, L: int, M: int, K, p: dict, images=None,
          pad: int = 0, dtype=torch.float64, schur=False) -> dict:
    """One window solve of the upload buf (int32) in `dtype`: returns
    R (P, 3, 3), t (P, 3), lm (L,), cost, u_obs (M, 2) after the
    re-match, refined (M,) bool and lm_info (L,), each landmark's
    Gauss-Newton information at the result, sum w |dr/dd|^2. K: the
    camera (3, 3); p: the BAParams fields by name; images: the window
    poses' uint8 frames in window order (needed when p["do_rematch"]),
    padded by `pad`. schur: solve each step's normal equations by the
    Schur complement of the landmark block, as the port does, instead
    of at once."""
    if p.get("aniso_weights"):
        raise NotImplementedError("the reference has no anisotropic weights")
    dev = K.device if isinstance(K, torch.Tensor) else torch.device("cpu")
    pb = _decoded(buf, P, L, M, dtype, dev)
    K = torch.as_tensor(K).to(dev).to(dtype)
    R, t = quat_to_rot(pb["q"]), pb["t"]
    R_pr, t_pr = quat_to_rot(pb["prior_q"]), pb["prior_t"]
    lm = pb["lm"]
    u_obs, refined = pb["u_obs"], torch.zeros_like(pb["valid"])
    if p["do_rematch"]:
        imgs = pad_images(images, pad, dtype, dev)
        u_obs, refined = rematch(pb, R, t, imgs, K, pad, p)
    n_pose = 6 * P
    wp, lam = float(p["pose_prior_weight"]), float(p["damping"])
    for _ in range(int(p["n_gn_iters"])):
        r, w, J = _residuals(pb, R, t, lm, u_obs, K, p["huber_delta"])
        Jf = J.reshape(2 * M, n_pose + L)
        wr = (w[:, None] * r).reshape(2 * M)
        H = Jf.T @ (w.repeat_interleave(2)[:, None] * Jf)
        g = Jf.T @ wr
        if wp > 0:
            # Prior residual log(T T_prior^-1), its Jacobian the identity.
            Rd = R @ R_pr.transpose(-1, -2)
            e = se3_log(Rd, t - (Rd @ t_pr[..., None])[..., 0])
            g[:n_pose] = g[:n_pose] + wp * e.reshape(-1)
            H[:n_pose, :n_pose] = H[:n_pose, :n_pose] \
                + wp * torch.eye(n_pose, dtype=dtype, device=dev)
        hll = torch.diagonal(H)[n_pose:]
        free = torch.cat([torch.arange(n_pose, device=dev) >= 6 * N_FIXED,
                          (hll > 1e-12) & pb["lm_valid"]])
        idx = free.nonzero()[:, 0]
        A = H[idx][:, idx] + lam * torch.eye(idx.numel(), dtype=dtype,
                                             device=dev)
        dx = torch.zeros(n_pose + L, dtype=dtype, device=dev)
        n_free = int(free[:n_pose].sum())
        dx[idx] = -(_solve_reduced(A, g[idx], n_free) if schur
                    else _solve_linear(A, g[idx]))
        Re, te = se3_exp(dx[:n_pose].reshape(P, 6))
        R, t = Re @ R, (Re @ t[..., None])[..., 0] + te
        lm = torch.where(pb["lm_valid"],
                         (lm + dx[n_pose:]).clamp(1e-4, 1e3), lm)
    r, w, J = _residuals(pb, R, t, lm, u_obs, K, p["huber_delta"])
    cost = 0.5 * (w * (r * r).sum(-1)).sum()
    lm_info = (w[:, None, None] * J[:, :, n_pose:] ** 2).sum((0, 1))
    return dict(R=R, t=t, lm=lm, cost=cost, u_obs=u_obs, refined=refined,
                lm_info=lm_info)
