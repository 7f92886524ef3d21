"""The benchmark's one scene generator: a textured box seen from inside.

A torch rewrite of flame_tpu_torch/io/synthetic.py's ray-cast corridor
(the same multi-octave value-noise texture with smoothstep interpolation
on a 256 x 256 wrap-around lattice per octave), generalised to any
axis-aligned box and run on the card. A configuration's "scene" block
gives the box, the texture (with its own seed: the scene is part of the
deployment) and a periodic trajectory. The benchmark's --seed picks
where on the trajectory a run starts and draws the pose noise, so every
seed replays the same frames in another order.

Camera convention (as the port's): +x right, +y down, +z forward; poses
are camera-to-world (q wxyz, t). From inside a convex box every ray
leaves through exactly one face, the nearest of the three planes that
its direction points at, so the ray cast is three divisions and a min.

The texture frequency grows with the focal length (base_scale_per_m *
fx / ref_fx): at ref_fx, mini-TUM's focal length, the lattice cells per
pixel are what the port was tuned on, and a longer focal length would
otherwise see a blurrier wall.
"""

import math

import numpy as np
import torch

LATTICE = 256
# Faces in order: x-min, x-max, y-min, y-max, z-min, z-max; the two
# texture axes of each face are the box axes other than its normal.
_TEX_AXES = {0: (1, 2), 1: (0, 2), 2: (0, 1)}


def _quat_mul(a, b):
    w1, x1, y1, z1 = a
    w2, x2, y2, z2 = b
    return np.array([w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
                     w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
                     w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
                     w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2])


def quat_to_rot(q) -> np.ndarray:
    w, x, y, z = q
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)]])


def period_frames(cfg: dict) -> int:
    """Frames in one period of the trajectory at the camera's rate."""
    return int(round(cfg["scene"]["period_s"] * cfg["camera"]["hz"]))


def true_pose(cfg: dict, i: int):
    """Frame i's camera-to-world pose (q wxyz, t), float64: position
    center + amp * sin(2 pi cycles s + phase) per axis and a yaw (about
    +y) then pitch (about +x) rotation of the same form, s the phase of
    frame i in the period."""
    tr = cfg["scene"]["trajectory"]
    s = (i % period_frames(cfg)) / period_frames(cfg)

    def wave(amp, cycles, phase):
        return np.asarray(amp, np.float64) * np.sin(
            2 * np.pi * np.asarray(cycles, np.float64) * s
            + np.asarray(phase, np.float64))

    t = np.asarray(tr["center"], np.float64) + wave(
        tr["amp_m"], tr["cycles"], tr["phase"])
    yaw = math.radians(float(wave(tr["yaw_amp_deg"], tr["yaw_cycles"],
                                  tr["yaw_phase"])))
    pitch = math.radians(float(wave(tr["pitch_amp_deg"], tr["pitch_cycles"],
                                    tr["pitch_phase"])))
    q_yaw = np.array([math.cos(yaw / 2), 0.0, math.sin(yaw / 2), 0.0])
    q_pitch = np.array([math.cos(pitch / 2), math.sin(pitch / 2), 0.0, 0.0])
    return _quat_mul(q_yaw, q_pitch), t


def motion_stats(cfg: dict):
    """Mean speed (m/s) and mean rotation rate (deg/s) over one period."""
    n = period_frames(cfg)
    hz = cfg["camera"]["hz"]
    poses = [true_pose(cfg, i) for i in range(n + 1)]
    dist = sum(np.linalg.norm(poses[i + 1][1] - poses[i][1])
               for i in range(n))
    ang = 0.0
    for i in range(n):
        qa, qb = poses[i][0], poses[i + 1][0]
        c = min(1.0, abs(float(np.dot(qa, qb))))
        ang += 2 * math.degrees(math.acos(c))
    return dist * hz / n, ang * hz / n


def start_frame(cfg: dict, seed: int) -> int:
    """Where on the trajectory a run with this seed starts."""
    return int(np.random.default_rng([seed, 3]).integers(period_frames(cfg)))


def noisy_poses(cfg: dict, n: int, sigma_t: float, sigma_deg: float,
                seed: int, start: int = 0):
    """Input poses of frames start..start+n-1: the true pose with i.i.d.
    noise per frame, sigma_t metres on each axis of t and a rotation of
    sigma_deg * N(0, 1) about a uniformly random axis (io/synthetic.py's
    model), drawn from seed. The true poses repeat with the period's P
    frames, so each is computed once and indexed mod P."""
    rng = np.random.default_rng([seed, 1])
    P = period_frames(cfg)
    period = {}
    out = []
    for i in range(start, start + n):
        j = i % P
        if j not in period:
            period[j] = true_pose(cfg, j)
        q, t = period[j]
        if sigma_t or sigma_deg:
            t = t + rng.normal(0.0, sigma_t, 3)
            ang = math.radians(sigma_deg) * rng.normal()
            ax = rng.normal(size=3)
            ax /= np.linalg.norm(ax)
            q = _quat_mul(q, np.array([math.cos(ang / 2),
                                       *(math.sin(ang / 2) * ax)]))
        out.append((q, t))
    return out


class Scene:
    """The box of cfg["scene"] with its textures drawn from the texture's
    seed on device; render(indices) ray-casts frames of the trajectory."""

    def __init__(self, cfg: dict, device):
        self.cfg = cfg
        cam, sc = cfg["camera"], cfg["scene"]
        self.device = torch.device(device)
        self.W, self.H = int(cam["width"]), int(cam["height"])
        self.fx, self.fy = float(cam["fx"]), float(cam["fy"])
        self.cx, self.cy = float(cam["cx"]), float(cam["cy"])
        box = sc["box"]
        self.lo = torch.tensor([box["x"][0], box["y"][0], box["z"][0]],
                               dtype=torch.float32, device=self.device)
        self.hi = torch.tensor([box["x"][1], box["y"][1], box["z"][1]],
                               dtype=torch.float32, device=self.device)
        tex = sc["texture"]
        self.octaves = int(tex["octaves"])
        self.scale = float(tex["base_scale_per_m"]) * self.fx \
            / float(tex["ref_fx"])
        self.persistence = float(tex["persistence"])
        g = torch.Generator(device=self.device)
        g.manual_seed(int(tex["seed"]))
        # One lattice per face and octave, drawn in one call.
        self.lattice = torch.rand((6 * self.octaves, LATTICE, LATTICE),
                                  generator=g, device=self.device) * 2 - 1
        vv, uu = torch.meshgrid(
            torch.arange(self.H, dtype=torch.float32, device=self.device),
            torch.arange(self.W, dtype=torch.float32, device=self.device),
            indexing="ij")
        self.rays = torch.stack([(uu - self.cx) / self.fx,
                                 (vv - self.cy) / self.fy,
                                 torch.ones_like(uu)], dim=-1)  # (H, W, 3)

    def _noise(self, lat_idx, u, v):
        """Smoothstep-bilinear wrap-around sample of the lattices lat_idx
        (broadcast with u, v)."""
        n = LATTICE
        u = torch.remainder(u, n)
        v = torch.remainder(v, n)
        u0 = torch.floor(u)
        v0 = torch.floor(v)
        fu = u - u0
        fv = v - v0
        u0 = u0.long() % n
        v0 = v0.long() % n
        u1 = (u0 + 1) % n
        v1 = (v0 + 1) % n
        fu = fu * fu * (3 - 2 * fu)
        fv = fv * fv * (3 - 2 * fv)
        lat = self.lattice
        a = lat[lat_idx, v0, u0] * (1 - fu) + lat[lat_idx, v0, u1] * fu
        b = lat[lat_idx, v1, u0] * (1 - fu) + lat[lat_idx, v1, u1] * fu
        return a * (1 - fv) + b * fv

    def render(self, indices):
        """uint8 images (B, H, W) and float32 inverse depth (B, H, W) of
        frames `indices` of the true trajectory."""
        poses = [true_pose(self.cfg, int(i)) for i in indices]
        dev = self.device
        R = torch.as_tensor(np.stack([quat_to_rot(q) for q, _ in poses]),
                            dtype=torch.float32, device=dev)  # (B, 3, 3)
        o = torch.as_tensor(np.stack([t for _, t in poses]),
                            dtype=torch.float32, device=dev)  # (B, 3)
        d = torch.einsum("bij,hwj->bhwi", R, self.rays)  # world directions
        ob = o[:, None, None, :]
        # Per axis, the plane the direction points at and its distance.
        plane = torch.where(d > 0, self.hi, self.lo)
        safe = torch.where(d.abs() > 1e-12, d, torch.full_like(d, 1e-12))
        th = (plane - ob) / safe
        th = torch.where(d.abs() > 1e-12, th,
                         torch.full_like(th, float("inf")))
        th_min, axis = torch.min(th, dim=-1)  # (B, H, W)
        pt = ob + th_min[..., None] * d
        face = 2 * axis + (torch.gather(d, -1, axis[..., None])[..., 0]
                           > 0).long()
        ta = torch.tensor([_TEX_AXES[a][0] for a in range(3)], device=dev)
        tb = torch.tensor([_TEX_AXES[a][1] for a in range(3)], device=dev)
        pu = torch.gather(pt, -1, ta[axis][..., None])[..., 0]
        pv = torch.gather(pt, -1, tb[axis][..., None])[..., 0]
        out = torch.zeros_like(pu)
        amp, total = 1.0, 0.0
        for k in range(self.octaves):
            s = self.scale * (2.0 ** k)
            out = out + amp * self._noise(face * self.octaves + k,
                                          pu * s, pv * s)
            total += amp
            amp *= self.persistence
        val = torch.clamp(128 + 120 * (out / total), 0, 255)
        # The camera ray's z component is 1, so th is the camera depth.
        return val.to(torch.uint8), (1.0 / th_min).float()

    def render_host(self, indices, chunk: int = 16) -> np.ndarray:
        """The frames' uint8 images on the host, (B, H, W), rendered on
        the device in chunks of `chunk` frames."""
        indices = list(indices)
        out = np.empty((len(indices), self.H, self.W), np.uint8)
        for s in range(0, len(indices), chunk):
            img, _ = self.render(indices[s:s + chunk])
            out[s:s + img.shape[0]] = img.cpu().numpy()
        return out
