"""Dataset frontends: posed monocular sequences from standard formats.

A copy of flame_tpu/io/datasets.py whose images are read through
io/png.py (8-bit gray, RGB or RGBA PNG, converted to gray as PIL's
convert("L") does) instead of PIL.

The reference is a library whose I/O lived in a separate ROS package
(flame_ros, README.md:11-15). flame_tpu ships the equivalent frontend as
plain file readers for the two dataset families named by the benchmark
configs (BASELINE.json): TUM RGB-D format and EuRoC MAV format, plus a
pose-interpolating associator. Each loader yields FrameRecord items ready
for Flame.update (grayscale uint8 image + camera-to-world (q wxyz, t)).

Camera intrinsics must be supplied by the caller (both formats keep them
in out-of-band calibration files with several conventions; see
`tum_default_intrinsics` for the common TUM fr1/fr2/fr3 values).
"""

import bisect
import csv
import os
from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np

from flame_tpu_torch.io import png


@dataclass
class FrameRecord:
    time: float
    frame_id: int
    q: np.ndarray  # (4,) wxyz camera-to-world
    t: np.ndarray  # (3,)
    image_path: str

    def load_image(self) -> np.ndarray:
        return png.read_gray(self.image_path)


def tum_default_intrinsics(sequence: str = "fr1"):
    """The TUM RGB-D defaults (fx, fy, cx, cy) per freiburg sequence set."""
    table = {
        "fr1": (517.3, 516.5, 318.6, 255.3),
        "fr2": (520.9, 521.0, 325.1, 249.7),
        "fr3": (535.4, 539.2, 320.1, 247.6),
    }
    return table[sequence]


# ---------------------------------------------------------------------------
# Pose interpolation / association.
# ---------------------------------------------------------------------------


def _slerp(q0, q1, u):
    d = float(np.dot(q0, q1))
    if d < 0:
        q1 = -q1
        d = -d
    if d > 0.9995:
        q = q0 + u * (q1 - q0)
        return q / np.linalg.norm(q)
    th = np.arccos(np.clip(d, -1, 1))
    return (np.sin((1 - u) * th) * q0 + np.sin(u * th) * q1) / np.sin(th)


class PoseTrack:
    """Timestamped pose track with slerp/lerp interpolation."""

    def __init__(self, times: Sequence[float], qs: np.ndarray,
                 ts: np.ndarray):
        order = np.argsort(times)
        self.times = [float(times[i]) for i in order]
        self.qs = np.asarray(qs, np.float64)[order]
        self.ts = np.asarray(ts, np.float64)[order]

    def sample(self, t: float, max_gap: float = 0.25
               ) -> Optional[Tuple[np.ndarray, np.ndarray]]:
        """Interpolated pose at time t; None when outside the track or the
        bracketing gap exceeds max_gap seconds."""
        i = bisect.bisect_left(self.times, t)
        if i == 0:
            if abs(self.times[0] - t) > max_gap:
                return None
            return self.qs[0].copy(), self.ts[0].copy()
        if i >= len(self.times):
            if abs(t - self.times[-1]) > max_gap:
                return None
            return self.qs[-1].copy(), self.ts[-1].copy()
        t0, t1 = self.times[i - 1], self.times[i]
        if t1 - t0 > max_gap:
            return None
        u = 0.0 if t1 == t0 else (t - t0) / (t1 - t0)
        q = _slerp(self.qs[i - 1], self.qs[i], u)
        tr = (1 - u) * self.ts[i - 1] + u * self.ts[i]
        return q, tr


# ---------------------------------------------------------------------------
# TUM RGB-D format.
# ---------------------------------------------------------------------------


def load_tum(root: str, max_frames: Optional[int] = None,
             max_gap: float = 0.25) -> List[FrameRecord]:
    """TUM RGB-D directory: rgb.txt ("timestamp filename" lines, # comments)
    + groundtruth.txt ("timestamp tx ty tz qx qy qz qw")."""
    def parse_listing(path):
        out = []
        with open(path) as f:
            for line in f:
                line = line.strip()
                if not line or line.startswith("#"):
                    continue
                out.append(line.split())
        return out

    gt = parse_listing(os.path.join(root, "groundtruth.txt"))
    times = [float(r[0]) for r in gt]
    ts = np.array([[float(r[1]), float(r[2]), float(r[3])] for r in gt])
    # TUM stores qx qy qz qw; convert to wxyz.
    qs = np.array([[float(r[7]), float(r[4]), float(r[5]), float(r[6])]
                   for r in gt])
    track = PoseTrack(times, qs, ts)

    frames: List[FrameRecord] = []
    for i, row in enumerate(parse_listing(os.path.join(root, "rgb.txt"))):
        t = float(row[0])
        pose = track.sample(t, max_gap)
        if pose is None:
            continue
        q, tr = pose
        frames.append(FrameRecord(
            time=t, frame_id=len(frames), q=q.astype(np.float32),
            t=tr.astype(np.float32),
            image_path=os.path.join(root, row[1])))
        if max_frames and len(frames) >= max_frames:
            break
    return frames


# ---------------------------------------------------------------------------
# EuRoC MAV format.
# ---------------------------------------------------------------------------


def load_euroc(root: str, cam: str = "cam0",
               max_frames: Optional[int] = None,
               max_gap: float = 0.25,
               T_body_cam: Optional[np.ndarray] = None) -> List[FrameRecord]:
    """EuRoC ASL directory: mav0/<cam>/data.csv (#timestamp [ns], filename)
    + mav0/state_groundtruth_estimate0/data.csv (body pose in world,
    p_RS_R_* and q_RS_* columns: qw qx qy qz).

    T_body_cam: optional 4x4 camera-to-body extrinsic T_BS (the
    sensor.yaml T_BS); identity when omitted.
    """
    mav = os.path.join(root, "mav0")
    gt_path = os.path.join(mav, "state_groundtruth_estimate0", "data.csv")
    times, qs, ts = [], [], []
    with open(gt_path) as f:
        for row in csv.reader(f):
            if not row or row[0].startswith("#"):
                continue
            times.append(float(row[0]) * 1e-9)
            ts.append([float(row[1]), float(row[2]), float(row[3])])
            qs.append([float(row[4]), float(row[5]), float(row[6]),
                       float(row[7])])  # already w x y z
    track = PoseTrack(times, np.array(qs), np.array(ts))

    def quat_mat(q):
        w, x, y, z = q
        return np.array([
            [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
            [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
            [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)]])

    def mat_quat(R):
        tr = np.trace(R)
        if tr > 0:
            s = 2 * np.sqrt(tr + 1)
            return np.array([s / 4, (R[2, 1] - R[1, 2]) / s,
                             (R[0, 2] - R[2, 0]) / s,
                             (R[1, 0] - R[0, 1]) / s])
        i = int(np.argmax(np.diag(R)))
        j, k = (i + 1) % 3, (i + 2) % 3
        s = 2 * np.sqrt(max(1 + R[i, i] - R[j, j] - R[k, k], 1e-12))
        q = np.zeros(4)
        q[0] = (R[k, j] - R[j, k]) / s
        q[1 + i] = s / 4
        q[1 + j] = (R[j, i] + R[i, j]) / s
        q[1 + k] = (R[k, i] + R[i, k]) / s
        return q / np.linalg.norm(q)

    frames: List[FrameRecord] = []
    cam_csv = os.path.join(mav, cam, "data.csv")
    with open(cam_csv) as f:
        for row in csv.reader(f):
            if not row or row[0].startswith("#"):
                continue
            t = float(row[0]) * 1e-9
            pose = track.sample(t, max_gap)
            if pose is None:
                continue
            q, tr = pose
            if T_body_cam is not None:
                Rwb = quat_mat(q)
                Twb = np.eye(4)
                Twb[:3, :3] = Rwb
                Twb[:3, 3] = tr
                Twc = Twb @ np.asarray(T_body_cam, np.float64)
                q = mat_quat(Twc[:3, :3])
                tr = Twc[:3, 3]
            frames.append(FrameRecord(
                time=t, frame_id=len(frames), q=q.astype(np.float32),
                t=tr.astype(np.float32),
                image_path=os.path.join(mav, cam, "data", row[1].strip())))
            if max_frames and len(frames) >= max_frames:
                break
    return frames


# ---------------------------------------------------------------------------
# Sequence runner.
# ---------------------------------------------------------------------------


def run_sequence(fl, frames: Sequence[FrameRecord],
                 poseframe_every: int = 4,
                 progress: bool = False) -> dict:
    """Feed a loaded sequence through a Flame instance; returns summary
    stats (frames processed, coverage, timings snapshot)."""
    import time as _time
    n_ok = 0
    t0 = _time.perf_counter()
    for i, fr in enumerate(frames):
        img = fr.load_image()
        ok = fl.update(fr.time, fr.frame_id, (fr.q, fr.t), img,
                       i % poseframe_every == 0)
        n_ok += bool(ok)
        if progress and i % 20 == 0:
            print(f"frame {i}/{len(frames)} ok={ok} "
                  f"coverage={fl.coverage():.2f}")
    dt = _time.perf_counter() - t0
    return {
        "n_frames": len(frames),
        "n_ok": n_ok,
        "fps": len(frames) / dt if dt > 0 else 0.0,
        "coverage": fl.coverage(),
        "timings_ms": fl.stats.snapshot()["timings_ms"],
    }
