"""The batched step through the JAX package and the port on the CPU, on
tests/torch_multihost_worker.py's 160x120 scene (512 features,
frame_batch=4, async topology, deterministic, uint8 frames).

    python tests/torch_batch_witness.py [--frames 16 20] [--evict]

For each frame count, two pairs of runs: flame_tpu ShardedFlame on 2
virtual CPU devices against flame_tpu_torch ShardedFlame on make_mesh(2)
(equal to the port's run over a two-rank group, which
tests/test_torch_multihost.py checks bit for bit), and flame_tpu.Flame
against flame_tpu_torch.Flame. --evict adds the worker's eviction
posture (4 poseframe slots, photo_error_num_pfs=30). Prints per pair the
batched steps, the final maps' coverage, IoU and median relative
|d idepth|, and the first frame whose feature count differs (a match or
detection decision flipped on float noise). A minute or two, most of it
the JAX package's compiles.
"""

import argparse
import dataclasses
import os
import sys

os.environ.setdefault("JAX_PLATFORMS", "cpu")
if "xla_force_host_platform_device_count" not in os.environ.get(
        "XLA_FLAGS", ""):
    os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "") +
                               " --xla_force_host_platform_device_count=2")
sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                ".."))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import flame_tpu_torch  # noqa: E402
from flame_tpu.core.flame import Flame as JFlame  # noqa: E402
from flame_tpu.geometry import camera, se3  # noqa: E402
from flame_tpu.parallel import sharding as jsharding  # noqa: E402
from flame_tpu.parallel.orchestrator import \
    ShardedFlame as JShardedFlame  # noqa: E402
from flame_tpu_torch import convert  # noqa: E402
from flame_tpu_torch.parallel import sharding  # noqa: E402
from flame_tpu_torch.parallel.orchestrator import ShardedFlame  # noqa: E402

FX = 100.0
W, H = 160, 120
PLANE_Z = 5.0


def render(cam_x):
    vv, uu = np.mgrid[0:H, 0:W].astype(np.float64)
    X = (uu - W / 2) * PLANE_Z / FX + cam_x
    Y = (vv - H / 2) * PLANE_Z / FX
    tex = (128 + 60 * np.sin(4.1 * X + 0.9 * Y) + 35 * np.cos(1.73 * X)
           + 18 * np.sin(2.31 * Y) + 10 * np.sin(0.83 * X))
    return np.clip(tex.astype(np.float32), 0, 255).astype(np.uint8)


def jax_params(evict):
    from flame_tpu.params import DetectionParams, Params, SolverParams
    return Params(
        feature_capacity=512, edge_capacity=2048, triangle_capacity=1024,
        poseframe_capacity=4 if evict else 8,
        photo_error_num_pfs=30 if evict else 0, min_height=-100.0,
        max_height=100.0, idepth_init=0.05, idepth_var_init=0.25,
        detection=DetectionParams(win_size=16),
        solver=SolverParams(n_iters_per_frame=30, max_vertex_degree=16,
                            frame_batch=4, async_topology=True,
                            deterministic=True),
        debug_quiet=True)


def compare(a, b):
    ca, cb = ~np.isnan(a), ~np.isnan(b)
    both = ca & cb
    return (f"coverage {ca.mean():.4f} / {cb.mean():.4f}, IoU "
            f"{(ca & cb).sum() / max((ca | cb).sum(), 1):.4f}, median "
            f"relative |d| "
            f"{np.median(np.abs(a[both] - b[both]) / np.abs(b[both])):.4f}")


def run_pair(label, port, ref, n_frames):
    first_diff = None
    for i in range(n_frames):
        cam_x = 0.15 * i
        img = render(cam_x)
        port.update(i * 0.1, i, (np.array([1.0, 0, 0, 0]),
                                 np.array([cam_x, 0.0, 0.0])), img,
                    i % 2 == 0)
        ref.update(i * 0.1, i, (se3.quat_identity(),
                                jnp.array([cam_x, 0.0, 0.0])), img,
                   i % 2 == 0)
        if first_diff is None and port._n_valid != ref._n_valid:
            first_diff = i
    a, b = port.get_inverse_depth_map(), ref.get_inverse_depth_map()
    print(f"{label}, {n_frames} frames: batched steps {port._dispatches} "
          f"/ {ref._dispatches} (port / JAX); {compare(a, b)}; feature "
          f"counts first differ at frame {first_diff}", flush=True)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, nargs="+", default=[16, 20])
    ap.add_argument("--evict", action="store_true")
    args = ap.parse_args()
    jp = jax_params(args.evict)
    tp = convert.params_from_dict(dataclasses.asdict(jp))
    K = np.array([[FX, 0, W / 2], [0, FX, H / 2], [0, 0, 1]], np.float32)
    Kinv = np.linalg.inv(K.astype(np.float64)).astype(np.float32)
    jK = camera.make_k(FX, FX, W / 2, H / 2)
    posture = "eviction" if args.evict else "no eviction"
    for n in args.frames:
        run_pair(f"ShardedFlame, 2 partitions, {posture}",
                 ShardedFlame(W, H, K, Kinv, tp,
                              mesh=sharding.make_mesh(2, "cpu"),
                              device="cpu"),
                 JShardedFlame(W, H, jK, camera.inv_k(jK), jp,
                               mesh=jsharding.make_mesh(jax.devices()[:2])),
                 n)
        run_pair(f"Flame, {posture}",
                 flame_tpu_torch.Flame(W, H, K, Kinv, tp, device="cpu"),
                 JFlame(W, H, jK, camera.inv_k(jK), jp), n)


if __name__ == "__main__":
    main()
