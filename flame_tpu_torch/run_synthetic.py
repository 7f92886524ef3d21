"""Dense inverse-depth mesh estimation on a synthetic posed sequence.

    python -m flame_tpu_torch.run_synthetic [--frames 20] [--out DIR]
    python -m flame_tpu_torch.run_synthetic --cpu

The port's counterpart of examples/run_synthetic.py, with its flags,
scene and Params: a textured fronto-parallel plane at 5 m seen by a
camera translating sideways 12 cm per frame, every second frame a
poseframe. The true inverse depth is 0.2 everywhere, so the printed
median relative error is the map's accuracy. It runs on the card; --cpu
runs it on the CPU. Writes the idepth, wireframe, feature and normal
debug renders of the final frame (PPM) to --out.
"""

import argparse
import os
import time

import numpy as np

from flame_tpu_torch.run_dataset import write_ppm

PLANE_Z = 5.0


def make_params(do_ba: bool):
    """examples/run_synthetic.py's Params."""
    from flame_tpu_torch import DetectionParams, Params, SolverParams
    return Params(
        feature_capacity=2048, edge_capacity=8192, triangle_capacity=6144,
        poseframe_capacity=8, min_height=-1e6, max_height=1e6,
        idepth_init=0.05, do_ba=do_ba,
        detection=DetectionParams(win_size=16),
        solver=SolverParams(n_iters_per_frame=40), debug_quiet=True)


def renderer(width: int, height: int, fx: float):
    """render(cam_x): the plane's uint8 image with the camera at
    (cam_x, 0, 0)."""
    vv, uu = np.mgrid[0:height, 0:width].astype(np.float64)
    s = fx / 100.0

    def render(cam_x):
        X = (uu - width / 2) * PLANE_Z / fx + cam_x
        Y = (vv - height / 2) * PLANE_Z / fx
        tex = (128 + 60 * np.sin(4.1 * s * X + 0.9 * s * Y)
               + 35 * np.cos(1.73 * s * X) + 18 * np.sin(2.31 * s * Y))
        return np.clip(tex, 0, 255).astype(np.uint8)
    return render


def main(argv=None) -> float:
    """Runs the demo; returns the final map's median relative error."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--frames", type=int, default=20)
    ap.add_argument("--out", default="flame_synthetic_out")
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--width", type=int, default=320)
    ap.add_argument("--height", type=int, default=240)
    ap.add_argument("--ba", action="store_true", help="enable windowed BA")
    args = ap.parse_args(argv)

    from flame_tpu_torch import Flame
    from flame_tpu_torch.geometry import camera

    W, H = args.width, args.height
    fx = W / 1.6
    render = renderer(W, H, fx)
    K = camera.make_k(fx, fx, W / 2, H / 2)
    fl = Flame(W, H, K, camera.inv_k(K), make_params(args.ba),
               device="cpu" if args.cpu else "cuda")

    t0 = time.perf_counter()
    for i in range(args.frames):
        cam_x = 0.12 * i
        pose = (np.array([1.0, 0.0, 0.0, 0.0]), np.array([cam_x, 0.0, 0.0]))
        ok = fl.update(i / 30.0, i, pose, render(cam_x), i % 2 == 0)
        print(f"frame {i:3d}: ok={ok} feats={fl._n_valid} "
              f"coverage={fl.coverage():.2f}")
    dt = time.perf_counter() - t0
    print(f"\n{args.frames} frames in {dt:.1f}s "
          f"({args.frames / dt:.1f} fps incl. the first frames' set-up)")

    idm = fl.get_inverse_depth_map()
    err = float(np.median(np.abs(idm[~np.isnan(idm)] - 1 / PLANE_Z)
                          * PLANE_Z))
    print(f"median relative depth error: {err:.4f}")

    os.makedirs(args.out, exist_ok=True)
    for name in ("idepthmap", "wireframe", "features", "normals"):
        write_ppm(os.path.join(args.out, f"{name}.ppm"),
                  getattr(fl, f"get_debug_image_{name}")())
    print(f"debug renders written to {args.out}/")
    return err


if __name__ == "__main__":
    main()
