"""Run flame_tpu_torch on a TUM RGB-D or EuRoC directory.

    python -m flame_tpu_torch.run_dataset --format tum --root DIR \\
        --fx 517.3 --fy 516.5 --cx 318.6 --cy 255.3 [--frames 200] [--ba]
    python -m flame_tpu_torch.run_dataset --format euroc --root DIR \\
        --fx 458.65 --fy 457.30 --cx 367.22 --cy 248.38

The port's counterpart of examples/run_dataset.py, with its flags and
Params (async topology, 60 smoother iterations per frame, --ba for
windowed bundle adjustment), except that BA's 2-D re-match radius grows
with --fx (rematch_radius). It runs on the card; --cpu runs it on the
CPU. Writes colormapped idepth and wireframe renders of the final frame
(PPM) to --out.
"""

import argparse
import json
import math
import os
import sys

import numpy as np

# The focal length (px) of mini-TUM at 256x192, where BAParams'
# rematch_radius of 3 px was tuned against 15 mm / 0.3 deg pose noise.
REMATCH_FX = 210.0


def write_ppm(path: str, rgb) -> None:
    rgb = np.asarray(rgb, np.uint8)
    with open(path, "wb") as f:
        f.write(b"P6\n%d %d\n255\n" % (rgb.shape[1], rgb.shape[0]))
        f.write(rgb.tobytes())


def rematch_radius(fx: float) -> int:
    """BA's re-match radius for focal length fx: BAParams' 3 px scaled by
    fx / REMATCH_FX, rounded up, never below 3. A pose error moves the
    projections in proportion to fx, so the examples' fixed 3 px misses
    the true match at TUM's fx=517.3 (8 px there)."""
    from flame_tpu_torch import BAParams
    base = BAParams.rematch_radius
    return max(base, math.ceil(base * fx / REMATCH_FX))


def make_params(do_ba: bool, fx: float, min_height: float = -1e6,
                max_height: float = 1e6):
    """examples/run_dataset.py's Params (async topology, 60 smoother
    iterations per frame, the other fields at their defaults) with the
    re-match radius of rematch_radius(fx)."""
    from flame_tpu_torch import BAParams, Params, SolverParams
    return Params(min_height=min_height, max_height=max_height, do_ba=do_ba,
                  ba=BAParams(rematch_radius=rematch_radius(fx)),
                  solver=SolverParams(n_iters_per_frame=60,
                                      async_topology=True),
                  debug_quiet=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--format", choices=("tum", "euroc"), required=True)
    ap.add_argument("--root", required=True)
    ap.add_argument("--fx", type=float, required=True)
    ap.add_argument("--fy", type=float, required=True)
    ap.add_argument("--cx", type=float, required=True)
    ap.add_argument("--cy", type=float, required=True)
    ap.add_argument("--frames", type=int, default=None)
    ap.add_argument("--poseframe-every", type=int, default=4)
    ap.add_argument("--out", default="flame_dataset_out")
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--ba", action="store_true")
    ap.add_argument("--min-height", type=float, default=-1e6)
    ap.add_argument("--max-height", type=float, default=1e6)
    args = ap.parse_args(argv)

    from flame_tpu_torch import Flame
    from flame_tpu_torch.geometry import camera
    from flame_tpu_torch.io import datasets

    if args.format == "tum":
        frames = datasets.load_tum(args.root, max_frames=args.frames)
    else:
        frames = datasets.load_euroc(args.root, max_frames=args.frames)
    if not frames:
        print("no frames loaded", file=sys.stderr)
        return 1
    H, W = frames[0].load_image().shape
    print(f"loaded {len(frames)} frames at {W}x{H}")

    params = make_params(args.ba, args.fx, args.min_height, args.max_height)
    K = camera.make_k(args.fx, args.fy, args.cx, args.cy)
    fl = Flame(W, H, K, camera.inv_k(K), params,
               device="cpu" if args.cpu else "cuda")
    out = datasets.run_sequence(fl, frames,
                                poseframe_every=args.poseframe_every,
                                progress=True)
    print(json.dumps({k: v for k, v in out.items() if k != "timings_ms"},
                     indent=2))

    os.makedirs(args.out, exist_ok=True)
    write_ppm(os.path.join(args.out, "idepthmap.ppm"),
              fl.get_debug_image_idepthmap())
    write_ppm(os.path.join(args.out, "wireframe.ppm"),
              fl.get_debug_image_wireframe())
    print(f"renders written to {args.out}/")
    return 0


if __name__ == "__main__":
    sys.exit(main())
