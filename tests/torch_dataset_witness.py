"""The dataset path at TUM's resolution through the JAX package and the
port, on the CPU, on the input of chip_smoke.py's 640x480 dataset cell.

    python tests/torch_dataset_witness.py [--frames 48] [--last 16]
        [--only map|ate] [--ba-branch no_rematch|aniso_weights] [--mini]

mini-TUM is generated at 640x480 (fx=517.3, 15 mm / 0.3 deg pose noise,
noise_seed=1) and run through load_tum + run_sequence (a poseframe every
2 frames) into flame_tpu.Flame and flame_tpu_torch.Flame(device="cpu")
with examples/run_dataset.py's Params and the port's re-match radius
(flame_tpu_torch.run_dataset.rematch_radius):

  map  true poses with BA, once on the async schedule (the final map) and
       once with solver.deterministic (the map after each of the last
       --last frames, so poseframes and the frames between them can be
       told apart);
  ate  noisy poses with solver.deterministic: without BA, with BA at the
       examples' re-match radius of 3 px, and with BA at the port's;
       --ba-branch adds BA at the port's radius with ba.do_rematch off
       or ba.aniso_weights on; --mini runs these at 256x192 on
       DATASETS.md's configuration instead (tests/test_dataset_accuracy.py).

Prints one line per run (median relative error and coverage of the maps,
ATE of the poseframes) and the peak resident memory. Takes a few minutes:
the JAX package runs eagerly compiled XLA on the CPU.
"""

import argparse
import dataclasses
import os
import resource
import sys
import tempfile
import time

os.environ.setdefault("JAX_PLATFORMS", "cpu")
sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                ".."))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_compilation_cache_dir",
                  os.path.join(os.path.dirname(os.path.abspath(__file__)),
                               "..", ".jax_cache_cpu"))
jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.0)
jax.config.update("jax_persistent_cache_min_entry_size_bytes", 0)

import numpy as np  # noqa: E402
import torch  # noqa: E402

import flame_tpu_torch  # noqa: E402
from flame_tpu import Flame as JaxFlame  # noqa: E402
from flame_tpu.geometry import camera as jcamera  # noqa: E402
from flame_tpu.io import datasets as jdatasets  # noqa: E402
from flame_tpu.io import synthetic as jsynthetic  # noqa: E402
from flame_tpu.params import BAParams, Params, SolverParams  # noqa: E402
from flame_tpu.utils import evaluation  # noqa: E402
from flame_tpu_torch import convert  # noqa: E402
from flame_tpu_torch.geometry import camera as tcamera  # noqa: E402
from flame_tpu_torch.io import datasets as tdatasets  # noqa: E402
from flame_tpu_torch.run_dataset import rematch_radius  # noqa: E402

W, H, FX = 640, 480, 517.3
NOISE = dict(pose_noise_t=0.015, pose_noise_deg=0.3, noise_seed=1)
POSEFRAME_EVERY = 2


def jax_params(do_ba, radius, deterministic, **ba):
    """examples/run_dataset.py's Params with the given re-match radius
    (and other BAParams fields given as ba)."""
    return Params(min_height=-1e6, max_height=1e6, do_ba=do_ba,
                  ba=BAParams(rematch_radius=radius, **ba),
                  solver=SolverParams(n_iters_per_frame=60,
                                      async_topology=True,
                                      deterministic=deterministic),
                  debug_quiet=True)


def mini_params(do_ba, deterministic, **ba):
    """tests/test_dataset_accuracy.py's Params (DATASETS.md's 256x192
    configuration) with other BAParams fields given as ba."""
    from test_dataset_accuracy import make_params
    p = make_params(do_ba)
    return dataclasses.replace(
        p, ba=dataclasses.replace(p.ba, **ba),
        solver=dataclasses.replace(p.solver, deterministic=deterministic))


def make_flame(pkg, K, params, size=(W, H)):
    if pkg == "jax":
        Kj = np.asarray(K, np.float32)
        return JaxFlame(*size, Kj, jcamera.inv_k(Kj), params)
    Kt = torch.as_tensor(K, dtype=torch.float32)
    return flame_tpu_torch.Flame(
        *size, Kt, tcamera.inv_k(Kt),
        convert.params_from_dict(dataclasses.asdict(params)), device="cpu")


def run(pkg, root, K, n_frames, params, poses, per_frame, size=(W, H)):
    """Feed the sequence as run_sequence does; with per_frame, read the
    map after each frame of per_frame (a set of indices)."""
    ds = jdatasets if pkg == "jax" else tdatasets
    frames = ds.load_tum(root, max_frames=n_frames)
    if poses is not None:
        for fr, (q, t) in zip(frames, poses):
            fr.q = np.asarray(q, np.float32)
            fr.t = np.asarray(t, np.float32)
    fl = make_flame(pkg, K, params, size)
    maps = {}
    t0 = time.perf_counter()
    for i, fr in enumerate(frames):
        fl.update(fr.time, fr.frame_id, (fr.q, fr.t), fr.load_image(),
                  i % POSEFRAME_EVERY == 0)
        if i in per_frame:
            maps[i] = np.asarray(fl.get_inverse_depth_map())
    return fl, maps, time.perf_counter() - t0


def pf_ate(fl, gt):
    ids = sorted(fl._pf_slot_by_id)
    t = np.stack([np.asarray(fl._stack.t[fl._pf_slot_by_id[i]])
                  for i in ids])
    return evaluation.ate_rmse(t, np.asarray([gt[i][1] for i in ids]))


def stats(fl):
    s = fl.stats.snapshot()["stats"]
    return {k: int(s.get(k, 0)) for k in ("ba_single_solves",
                                          "ba_solves_applied",
                                          "ba_writeback_skips")}


def mini_ate(branch, name):
    """The ate runs on DATASETS.md's 256x192 mini-TUM (chip_smoke.py's
    phase 9 cell): noisy poses without BA, with BA, and with BA and the
    branch, deterministic, in both packages."""
    w, h, fx, n = 256, 192, 210.0, 24
    with tempfile.TemporaryDirectory() as root:
        meta = jsynthetic.generate_mini_tum(root, n_frames=n, width=w,
                                            height=h, fx=fx, **NOISE)
        print(f"mini-TUM {w}x{h}, fx={fx}, {n} frames, poseframe every "
              f"{POSEFRAME_EVERY}", flush=True)
        for pkg in ("jax", "torch"):
            base = None
            runs = [("noisy", False, {}), ("noisy+BA", True, {})]
            if branch:
                runs.append((f"noisy+BA {name}", True, branch))
            for label, do_ba, ba in runs:
                fl, _, sec = run(pkg, root, meta["K"], n,
                                 mini_params(do_ba, True, **ba),
                                 meta["noisy"], set(), size=(w, h))
                a = pf_ate(fl, meta["gt"])
                base = base or a
                print(f"{pkg} {label} deterministic: ATE {1000 * a:.3f} mm "
                      f"({a / base:.4f} of no BA); {stats(fl)}; "
                      f"{sec:.1f} s", flush=True)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--frames", type=int, default=48)
    ap.add_argument("--last", type=int, default=16)
    ap.add_argument("--only", choices=("map", "ate"))
    ap.add_argument("--ba-branch", choices=("no_rematch", "aniso_weights"),
                    help="add a noisy run with BA at the port's radius "
                         "and ba.do_rematch=False or ba.aniso_weights=True")
    ap.add_argument("--mini", action="store_true",
                    help="the ate runs at 256x192 (24 frames, fx=210) with "
                         "tests/test_dataset_accuracy.py's Params instead")
    args = ap.parse_args()
    branch = {None: {}, "no_rematch": dict(do_rematch=False),
              "aniso_weights": dict(aniso_weights=True)}[args.ba_branch]
    if args.mini:
        return mini_ate(branch, args.ba_branch)
    torch.set_num_threads(4)
    n = args.frames
    radius = rematch_radius(FX)
    with tempfile.TemporaryDirectory() as root:
        meta = jsynthetic.generate_mini_tum(root, n_frames=n, width=W,
                                            height=H, fx=FX, **NOISE)
        gt_map = {i: jsynthetic.render_frame(meta["K"],
                                             *jsynthetic.trajectory(i), W,
                                             H)[1]
                  for i in range(n - args.last, n)}
        print(f"mini-TUM {W}x{H}, fx={FX}, {n} frames, poseframe every "
              f"{POSEFRAME_EVERY}; re-match radius {radius} px", flush=True)
        for pkg in ("jax", "torch"):
            if args.only != "ate":
                for det in (False, True):
                    per = set(gt_map) if det else {n - 1}
                    fl, maps, sec = run(pkg, root, meta["K"], n,
                                        jax_params(True, radius, det), None,
                                        per)
                    errs = {i: evaluation.depth_error_stats(m, gt_map[i])
                            for i, m in maps.items()}
                    last = errs[n - 1]
                    print(f"{pkg} true+BA {'deterministic' if det else 'async'}"
                          f": final map coverage {last['coverage']:.4f}, "
                          f"median relative error {last['median_rel']:.5f}; "
                          f"{stats(fl)}; {sec:.1f} s", flush=True)
                    if det:
                        print(f"{pkg} per frame (frame: median error, * = "
                              "poseframe): " + ", ".join(
                                  f"{i}{'*' if i % POSEFRAME_EVERY == 0 else ''}"
                                  f": {e['median_rel']:.4f}"
                                  for i, e in sorted(errs.items())),
                              flush=True)
            if args.only != "map":
                base = None
                runs = [("noisy", False, radius, {}),
                        ("noisy+BA r3", True, 3, {}),
                        (f"noisy+BA r{radius}", True, radius, {})]
                if branch:
                    runs.append((f"noisy+BA r{radius} {args.ba_branch}",
                                 True, radius, branch))
                for name, do_ba, r, ba in runs:
                    fl, _, sec = run(pkg, root, meta["K"], n,
                                     jax_params(do_ba, r, True, **ba),
                                     meta["noisy"], set())
                    a = pf_ate(fl, meta["gt"])
                    base = base or a
                    print(f"{pkg} {name} deterministic: ATE {1000 * a:.3f} mm "
                          f"({a / base:.4f} of no BA); {stats(fl)}; "
                          f"{sec:.1f} s", flush=True)
    peak = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2 ** 20
    print(f"peak resident memory {peak:.2f} GiB")


if __name__ == "__main__":
    main()
