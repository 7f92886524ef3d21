"""The two-plane scene of tests/test_structured_scene.py above its
160x120, in both packages on the CPU, with the texture at the test's
world frequencies and scaled with the focal length (chip_smoke.py's
two_planes, phase 14b's scene at VGA).

    python tests/torch_structured_witness.py [--scale 2] [--features 1024]

Runs flame_tpu.Flame and flame_tpu_torch.Flame at 160*scale x 120*scale,
FX 100*scale, 14 frames, every second one a poseframe, with phase 14b's
Params (chip_smoke.bench_params() at the given feature capacity, the
test's idepth_init, idepth_var_init and height limits), and prints per
package and texture the features, the map's coverage and median
relative error, the contrast across the split and the slope ratio
(chip_smoke.split_measures). About a minute at scale 2.
"""

import argparse
import dataclasses
import os
import sys

os.environ.setdefault("JAX_PLATFORMS", "cpu")
sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                ".."))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
import flame_tpu_torch  # noqa: E402
from flame_tpu import params as jparams  # noqa: E402
from flame_tpu.core.flame import Flame as JFlame  # noqa: E402
from flame_tpu.geometry import se3  # noqa: E402


def jax_params(x):
    """The JAX package's Params (or nested params) of the port's."""
    if not dataclasses.is_dataclass(x):
        return x
    return getattr(jparams, type(x).__name__)(**{
        f.name: jax_params(getattr(x, f.name))
        for f in dataclasses.fields(x) if f.init})


def run(package, params, K, frames):
    """The final dense map and feature count of one package's run."""
    W, H = frames[0].shape[1], frames[0].shape[0]
    Kinv = np.linalg.inv(K.astype(np.float64)).astype(np.float32)
    if package == "jax":
        fl = JFlame(W, H, jnp.asarray(K), jnp.asarray(Kinv),
                    jax_params(params))
    else:
        fl = flame_tpu_torch.Flame(W, H, K, Kinv, params, device="cpu")
    for i, img in enumerate(frames):
        t = np.array([cs.STRUCT_STEP * i, 0.0, 0.0], np.float32)
        pose = ((se3.quat_identity(), jnp.asarray(t)) if package == "jax"
                else (np.array([1.0, 0, 0, 0], np.float32), t))
        fl.update(i * 0.1, i, pose, img, i % 2 == 0)
    return fl.get_inverse_depth_map(), int(fl._n_valid)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--scale", type=float, default=2.0)
    ap.add_argument("--features", type=int, default=1024)
    a = ap.parse_args()
    torch.set_num_threads(4)
    W, H, fx = int(160 * a.scale), int(120 * a.scale), 100.0 * a.scale
    K = np.array([[fx, 0, W / 2], [0, fx, H / 2], [0, 0, 1]], np.float32)
    n = a.features
    params = cs.bench_params().replace(
        feature_capacity=n, edge_capacity=3 * n, triangle_capacity=2 * n,
        idepth_init=0.05, idepth_var_init=0.25, min_height=-100.0,
        max_height=100.0)
    for tex_scale, what in ((1.0, "the test's world frequencies"),
                            (None, f"scaled by FX / 100 = {a.scale:g}")):
        frames = [cs.two_planes(cs.STRUCT_STEP * i, W, H, fx, tex_scale)[0]
                  for i in range(cs.STRUCT_FRAMES)]
        truth = cs.two_planes(cs.STRUCT_STEP * (cs.STRUCT_FRAMES - 1), W, H,
                              fx, tex_scale)[1]
        for package in ("jax", "torch"):
            idm, n_valid = run(package, params, K, frames)
            cov, err = cs.map_errors(idm, truth)
            lm, rm, slope, _ = cs.split_measures(idm, truth, W, fx)
            print(f"{W}x{H} FX {fx:g}, texture {what}, {package}: features "
                  f"{n_valid}, coverage {cov:.4f}, median error {err:.5f}, "
                  f"contrast {rm - lm:.4f}, slope ratio {slope:.3f}")


if __name__ == "__main__":
    main()
