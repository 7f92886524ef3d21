"""The JAX package's readings for chip_smoke.py phase 15's synchronous
branch runs, taken on the CPU.

    python tests/torch_branches_witness.py [--frames 16] [--only NAME ...]
        [--port]

For each branch of chip_smoke.BRANCH_SYNC (bench_params() with one Params
branch switched, chip_smoke.branch_params), flame_tpu.Flame runs phase
6's scene: bench.py's textured plane at 5 m, 640x480, 4096 features,
the camera 8 cm further each frame, every second frame a poseframe, the
frames as uint8 arrays. The Params are chip_smoke's, carried into the JAX
package field by field (and back through convert.params_from_dict, which
must give them again). Prints per branch the final map's coverage and
median relative idepth error against the true plane, the live features,
the detection passes after the first update that meshed, and under
letterbox the rows of the live features and the coverage outside the
middle third; then the BRANCH_JAX table for chip_smoke.py. --port runs
flame_tpu_torch.Flame(device="cpu") on the same input after each and
prints the same line (what the card should read). About a minute per
branch for the JAX package, most of it its compiles; --port adds about
as much.
"""

import argparse
import dataclasses
import os
import resource
import sys
import time

os.environ.setdefault("JAX_PLATFORMS", "cpu")
ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
sys.path.insert(0, ROOT)

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_compilation_cache_dir",
                  os.path.join(ROOT, ".jax_cache_cpu"))
jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.0)
jax.config.update("jax_persistent_cache_min_entry_size_bytes", 0)

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
import flame_tpu_torch  # noqa: E402
from flame_tpu import params as jparams  # noqa: E402
from flame_tpu.core.flame import Flame as JFlame  # noqa: E402
from flame_tpu_torch import convert  # noqa: E402


def jax_params(tp):
    """The JAX package's Params with the fields of the port's tp."""
    def build(cls, d):
        default = cls()
        kw = {}
        for f in dataclasses.fields(cls):
            if f.name not in d:
                continue
            cur = getattr(default, f.name)
            kw[f.name] = (build(type(cur), d[f.name])
                          if dataclasses.is_dataclass(cur) else d[f.name])
        return cls(**kw)
    jp = build(jparams.Params, dataclasses.asdict(tp))
    if convert.params_from_dict(dataclasses.asdict(jp)) != tp:
        raise AssertionError("Params differ after the round trip")
    return jp


def run(fl, frames, jax_side):
    """Drive fl through the frames; returns the reading chip_smoke's
    branch_sync_run takes."""
    meshed, late = 0, 0
    for i, img in enumerate(frames):
        q, t = cs.pose(i)
        if jax_side:
            pose = (jnp.asarray(q, jnp.float32), jnp.asarray(t, jnp.float32))
        else:
            pose = (q, t)
        ids = fl._feat_id_counter
        ok = fl.update(i / 30.0, i, pose, img, i % 2 == 0)
        if meshed:
            late += (fl._feat_id_counter - ids) // fl._add_cap
        meshed += bool(ok)
    idm = np.asarray(fl.get_inverse_depth_map())
    cov, err = cs.map_errors(idm, 1.0 / cs.PLANE_Z)
    feats, curr = fl._feats, fl._curr
    fv, cv = np.asarray(feats.valid), np.asarray(curr.valid)
    rows = np.concatenate([np.asarray(feats.xy)[fv, 1],
                           np.asarray(curr.xy)[cv, 1]])
    lo, hi = cs.band_rows()
    outside = np.ones(cs.H, bool)
    outside[lo:hi] = False
    return dict(cov=cov, err=err, features=int(fv.sum()), meshed=meshed,
                late_detections=late,
                rows=(float(rows.min()), float(rows.max())) if rows.size
                else None,
                cov_outside=float((~np.isnan(idm[outside])).mean()))


def line(label, name, r, seconds):
    return (f"{label} {name}: coverage {r['cov']:.4f}, median relative "
            f"error {r['err']:.5f}, features {r['features']}, meshed "
            f"{r['meshed']}, detection passes after the first meshed update "
            f"{r['late_detections']}, live feature rows {r['rows']}, "
            f"coverage outside the middle third {r['cov_outside']:.4f} "
            f"({seconds:.1f} s)")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=cs.BRANCH_FRAMES)
    ap.add_argument("--only", nargs="+", default=list(cs.BRANCH_SYNC))
    ap.add_argument("--port", action="store_true")
    args = ap.parse_args()
    torch.set_num_threads(min(4, torch.get_num_threads()))
    K, Kinv, frames = cs.scene(args.frames)
    table = {}
    for name in args.only:
        tp = cs.branch_params(name)
        t0 = time.perf_counter()
        r = run(JFlame(cs.W, cs.H, jnp.asarray(K), jnp.asarray(Kinv),
                       jax_params(tp)), frames, True)
        print(line("JAX", name, r, time.perf_counter() - t0), flush=True)
        table[name] = (round(r["cov"], 5), round(r["err"], 5))
        if args.port:
            t0 = time.perf_counter()
            r = run(flame_tpu_torch.Flame(cs.W, cs.H, K, Kinv, tp,
                                          device="cpu"), frames, False)
            print(line("port", name, r, time.perf_counter() - t0),
                  flush=True)
    print("BRANCH_JAX = {")
    for name, v in table.items():
        print(f'    "{name}": {v},')
    print("}")
    print(f"peak resident memory "
          f"{resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1e6:.2f} "
          f"GB")


if __name__ == "__main__":
    main()
