"""Where the port's whole run first departs from the JAX package's on the
batch witness scene (tests/torch_batch_witness.py: 160x120, 512
features, frame_batch=4, async topology, deterministic, uint8 frames).

    python tests/torch_flip_witness.py

Runs flame_tpu.Flame and flame_tpu_torch.Flame side by side and prints,
per frame, the host feature counts and the device valid masks; the host
count lags the device by a frame under async topology. At the first
frame whose device masks differ it takes the JAX package's inputs of
that frame's track_step (captured from its Flame), runs the step again
jitted and eagerly (jax.disable_jit()) and runs the port's track_step on
the same state through convert, then prints which slots differ between
the three, the largest differences of the idepths and the tracked
positions, and the tracked features that the jitted step moves into
another detection cell (win_size px). About half a minute on the CPU.
"""

import dataclasses
import os
import sys

os.environ.setdefault("JAX_PLATFORMS", "cpu")
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                ".."))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

import flame_tpu.core.flame as jflame  # noqa: E402
import flame_tpu_torch  # noqa: E402
from flame_tpu.core import pipeline as jpipe  # noqa: E402
from flame_tpu.geometry import camera, se3  # noqa: E402
from flame_tpu_torch import convert  # noqa: E402
from flame_tpu_torch.core import frame as tframe  # noqa: E402
from flame_tpu_torch.core import pipeline as tpipe  # noqa: E402
from torch_batch_witness import FX, H, W, jax_params, render  # noqa: E402


def _np(x):
    return {k: np.asarray(v) for k, v in x._asdict().items()}


def main(n_frames=6):
    jp = jax_params(False)
    tp = convert.params_from_dict(dataclasses.asdict(jp))
    K = np.array([[FX, 0, W / 2], [0, FX, H / 2], [0, 0, 1]], np.float32)
    Kinv = np.linalg.inv(K.astype(np.float64)).astype(np.float32)
    jK = camera.make_k(FX, FX, W / 2, H / 2)
    port = flame_tpu_torch.Flame(W, H, K, Kinv, tp, device="cpu")
    ref = jflame.Flame(W, H, jK, camera.inv_k(jK), jp)

    captured = []
    track_step = jpipe.track_step

    def spy(*args):
        out = track_step(*args)
        captured.append((args, out))
        return out
    jflame.pipeline.track_step = spy  # the cold path's step (frames < 4)

    first = None
    for i in range(n_frames):
        cam_x = 0.15 * i
        img = render(cam_x)
        n_cap = len(captured)
        port.update(i * 0.1, i, (np.array([1.0, 0, 0, 0]),
                                 np.array([cam_x, 0.0, 0.0])), img,
                    i % 2 == 0)
        ref.update(i * 0.1, i, (se3.quat_identity(),
                                jnp.array([cam_x, 0.0, 0.0])), img,
                   i % 2 == 0)
        jv = np.asarray(ref._feats.valid)
        tv = port._feats.valid.numpy()
        print(f"frame {i}: host features {port._n_valid} / {ref._n_valid} "
              f"(port / JAX), device valid {tv.sum()} / {jv.sum()}, "
              f"slots differing {np.nonzero(jv != tv)[0].tolist()}")
        if first is None and (jv != tv).any():
            first = i
            step = captured[n_cap] if len(captured) > n_cap else None
    jflame.pipeline.track_step = track_step
    if first is None:
        print("the device masks never differ")
        return
    if step is None:
        print(f"frame {first} did not run the cold path's track_step")
        return

    (p, jK_, jKinv, stack, feats, fnew, slot, prev_q, prev_t, do_detect,
     id_base, seed_map), jit_out = step
    with jax.disable_jit():
        eager_out = track_step(p, jK_, jKinv, stack, feats, fnew, slot,
                               prev_q, prev_t, do_detect, id_base, seed_map)
    fn = _np(fnew)
    tfnew = tframe.Frame(int(fn["frame_id"]), *(
        torch.tensor(fn[n])
        for n in ("q", "t", "img", "img_pad", "gradx", "grady")))

    def t(x):
        return torch.as_tensor(np.asarray(x))
    port_out = tpipe.track_step(
        tp, t(jK_), t(jKinv),
        convert.frame_stack_from_numpy(_np(stack), "cpu"),
        convert.feature_state_from_numpy(_np(feats), "cpu"), tfnew,
        int(slot), t(prev_q), t(prev_t), bool(do_detect), int(id_base),
        t(seed_map))
    v = [np.asarray(jit_out[0].valid), np.asarray(eager_out[0].valid),
         port_out[0].valid.numpy()]
    xy = [np.asarray(jit_out[0].xy), np.asarray(eager_out[0].xy),
          port_out[0].xy.numpy()]
    cxy = [np.asarray(jit_out[1].xy), np.asarray(eager_out[1].xy),
           port_out[1].xy.numpy()]
    mu = [np.asarray(jit_out[0].idepth_mu),
          np.asarray(eager_out[0].idepth_mu), port_out[0].idepth_mu.numpy()]
    tracked = np.asarray(eager_out[1].valid)
    print(f"frame {first} track_step (do_detect={bool(do_detect)}) on the "
          f"JAX package's input state: valid features jitted {v[0].sum()}, "
          f"eager {v[1].sum()}, port {v[2].sum()}")
    for a, b, name in ((0, 1, "jitted vs eager"), (1, 2, "eager vs port"),
                       (0, 2, "jitted vs port")):
        print(f"  {name}: valid slots differing "
              f"{np.nonzero(v[a] != v[b])[0].tolist()}, slots whose "
              f"position differs {int((xy[a] != xy[b]).any(1).sum())}, "
              f"idepth max |d| where both valid "
              f"{np.abs(mu[a] - mu[b])[v[a] & v[b]].max():.3g}, "
              f"tracked positions max |d| "
              f"{np.abs(cxy[a] - cxy[b])[tracked].max():.3g} px")
    ws = jp.detection.win_size
    moved = np.nonzero(tracked & (np.floor(cxy[0] / ws)
                                  != np.floor(cxy[1] / ws)).any(1))[0]
    for s in moved:
        print(f"  tracked slot {s}: jitted {cxy[0][s].tolist()} eager "
              f"{cxy[1][s].tolist()} (another {ws}-px detection cell)")


if __name__ == "__main__":
    main()
