"""The batched step through the JAX package and the port on the CPU, on
tests/torch_multihost_worker.py's 160x120 scene (512 features,
frame_batch=4, async topology, deterministic, uint8 frames).

    python tests/torch_batch_witness.py [--frames 16 20] [--evict]
    python tests/torch_batch_witness.py --stagewise [--frames 16 20]
        [--sqrt-rn] [--pallas-raster]

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

--stagewise holds every batched step on its own, for each frame count
without and with eviction: flame_tpu.Flame runs eagerly (under
jax.disable_jit(), whose tracking the port matches, ROADMAP's "jitted vs
eager" trap), and each of its pipeline.batch_step calls is also given,
converted through convert.py, to the port's pipeline.batch_step. The
step's outputs are compared at tests/test_torch_batch_pipeline.py's
tolerances (decision masks differ on at most 0.5% of entries, floats
within rtol 1e-4 / atol 1e-4 where the decisions agree, the stack's ids,
validity and poses exactly), stage by stage: tracking (the features, the
last frame's projection, membership), stats, the packed snapshot, the
stack, each poseframe's stashed map, the graph, the dense map and the
coverage. The JAX package continues from its own outputs, so every step
starts from its eager state. Prints one line per step and the first step
and stage beyond tolerance, if any. Some minutes: eager JAX dispatches
every primitive on its own.

Two differences that are not the port's can be taken out: --sqrt-rn
makes torch.sqrt round correctly on the CPU (torch's CPU kernel is one
ulp off for about 0.6% of float32 inputs; XLA's and CUDA's are not), and
--pallas-raster draws the JAX package's maps with its Pallas rasterizer,
the kernel the port ports, instead of its XLA rasterizer, which drops
triangles past 40 in a 16x32 cell (see pallas_raster_reference). Both
also apply to the whole-run pairs.
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
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

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


def _np(x):
    return {k: np.asarray(v) for k, v in x._asdict().items()}


def _t(a):
    return torch.as_tensor(np.array(a))


def stage_checks(jout, tout, pf_slots, pf_flags):
    """(stage, check) pairs of one batched step: each check raises
    AssertionError when its stage is beyond
    tests/test_torch_batch_pipeline.py's tolerances."""
    import test_torch_batch_pipeline as tb
    B = len(pf_flags)
    (_, jstack, jfe, jcu, jmem, jst, _, jpk) = jout[:8]
    (_, tstack, tfe, tcu, tmem, tst, tpk) = tout[:7]

    def tracking():
        ok = tb._flips(jfe.valid, tfe.valid.numpy())
        ok &= tb._flips(jfe.search_status, tfe.search_status.numpy())
        ok &= tb._flips(jmem, tmem.numpy())
        ok &= tb._flips(jfe.pf_slot, tfe.pf_slot.numpy())
        ok &= tb._flips(jfe.feat_id, tfe.feat_id.numpy())
        v = ok & np.asarray(jfe.valid)
        for name in ("xy", "idepth_mu", "idepth_var"):
            tb._close(getattr(jfe, name), getattr(tfe, name), v)
        for name in ("xy", "idepth", "var"):
            tb._close(getattr(jcu, name), getattr(tcu, name), v)

    def stats():
        np.testing.assert_allclose(tst.numpy(), np.asarray(jst),
                                   atol=max(2, 0.005 * 512 * B))

    def packed():
        tb._flips(np.asarray(jpk)[:, 2], tpk[:, 2].numpy())

    def stack():
        np.testing.assert_array_equal(tstack.frame_id.numpy(),
                                      np.asarray(jstack.frame_id))
        np.testing.assert_array_equal(tstack.valid.numpy(),
                                      np.asarray(jstack.valid))
        tb._close(jstack.q, tstack.q, rtol=0, atol=0)
        tb._close(jstack.t, tstack.t, rtol=0, atol=0)

    def poseframe_maps():
        for b in np.nonzero(pf_flags)[0]:
            jm = np.asarray(jstack.idepthmap[pf_slots[b]])
            tm = tstack.idepthmap[pf_slots[b]].numpy()
            both = tb._flips(np.isnan(jm), np.isnan(tm)) & ~np.isnan(jm)
            tb._close(jm, tm, both)

    def graph():
        jg, tg = jout[8], tout[7]
        m = np.asarray(jmem)
        np.testing.assert_array_equal(tg.vtx_mask.numpy(), m)
        for name in ("x", "w1", "w2", "data_term"):
            tb._close(getattr(jg, name), getattr(tg, name), m)
        em = np.asarray(jg.edge_mask) & tg.edge_mask.numpy()
        for name in ("q1", "q2", "q3"):
            tb._close(getattr(jg, name), getattr(tg, name), em)

    def dense_map():
        jidm, tidm = np.asarray(jout[12]), tout[11].numpy()
        both = tb._flips(np.isnan(jidm), np.isnan(tidm)) & ~np.isnan(jidm)
        tb._close(jidm, tidm, both)

    def coverage():
        d = abs(float(jout[14]) - float(tout[13]))
        assert d <= tb.MAX_FLIPS, d

    return [("tracking", tracking), ("stats", stats), ("packed", packed),
            ("stack", stack), ("poseframe maps", poseframe_maps),
            ("graph", graph), ("dense map", dense_map),
            ("coverage", coverage)]


def stagewise(jp, tp, run_frames, posture):
    """One eager JAX Flame run with every batched step also run by the
    port from the same inputs; returns (step, stage, message) of the
    first stage beyond tolerance, or None."""
    from flame_tpu.core import pipeline as jpipe
    from flame_tpu_torch.core import pipeline as tpipe
    orig = jpipe.batch_step
    T, E = jp.triangle_capacity, jp.edge_capacity
    K = np.array([[FX, 0, W / 2], [0, FX, H / 2], [0, 0, 1]], np.float32)
    Kinv = np.linalg.inv(K.astype(np.float64)).astype(np.float32)
    steps, first = [], []

    def both(p, K_, Kinv_, stack, feats, graph, graph_scale, buf, fids, qs,
             ts, pf_flags, det_flags, pf_slots, id_bases, prev_q, prev_t,
             sync_q, sync_t, seed_map, carry_fresh, n_frames=2, height=0,
             width=0, imgs=None, mesh=None):
        jout = orig(p, K_, Kinv_, stack, feats, graph, graph_scale, buf,
                    fids, qs, ts, pf_flags, det_flags, pf_slots, id_bases,
                    prev_q, prev_t, sync_q, sync_t, seed_map, carry_fresh,
                    n_frames=n_frames, height=height, width=width,
                    imgs=imgs, mesh=mesh)
        B, hw = n_frames, height * width
        raw = np.asarray(buf)
        if imgs is None:
            frames = [raw[b * hw:(b + 1) * hw].reshape(height, width)
                      for b in range(B)]
            words = raw[B * hw:].view(np.uint16)
        else:
            frames = [np.asarray(im) for im in imgs]
            words = raw.view(np.uint16)
        tout = tpipe.batch_step(
            tp, _t(K), _t(Kinv),
            convert.frame_stack_from_numpy(_np(stack), "cpu"),
            convert.feature_state_from_numpy(_np(feats), "cpu"),
            convert.graph_state_from_numpy(_np(graph), "cpu"),
            _t(graph_scale), [_t(f) for f in frames], list(map(int, fids)),
            [_t(q) for q in qs], [_t(t) for t in ts],
            [bool(f) for f in pf_flags], [bool(f) for f in det_flags],
            [int(s) for s in pf_slots], [int(i) for i in id_bases],
            _t(prev_q), _t(prev_t), _t(sync_q), _t(sync_t), _t(seed_map),
            convert.topology_from_words(words, T, E, "cpu"), width, height)
        bad = []
        for stage, check in stage_checks(jout, tout, list(pf_slots),
                                         list(pf_flags)):
            try:
                check()
            except AssertionError as e:
                bad.append((stage, " ".join(str(e).split())[:300]))
        k = len(steps)
        steps.append(bad)
        if bad and not first:
            first.append((k, int(fids[0]), int(fids[-1])) + bad[0])
        print(f"  {posture}, {run_frames} frames: step {k} (frames "
              f"{int(fids[0])}-{int(fids[-1])}, fresh topology "
              f"{bool(carry_fresh)}): "
              + ("every stage within tolerance" if not bad else
                 "beyond tolerance: " + "; ".join(
                     f"{s}: {m}" for s, m in bad)), flush=True)
        return jout

    jpipe.batch_step = both
    try:
        jK = camera.make_k(FX, FX, W / 2, H / 2)
        fl = JFlame(W, H, jK, camera.inv_k(jK), jp)
        with jax.disable_jit():
            for i in range(run_frames):
                cam_x = 0.15 * i
                fl.update(i * 0.1, i, (se3.quat_identity(),
                                       jnp.array([cam_x, 0.0, 0.0])),
                          render(cam_x), i % 2 == 0)
    finally:
        jpipe.batch_step = orig
    print(f"{posture}, {run_frames} frames: {len(steps)} batched steps; "
          + (f"first beyond tolerance: step {first[0][0]} (frames "
             f"{first[0][1]}-{first[0][2]}), stage {first[0][3]}: "
             f"{first[0][4]}" if first else
             "every step and stage within tolerance"), flush=True)
    return first[0] if first else None


def correctly_rounded_sqrt():
    """Make torch.sqrt round correctly on float32 CPU tensors, as XLA's
    and CUDA's do: torch's CPU kernel is one ulp off on about 0.6% of
    float32 inputs (the exact root lies near half an ulp), and a search
    segment's end one ulp away can change the line search's last step.
    The root of the float64 value rounds to the correctly rounded
    float32 root."""
    plain = torch.sqrt
    x = np.random.default_rng(0).uniform(0, 1, 1_000_000).astype(np.float32)
    frac = float((plain(torch.from_numpy(x)).numpy() != np.sqrt(x)).mean())
    print(f"torch.sqrt on the CPU: {frac:.6f} of 1000000 seeded uniform(0, 1) "
          f"float32 roots differ from the correctly rounded ones; using the "
          f"float64 root rounded to float32 instead", flush=True)

    def sqrt(x, *a, **kw):
        if isinstance(x, torch.Tensor) and x.dtype == torch.float32 \
                and x.device.type == "cpu" and not a and not kw:
            return plain(x.double()).float()
        return plain(x, *a, **kw)
    torch.sqrt = sqrt


def pallas_raster_reference():
    """Make the JAX package draw its dense maps with its Pallas rasterizer
    (its TPU path, here in interpret mode, compiled): the kernel that the
    port's K2 and K2b port and whose one-level binning keeps up to 160
    (one view) or 192 (a batch) triangles per 32x128 tile. Its XLA
    rasterizer, which it runs on the CPU, re-bins each tile into 16x32
    cells of at most 40 triangles and drops the rest; stale triangles
    after an eviction can pass that cap."""
    from flame_tpu.ops import pallas_raster
    from flame_tpu.ops import rasterize as raster

    def one(verts, tris, vals, tri_valid, height, width, **kw):
        with jax.disable_jit(False):
            return pallas_raster.rasterize(verts, tris, vals, tri_valid,
                                           height, width, interpret=True,
                                           **kw)

    def batch(verts, tris, vals, tri_valid, height, width):
        with jax.disable_jit(False):
            return pallas_raster.rasterize_batch(verts, tris, vals,
                                                 tri_valid, height, width,
                                                 interpret=True)
    raster.rasterize_auto = one
    raster.rasterize_batch_auto = batch
    print("the JAX package's maps drawn by its Pallas rasterizer "
          "(interpret mode)", flush=True)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, nargs="+", default=[16, 20])
    ap.add_argument("--evict", action="store_true")
    ap.add_argument("--stagewise", action="store_true")
    ap.add_argument("--sqrt-rn", action="store_true")
    ap.add_argument("--pallas-raster", action="store_true")
    args = ap.parse_args()
    if args.sqrt_rn:
        correctly_rounded_sqrt()
    if args.pallas_raster:
        pallas_raster_reference()
    if args.stagewise:
        for evict in (False, True):
            jp = jax_params(evict)
            tp = convert.params_from_dict(dataclasses.asdict(jp))
            for n in args.frames:
                stagewise(jp, tp, n, "eviction" if evict else "no eviction")
        return
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
