"""flame_tpu_torch benchmark: dense mesh estimation throughput on one card.

    python -m flame_tpu_torch.bench          # on the CUDA card
    python -m flame_tpu_torch.bench --cpu    # on the CPU (plain kernels)

The port's counterpart of bench.py, with its scene, Params, modes,
windows and fields. It runs on the card, and raises when there is none
unless --cpu (or main(device="cpu")) asks for the CPU. Prints ONE JSON
line, last on stdout:
  {"metric": "vga_dense_fps_per_chip", "value": N, "unit": "frames/sec",
   "solver_iters_per_sec": M,
   "modes": {"resident": N, "host_upload": N2, "resident_ba": N3},
   "windows": {...}, "mode_fetch_ms": {...}, "do_ba": false,
   "coverage": C, "median_rel_depth_err": E, "win_fps_best": B,
   "latency_ms_p50": L, "latency_ms_p95": L2, "fetch_latency_ms": F,
   "packed_sheds": S, "device": "<GPU name>, <power limit>" or "cpu",
   "host": {"cpu": ..., "logical_cpus": ..., "torch": ..., "cuda": ...}}
bench.py's device_floor_ms (a TPU profile) and vs_baseline (a ratio to
a TPU-era target) are left out; device and host are added, because the
same code reads very different frame times on different hosts.

Modes, each a fresh Flame on bench.py's textured plane at 5 m (the
camera moving 8 cm per frame, every second frame a poseframe):
  * resident    - uint8 frames staged on the card before the clock;
                  frame_batch 8. The headline.
  * host_upload - numpy uint8 frames, uploaded by each batched step;
                  frame_batch BENCH_BATCH_HOST (4).
  * resident_ba - resident frames with the windowed bundle adjuster on.
Each mode warms up for 16 frames (24 with BA), then runs windows of
BENCH_WINLEN frames rounded up to a multiple of its frame_batch, each
ending in a real drain (torch.cuda.synchronize(), which waits on every
stream including the pinned snapshot copies, then a read of the map).
A per-window round-trip probe is subtracted, clamped as in bench.py. The
headline runs BENCH_WINDOWS windows (25), the others
BENCH_WINDOWS_SECONDARY (12). solver_iters_per_sec times 4000
iterations of the smoother resolve_smoother picks on the headline run's
final graph: K1 at the default "auto", K3 on one partition under
BENCH_SMOOTHER=pallas.

Env knobs: bench.py's (BENCH_MODES, BENCH_RESIDENT, BENCH_BA, BENCH_RES,
BENCH_FEATS, BENCH_WINDOWS, BENCH_WINDOWS_SECONDARY, BENCH_WINLEN,
BENCH_BATCH, BENCH_BATCH_HOST, BENCH_DEGREE, BENCH_REACH, BENCH_MINB,
BENCH_LAG, BENCH_STRIDE, BENCH_JOINAGE, BENCH_SHEDS, BENCH_SMOOTHER,
BENCH_ITERS, BENCH_BA_GN, BENCH_BA_MINPF). BENCH_VERBOSE=1 prints to
stderr the windows, the map's sizes, each mode's round-trip probe median,
CUDA-event stage medians and kernel launches, and the solver rate's
launches.
"""

import argparse
import json
import os
import platform
import subprocess
import sys
import time

import numpy as np
import torch

from flame_tpu_torch import _kernels
from flame_tpu_torch.core import pipeline

PLANE_Z = 5.0
SOLVER_ITERS = 4000  # bench.py's K_IT
MODES = ("resident", "host_upload", "resident_ba")


def make_params(do_ba: bool, n_feats: int = 4096, frame_batch=None):
    """bench.py's Params (bench.py:69-140): capacities scaled with
    n_feats (E = 3N, T = 2N), async topology, frame_batch 8 unless given,
    and its env knobs."""
    from flame_tpu_torch.params import (BAParams, DetectionParams, Params,
                                        SolverParams)
    env = os.environ.get
    ba = BAParams(n_gn_iters=int(env("BENCH_BA_GN", 3)),
                  solve_min_new_pfs=int(env("BENCH_BA_MINPF", 4)))
    return Params(
        feature_capacity=n_feats, edge_capacity=3 * n_feats,
        triangle_capacity=2 * n_feats,
        poseframe_capacity=16,
        min_height=-1e6, max_height=1e6,
        idepth_init=0.05,
        min_baseline=float(env("BENCH_MINB", 0.01)),
        detection=DetectionParams(win_size=16),
        do_ba=do_ba, ba=ba,
        solver=SolverParams(
            max_vertex_degree=int(env("BENCH_DEGREE", 20)),
            pallas_reach=int(env("BENCH_REACH", 3)),
            async_topology=True,
            topology_lag=int(env("BENCH_LAG", 2)),
            frame_batch=(int(frame_batch) if frame_batch is not None
                         else int(env("BENCH_BATCH", 8))),
            fetch_stride=int(env("BENCH_STRIDE", 1)),
            join_age=int(env("BENCH_JOINAGE", 24)),
            max_consecutive_sheds=int(env("BENCH_SHEDS", 8)),
            smoother=env("BENCH_SMOOTHER", "auto"),
            n_iters_per_frame=int(env("BENCH_ITERS", 40))),
        debug_quiet=True)


def resolve_modes():
    """Mode list, headline first (bench.py:282-311). BENCH_MODES
    trims/reorders explicitly; BENCH_RESIDENT=0 / BENCH_BA=1 promote a
    secondary mode to the headline."""
    env = os.environ.get("BENCH_MODES")
    if env:
        modes = [m.strip() for m in env.split(",") if m.strip()]
        bad = set(modes) - set(MODES)
        if bad:
            raise SystemExit(f"BENCH_MODES: unknown mode(s) {sorted(bad)}")
        if not modes:
            raise SystemExit("BENCH_MODES: no modes parsed")
        return modes
    ba = os.environ.get("BENCH_BA", "0") != "0"
    host = os.environ.get("BENCH_RESIDENT", "1") == "0"
    if ba and host:
        raise SystemExit("BENCH_BA=1 with BENCH_RESIDENT=0 is no longer "
                         "a single posture; pick modes explicitly with "
                         "BENCH_MODES")
    modes = list(MODES)
    if ba:
        modes.remove("resident_ba")
        modes.insert(0, "resident_ba")
    elif host:
        modes.remove("host_upload")
        modes.insert(0, "host_upload")
    return modes


def mode_params(mode: str, n_feats: int):
    if mode == "host_upload":
        return make_params(False, n_feats,
                           frame_batch=os.environ.get("BENCH_BATCH_HOST", 4))
    return make_params(mode == "resident_ba", n_feats)


def focal(width: int) -> float:
    """bench.py's focal length: a constant field of view across sizes."""
    return 525.0 * width / 640.0


def renderer(width: int, height: int):
    """render(cam_x): bench.py's textured plane at PLANE_Z as a uint8
    frame with the camera at (cam_x, 0, 0)."""
    fx = focal(width)
    vv, uu = np.mgrid[0:height, 0:width].astype(np.float64)

    def render(cam_x):
        X = (uu - width / 2) * PLANE_Z / fx + cam_x
        Y = (vv - height / 2) * PLANE_Z / fx
        tex = (128 + 60 * np.sin(21.0 * X + 4.5 * Y) + 35 * np.cos(8.7 * X)
               + 18 * np.sin(11.6 * Y) + 10 * np.sin(4.2 * X))
        return np.clip(tex, 0, 255).astype(np.uint8)
    return render


def pose(i: int):
    """Frame i's camera-to-world pose (q wxyz, t), made on the clock as a
    frontend delivers it."""
    return np.array([1.0, 0.0, 0.0, 0.0]), np.array([0.08 * i, 0.0, 0.0])


def drain(fl) -> None:
    """Wait until every queued step of fl has finished: on the card every
    stream (the pinned snapshot copies too), then a read of the map."""
    if fl.device.type == "cuda":
        torch.cuda.synchronize(fl.device)
    fl._idepthmap[0, 0].item()


def measure_mode(params, frames_np, resident: bool, n_warm: int,
                 n_windows: int, win_len: int, device):
    """One throughput measurement (bench.py:143-232): a fresh Flame,
    warm-up, then n_windows windows of win_len frames, each ending in a
    drain. Returns (median fps, per-window fps, fl, latency percentiles,
    per-window round-trip probe seconds)."""
    from flame_tpu_torch import Flame
    from flame_tpu_torch.geometry import camera

    height, width = frames_np[0].shape
    fx = focal(width)
    K = camera.make_k(fx, fx, width / 2, height / 2)
    fl = Flame(width, height, K, camera.inv_k(K), params, device=device)

    if resident:
        frames = [torch.as_tensor(f, device=fl.device) for f in frames_np]
        if fl.device.type == "cuda":
            torch.cuda.synchronize(fl.device)
        frames[-1][0, 0].item()
    else:
        frames = frames_np

    for i in range(n_warm):
        fl.update(i * 0.1, i, pose(i), frames[i], i % 2 == 0)
        if i % 8 == 7:
            drain(fl)

    probe = torch.zeros((), device=fl.device)
    (probe + 1).item()

    # Latency samples restart here; snapshots staged during the warm-up
    # and still in flight lose their entry stamps (bench.py:190-196).
    fl._packed_queue = type(fl._packed_queue)(
        (pk, fr, meta, [None] * len(stamps))
        for pk, fr, meta, stamps in fl._packed_queue)
    fl._zombie_fetches = [(pk, None) for pk, _stamps in fl._zombie_fetches]
    fl._latency_samples.clear()

    win_fps, rtt_probes = [], []
    k = 0
    for _ in range(n_windows):
        t0 = time.perf_counter()
        for _j in range(win_len):
            i = n_warm + k
            fl.update(i * 0.1, i, pose(i), frames[i], i % 2 == 0)
            k += 1
        drain(fl)
        dt = time.perf_counter() - t0
        # The drain's own round trip, measured again in each window and
        # clamped to twice the running median and half the window.
        t1 = time.perf_counter()
        (probe + 1).item()
        rtt_probes.append(time.perf_counter() - t1)
        rtt_w = min(rtt_probes[-1], 2.0 * float(np.median(rtt_probes)),
                    0.5 * dt)
        win_fps.append(win_len / max(dt - rtt_w, 1e-6))

    return (float(np.median(win_fps)), win_fps, fl,
            fl.latency_percentiles(), rtt_probes)


def solver_rate(params, fl) -> float:
    """Iterations per second of the smoother the port resolves to
    (core.pipeline.resolve_smoother), SOLVER_ITERS of them on fl's final
    graph: K1 (optimize.smoother_kernel.smooth) for "vertex", K3 on one
    partition (parallel.halo_kernel.smooth_sharded on the RCM-banded
    layout) for "pallas". Timed with CUDA events around a warmed call on
    the card, with the host clock on the CPU."""
    from flame_tpu_torch.optimize import smoother_kernel
    from flame_tpu_torch.parallel import halo_kernel, sharding

    mode = pipeline.resolve_smoother(params)
    rp, s = params.rparams, params.solver
    if mode == "vertex":
        def smooth():
            return smoother_kernel.smooth(rp, fl._graph, SOLVER_ITERS)
    elif mode == "pallas":
        V = params.feature_capacity
        member = fl._graph.vtx_mask.cpu().numpy()
        edges = fl._edges_np[: fl._n_edges]
        perm = smoother_kernel.rcm_order(edges, fl._n_edges, V, member)
        inv = np.empty(V, np.int32)
        inv[perm] = np.arange(V, dtype=np.int32)
        ranks = smoother_kernel.perm_edge_ranks(
            edges, fl._n_edges, inv, params.edge_capacity,
            s.max_vertex_degree, s.pallas_reach)
        dev = fl.device
        pd, ivd, rkd = (torch.as_tensor(a, device=dev)
                        for a in (perm, inv, ranks))
        mesh = sharding.make_mesh(1, dev)

        def smooth():
            return halo_kernel.smooth_sharded(
                rp, fl._graph, pd, ivd, rkd, SOLVER_ITERS,
                s.max_vertex_degree, mesh, reach=s.pallas_reach)
    else:
        raise ValueError(f"solver_rate: smoother {mode!r} needs a "
                         f"partition mesh (ShardedFlame); the bench runs "
                         f"Flame")
    smooth().x[0].item()
    if fl.device.type == "cuda":
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        smooth()
        b.record()
        torch.cuda.synchronize(fl.device)
        seconds = a.elapsed_time(b) / 1e3
    else:
        t0 = time.perf_counter()
        smooth().x[0].item()
        seconds = time.perf_counter() - t0
    return SOLVER_ITERS / max(seconds, 1e-9)


def device_name(device: torch.device) -> str:
    """The card's name and power limit as nvidia-smi prints them, or
    "cpu"."""
    if device.type != "cuda":
        return "cpu"
    index = device.index if device.index is not None \
        else torch.cuda.current_device()
    try:
        out = subprocess.run(
            ["nvidia-smi", "-i", str(index), "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True, timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return f"{torch.cuda.get_device_name(index)}, power limit not read"
    return out.splitlines()[0]


def host_info() -> dict:
    """The host's CPU (model name, then vendor, family, model and clock,
    since a virtualized host may report the name as unknown) and logical
    CPU count, and the torch and CUDA versions."""
    cpu = {}
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if not line.strip():
                    break  # the first processor's block
                key, _, value = line.partition(":")
                cpu[key.strip()] = value.strip()
    except OSError:
        pass
    name = cpu.get("model name") or platform.processor() or "unknown"
    if "vendor_id" in cpu:
        name += (f" ({cpu['vendor_id']} family {cpu.get('cpu family', '?')}"
                 f" model {cpu.get('model', '?')}, "
                 f"{cpu.get('cpu MHz', '?')} MHz)")
    return {"cpu": name, "logical_cpus": os.cpu_count(),
            "torch": torch.__version__, "cuda": torch.version.cuda}


def _stage_medians(fl) -> dict:
    if fl.device.type != "cuda":
        return {}
    return {k: round(float(np.median(v)), 3)
            for k, v in fl.stats.device_times_ms().items() if v}


def main(argv=None, device=None) -> dict:
    """Runs the bench; prints and returns its result line. device
    overrides --cpu (the tests pass "cpu")."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU with the plain kernels")
    args = ap.parse_args(argv)
    device = torch.device(device or ("cpu" if args.cpu else "cuda"))
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("flame_tpu_torch.bench runs on a CUDA card; "
                           "pass --cpu to run it on the CPU")

    res = os.environ.get("BENCH_RES", "640x480")
    W, H = (int(v) for v in res.split("x"))
    n_feats = int(os.environ.get("BENCH_FEATS", 4096))
    modes = resolve_modes()
    n_windows = int(os.environ.get("BENCH_WINDOWS", 25))
    n_windows_2nd = min(int(os.environ.get("BENCH_WINDOWS_SECONDARY", 12)),
                        n_windows)
    base_win = int(os.environ.get("BENCH_WINLEN", 16))

    def win_len(fb):
        # Rounded up to a multiple of frame_batch: every window's frames
        # are dispatched before its drain.
        fb = max(int(fb), 1)
        return -(-base_win // fb) * fb

    win_len_max = max(win_len(mode_params(m, n_feats).solver.frame_batch)
                      for m in modes)
    n_warm_max = 16 + 8  # BA's warm-up is the longest
    render = renderer(W, H)
    frames_np = [render(0.08 * i)
                 for i in range(n_warm_max + n_windows * win_len_max)]

    verbose = bool(os.environ.get("BENCH_VERBOSE"))
    mode_fps, mode_windows, mode_fetch, extras = {}, {}, {}, {}
    headline = None
    for mi, mode in enumerate(modes):
        params = mode_params(mode, n_feats)
        wl = win_len(params.solver.frame_batch)
        n_warm = 16 + (8 if params.do_ba else 0)
        nw = n_windows if mi == 0 else n_windows_2nd
        _kernels.reset_launches()
        fps, win_fps, fl, lat, rtt = measure_mode(
            params, frames_np[: n_warm + nw * wl], mode != "host_upload",
            n_warm, nw, wl, device)
        mode_fps[mode] = round(fps, 2)
        mode_windows[mode] = nw
        w = fl.stats.snapshot()["stats"].get("fetch_latency_ms")
        if w is not None:
            mode_fetch[mode] = round(float(w), 1)
        if verbose:
            extras[mode] = {
                "win_fps": [round(f, 1) for f in win_fps],
                "win_len": wl,
                "rtt_probe_ms_median": round(1e3 * float(np.median(rtt)), 4),
                "stage_ms_median": _stage_medians(fl),
                "launches": dict(_kernels.LAUNCHES),
            }
        if mi == 0:
            headline = (mode, fps, win_fps, fl, lat, params)

    mode, fps, win_fps, fl, lat, params = headline
    _kernels.reset_launches()
    iters_per_sec = solver_rate(params, fl)
    solver_launches = dict(_kernels.LAUNCHES)

    idm = fl.get_inverse_depth_map()
    cov = float(np.mean(~np.isnan(idm)))
    err = np.abs(idm[~np.isnan(idm)] - 1.0 / PLANE_Z) * PLANE_Z

    metric = ("vga_dense_fps_per_chip" if (W, H) == (640, 480)
              else f"{res}_dense_fps_per_chip")
    result = {
        "metric": metric,
        "value": round(fps, 2),
        "unit": "frames/sec",
        "solver_iters_per_sec": round(iters_per_sec),
        "modes": mode_fps,
        "windows": mode_windows,
        "mode_fetch_ms": mode_fetch,
        "do_ba": mode == "resident_ba",
        "coverage": round(cov, 3),
        # null, not NaN (not strict JSON), when the map is empty.
        "median_rel_depth_err": (round(float(np.median(err)), 4)
                                 if err.size else None),
        "win_fps_best": round(float(np.max(win_fps)), 1),
    }
    if lat is not None:
        result["latency_ms_p50"] = round(lat[0], 1)
        result["latency_ms_p95"] = round(lat[1], 1)
    snap = fl.stats.snapshot()["stats"]
    weather = snap.get("fetch_latency_ms")
    if weather is not None:
        result["fetch_latency_ms"] = round(float(weather), 1)
    result["packed_sheds"] = int(snap.get("packed_sheds", 0))
    result["device"] = device_name(fl.device)
    result["host"] = host_info()

    if verbose:
        extra = {
            "modes": extras,
            "n_feats": int(fl._feats.valid.sum().item()),
            "n_vtx": int(fl._graph.vtx_mask.sum().item()),
            "n_edges": fl._n_edges,
            "smoother": pipeline.resolve_smoother(params),
            "solver_launches": solver_launches,
            "timings_ms": {k: round(v, 2) for k, v in
                           fl.stats.snapshot()["timings_ms"].items()},
            "stats": {k: round(v, 3) for k, v in snap.items()},
        }
        if mode == "resident_ba" and fl._ba is not None:
            extra["ba_last_cost"] = fl._ba.last_cost
            extra["ba_last_accepted"] = fl._ba.last_accepted
        print(json.dumps(extra), file=sys.stderr)

    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main()
