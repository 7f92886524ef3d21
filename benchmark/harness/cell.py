"""One run of one cell: set-up, warm-up, the measured window, the traced
slice (--trace 1), the correctness comparison and the result line.

The window is a closed loop, as flame_ros replays a recorded sequence:
each frame goes to Flame.update as a host numpy uint8 array with its
pose; after every frame (frame_batch 1) or every full batch of
frame_batch frames the harness reads the dense map with
get_inverse_depth_map(), as a frontend publishes it, and only then sends
the next frame. The window ends in a drain (torch.cuda.synchronize(),
then a map read).

  fps                 frames read in the window over its wall seconds,
                      drain included
  map_latency_ms_p95  95th percentile over every frame of the window of
                      the host time from its update() call to the return
                      of the map read that first includes it
  setup_s             process start to the first timed frame
"""

import gc
import time

import numpy as np
import torch

from harness import checks, hooks, registry, trace
from scenes import box_room

PEAK_BYTES_PER_S = 3.35e12  # H100 SXM HBM3 (NVIDIA data sheet, 700 W)
PEAK_F32_OPS_PER_S = 67e12  # fp32 outside the tensor cores


def _merge(base: dict, over: dict) -> dict:
    out = dict(base)
    for k, v in over.items():
        out[k] = _merge(out.get(k, {}), v) if isinstance(v, dict) else v
    return out


def build_params(cfg: dict, tr: dict):
    from flame_tpu_torch import convert
    return convert.params_from_dict(_merge(cfg["params"], tr["posture"]))


class Feed:
    """The cell's frames and poses: frame k of a run shows frame
    start + k of the trajectory (its image is the period's frame
    (start + k) mod P) with its input pose (true, or with the cell's
    noise); start comes from the seed."""

    def __init__(self, cfg: dict, tr: dict, seed: int, scene, n_max: int):
        self.cfg = cfg
        self.P = box_room.period_frames(cfg)
        self.start = box_room.start_frame(cfg, seed)
        self.images = scene.render_host(range(self.P))
        noise = tr.get("pose_noise", {})
        self.poses = box_room.noisy_poses(
            cfg, n_max, float(noise.get("t_m", 0.0)),
            float(noise.get("deg", 0.0)), seed, self.start)
        self.hz = float(cfg["camera"]["hz"])
        self.pf_every = int(tr["poseframe_every"])

    def image(self, k: int) -> np.ndarray:
        return self.images[(self.start + k) % self.P]

    def send(self, fl, k: int) -> bool:
        if k >= len(self.poses):
            raise RuntimeError(f"frame {k} past the {len(self.poses)} "
                               f"poses drawn at set-up (the traffic's "
                               f"loop.max_fps caps the window's frames)")
        return fl.update(k / self.hz, k, self.poses[k], self.image(k),
                         k % self.pf_every == 0)


def _group(params) -> int:
    fb = int(params.solver.frame_batch)
    return fb if fb > 1 and params.solver.async_topology else 1


def _stage_events(fl, cuda: bool) -> dict:
    """StatsTracker's CUDA-event times per stage so far (none on the
    CPU, where the tracker records no events)."""
    if not cuda:
        return {}
    return {k: list(v) for k, v in fl.stats.device_times_ms().items()}


def run(workload: str, seed: int, seconds: float, traced: bool,
        t_start: float, device="cuda", bench_dir=registry.BENCH_DIR,
        spec_path=None, control=False, log=None) -> dict:
    """One run; returns the result line's fields, then "checks" (each
    compared number with its limit) and "_extra" (the run's other
    readings, for the limits script and the tests)."""
    log = log or (lambda *a: None)
    sp = registry.spec(spec_path)
    entry = registry.cell(sp, workload)
    wl = registry.workload(workload, bench_dir)
    cfg = registry.config(entry["config"], bench_dir)
    tr = registry.traffic(entry["traffic"], bench_dir)
    # The compared-number plug-ins whose numbers the cell's limits name.
    plugins = {name: mod for name, mod in registry.compare_plugins(
        bench_dir, checks.NUMBERS).items()
        if set(mod.NUMBERS) & set(wl["limits"])}
    dev = torch.device(device)
    cuda = dev.type == "cuda"
    torch.manual_seed(seed % (2 ** 63))
    params = build_params(cfg, tr)
    group = _group(params)
    loop = tr["loop"]
    n_warm = int(loop["warmup_frames"])
    n_trace = int(loop["trace_frames"]) if traced else 0
    n_max = n_warm + int(seconds * loop["max_fps"]) + n_trace + 2 * group

    scene = box_room.Scene(cfg, dev)
    feed = Feed(cfg, tr, seed, scene, n_max)
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()

    from flame_tpu_torch import Flame
    from flame_tpu_torch.geometry import camera
    K = camera.make_k(scene.fx, scene.fy, scene.cx, scene.cy)
    fl = Flame(scene.W, scene.H, K, camera.inv_k(K), params, device=dev)

    hk = hooks.Hooks()
    sampler = hooks.Sampler()
    roofs = registry.rooflines(bench_dir)
    recorders = {}
    for name, mod in roofs.items():
        recorders.setdefault(tuple(mod.HOOK), []).append((name, mod.record))
    calllog = hooks.CallLog(recorders)
    for point in (hooks.SMOOTH, hooks.RASTER, hooks.RASTER_BATCH,
                  hooks.TRACK, hooks.POST, hooks.DELAUNAY):
        hk.listen(point, sampler)
    if traced:
        for point in recorders:
            hk.listen(point, calllog)
    listeners = {name: mod.Listener() for name, mod in plugins.items()}
    for name, mod in plugins.items():
        for point in mod.HOOKS:
            hk.listen(point, listeners[name])
    hk.install()
    try:
        out = _drive(fl, feed, group, n_warm, n_trace, seconds, seed,
                     int(loop["samples"]), sampler, calllog, listeners,
                     t_start, cuda, log)
    finally:
        hk.uninstall()

    mem_peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
    stages = out.pop("stages")
    out["n_poseframes_live"] = len(fl._pf_slot_by_id)
    out["features_live"] = int(fl._n_valid)
    out["triangles"] = int(fl._n_tris)
    out["start_frame"] = feed.start
    del fl
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    # The references run once the window has closed, on the same device.
    t_ref = time.perf_counter()
    samples = out.pop("samples")
    out["n_samples"] = len(samples)
    values = checks.numbers(samples, dev, cfg, feed.image, control=control)
    captures = out.pop("plugin_captures")
    for name, mod in plugins.items():
        got = mod.numbers(captures[name], dev, cfg, feed.image,
                          control=control)
        stray = {n.removesuffix(".control") for n in got} - set(mod.NUMBERS)
        if stray:
            raise ValueError(f"compare/{name}.py gave numbers outside its "
                             f"NUMBERS: {sorted(stray)}")
        values.update(got)
    out["reference_s"] = time.perf_counter() - t_ref
    correct, rows = checks.decide(values, wl["limits"])
    out["values"] = values

    metrics = {}
    if not traced:
        for m in registry.cell_metrics(sp, workload, "end_to_end"):
            v = out["e2e"].get(m["name"])
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        ctx = _context(out, stages, roofs, calllog)
        for m in registry.cell_metrics(sp, workload, "per_layer"):
            v = registry.metric_reader(m["name"], bench_dir).read(ctx)
            if v is not None:
                metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    result = {
        "correct": bool(correct),
        "attempted": out["attempted"],
        "failed": out["failed"],
        "metrics": metrics,
        "device": {
            "platform": "gpu" if cuda else "cpu",
            "kind": torch.cuda.get_device_name(dev) if cuda else "cpu",
            "count": 1,
            "memory_peak_bytes": int(mem_peak)},
    }
    if traced:
        tr = out["trace"]
        result["device"]["busy_s"] = tr["busy_s"]
        result["device"]["window_s"] = tr["window_s"]
        result["breakdown"] = {"device_ops": tr["device_ops"],
                               "idle_gaps": tr["idle_gaps"]}
    result["checks"] = {n: {"value": v, "limit": lim} for n, v, lim in rows}
    result["_extra"] = {k: out[k] for k in out if k not in ("trace",)}
    if traced:
        # The slice's frame time beside its idle share: the profiler's
        # recording slows the host's frames, and with them the share.
        t = out["trace"]
        result["_extra"]["traced"] = dict(
            frames=t["frames"], window_s=t["window_s"],
            ms_per_frame=1e3 * t["window_s"] / max(t["frames"], 1),
            idle_share=1.0 - t["busy_s"] / t["window_s"])
    return result


def _drive(fl, feed, group, n_warm, n_trace, seconds, seed, n_samples,
           sampler, calllog, listeners, t_start, cuda, log):
    """Warm-up, window (and traced slice); returns the run's readings.
    The plug-ins' listeners are armed at the sampled reads and hand over
    what they kept once, after the window's drain."""
    def sync():
        if cuda:
            torch.cuda.synchronize()

    def step(k):
        """Send one read's frames from k; returns (ok flags, stamps,
        map, return time)."""
        oks, stamps = [], []
        for j in range(group):
            stamps.append(time.perf_counter())
            oks.append(feed.send(fl, k + j))
        m = fl.get_inverse_depth_map()
        return oks, stamps, m, time.perf_counter()

    k = 0
    t_w = []
    while k < n_warm:
        _, _, _, t_ret = step(k)
        t_w.append(t_ret)
        k += group
    sync()
    fl.get_inverse_depth_map()
    if len(t_w) >= 4:
        half = t_w[len(t_w) // 2:]
        rate = (len(half) - 1) / max(half[-1] - half[0], 1e-6)
    else:
        rate = 1.0
    # n_samples reads of the window, drawn from the seed among the reads
    # that the warm-up's rate says the window will hold.
    expected = max(int(0.9 * rate * seconds), 1)
    rng = np.random.default_rng([seed, 2])
    chosen = set(rng.choice(expected, min(n_samples, expected),
                            replace=False).tolist())
    ev0 = {k_: len(v) for k_, v in _stage_events(fl, cuda).items()}
    t0 = time.perf_counter()
    setup_s = t0 - t_start
    lat, samples, failed, reads, k_first = [], [], 0, 0, k
    while True:
        armed = reads in chosen
        if armed:
            sampler.arm()
            for ls in listeners.values():
                ls.arm()
        oks, stamps, m, t_ret = step(k)
        lat.extend(t_ret - s for s in stamps)
        failed += sum(not o for o in oks)
        if armed:
            samples.append(dict(frame=k, captures=sampler.take(), map=m))
        k += group
        reads += 1
        if t_ret - t0 >= seconds:
            break
    sync()
    fl.get_inverse_depth_map()
    t_end = time.perf_counter()
    plugin_captures = {name: ls.take() for name, ls in listeners.items()}
    frames = k - k_first
    ev = _stage_events(fl, cuda)
    stages = {k_: v[ev0.get(k_, 0):] for k_, v in ev.items()}
    out = dict(
        e2e={"fps": frames / (t_end - t0),
             "map_latency_ms_p95": float(np.percentile(
                 1e3 * np.asarray(lat), 95)),
             "setup_s": setup_s},
        attempted=frames, failed=failed, frames=frames, reads=reads,
        window_s=t_end - t0, samples=samples,
        plugin_captures=plugin_captures,
        latency_ms_p50=float(np.percentile(1e3 * np.asarray(lat), 50)),
        stages=stages)
    log(f"window: {frames} frames in {t_end - t0:.3f} s, {reads} reads, "
        f"{len(samples)} samples, set-up {setup_s:.3f} s")
    if n_trace:
        n_read = -(-n_trace // group)
        state = {"k": k}

        def slice_():
            for _ in range(n_read):
                step_traced(state)

        def step_traced(st):
            from torch.profiler import record_function
            for j in range(group):
                with record_function("bench.update"):
                    feed.send(fl, st["k"] + j)
            with record_function("bench.map_read"):
                fl.get_inverse_depth_map()
            st["k"] += group

        calllog.recording = True
        events = trace.profile(slice_)
        calllog.recording = False
        out["trace"] = trace.reduce(events)
        out["trace"]["frames"] = state["k"] - k
        out["trace"]["reads"] = n_read
    return out


class Context:
    """What a per-layer metric's reader sees: the window's frames, reads,
    end-to-end readings (e2e) and stage times (CUDA-event milliseconds,
    StatsTracker's), the traced slice's reduction and each kernel's
    roofline reading."""

    def __init__(self, **kw):
        self.__dict__.update(kw)


def _roofline(mod, calls, kernel_s):
    """Mean bound over the slice's calls over the mean device time per
    call of the kernels whose name holds mod.KERNEL, or None."""
    if not calls or not kernel_s:
        return None
    bounds = []
    for rec in calls:
        nbytes, ops = mod.cost(rec)
        bounds.append(max(nbytes / PEAK_BYTES_PER_S,
                          ops / PEAK_F32_OPS_PER_S))
    return dict(bound_s=float(np.mean(bounds)),
                time_s=float(np.mean(kernel_s)), calls=len(calls),
                launches=len(kernel_s))


def _context(out, stages, roofs, calllog):
    tr = out["trace"]
    roof = {}
    for name, mod in roofs.items():
        ks = [d for kname, ds in tr["kernels"].items() if mod.KERNEL in kname
              for d in ds]
        roof[name] = _roofline(mod, calllog.calls.get(name), ks)
    return Context(frames=out["frames"], reads=out["reads"], e2e=out["e2e"],
                   stages=stages, trace=tr, rooflines=roof)
