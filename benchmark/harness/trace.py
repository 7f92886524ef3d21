"""The traced slice: torch.profiler over a few frames after the window,
reduced to the device's busy time, its kernels and its idle gaps.

The profiler's chrome trace is written to a temporary file under TMPDIR,
read back and deleted. Device intervals are the kernel, memcpy and
memset events; busy time is their union inside the benchmark's own
"bench.slice" span, and an idle gap is labelled by the innermost host
span open on the main thread when the gap began (a benchmark span
"bench.update" / "bench.map_read", or a torch op inside one).
"""

import json
import os
import tempfile
from collections import defaultdict

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation")
SLICE = "bench.slice"


def profile(run):
    """Run run() under torch.profiler (host and device activity) inside
    the "bench.slice" span; returns the trace's events."""
    import torch
    from torch.profiler import ProfilerActivity, record_function
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        with record_function(SLICE):
            run()
            torch.cuda.synchronize()
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.remove(path)
    return events


def _union(intervals):
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def reduce(events, n_top: int = 10) -> dict:
    """busy_s, window_s, kernel durations by name (seconds), the number
    of kernels, and the breakdown's device_ops / idle_gaps lists."""
    xs = [e for e in events if e.get("ph") == "X" and "dur" in e]
    span = [e for e in xs if e.get("name") == SLICE]
    if not span:
        raise RuntimeError("profiler trace has no bench.slice span")
    s0 = float(span[0]["ts"])
    s1 = s0 + float(span[0]["dur"])
    main_tid = span[0].get("tid")
    dev, kernels = [], defaultdict(list)
    for e in xs:
        if e.get("cat") not in DEVICE_CATS:
            continue
        a, b = float(e["ts"]), float(e["ts"]) + float(e["dur"])
        a, b = max(a, s0), min(b, s1)
        if b <= a:
            continue
        dev.append((a, b))
        if e["cat"] == "kernel":
            kernels[e["name"]].append(float(e["dur"]) * 1e-6)
    busy = _union(dev)
    busy_us = sum(b - a for a, b in busy)
    gaps, prev = [], s0
    for a, b in busy:
        if a > prev:
            gaps.append((prev, a))
        prev = max(prev, b)
    if s1 > prev:
        gaps.append((prev, s1))

    host = sorted(((float(e["ts"]), float(e["ts"]) + float(e["dur"]),
                    e["name"]) for e in xs
                   if e.get("cat") in HOST_CATS and e.get("tid") == main_tid
                   and e["name"] != SLICE), key=lambda h: (h[0], -h[1]))
    idle = defaultdict(float)
    stack, i = [], 0
    for g0, g1 in gaps:
        while i < len(host) and host[i][0] <= g0:
            stack.append(host[i])
            i += 1
        while stack and stack[-1][1] <= g0:
            stack.pop()
        # Nested spans: drop closed ones below an open top as well.
        stack = [h for h in stack if h[1] > g0]
        label = stack[-1][2] if stack else "host, outside any span"
        idle[label[:120]] += (g1 - g0) * 1e-6

    by_op = defaultdict(float)
    for e in xs:
        if e.get("cat") in DEVICE_CATS:
            by_op[e["name"][:120]] += float(e["dur"]) * 1e-6
    top = sorted(by_op.items(), key=lambda kv: -kv[1])[:n_top]
    gaps_top = sorted(idle.items(), key=lambda kv: -kv[1])[:n_top]
    return dict(busy_s=busy_us * 1e-6, window_s=(s1 - s0) * 1e-6,
                kernels=dict(kernels),
                n_kernels=sum(len(v) for v in kernels.values()),
                device_ops=[[k, v] for k, v in top],
                idle_gaps=[[k, v] for k, v in gaps_top])
