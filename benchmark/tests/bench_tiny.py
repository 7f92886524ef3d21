"""A copy of the benchmark in a temporary folder with tiny cells beside
the real ones, small enough for the CPU: the tests drive the harness
through it without a card (device="cpu", the port's plain kernels)."""

import json
import os
import shutil
import sys
import time

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REPO_DIR = os.path.dirname(BENCH_DIR)
for _p in (REPO_DIR, BENCH_DIR):
    if _p not in sys.path:
        sys.path.insert(0, _p)

TINY_CAMERA = dict(width=160, height=120, fx=129.3, fy=129.1, cx=79.6,
                   cy=63.8)
TINY_PARAMS = dict(feature_capacity=512, edge_capacity=2048,
                   triangle_capacity=1536, poseframe_capacity=8)


def make(tmp: str) -> dict:
    """Copies benchmark/ into tmp and adds a 160x120 configuration per
    real one, a traffic mix per real one (the same posture, fewer warm-up
    frames and samples) and a cell tiny.<cell> per real cell with its
    limits. Returns the paths the harness takes."""
    dst = os.path.join(tmp, "benchmark")
    shutil.copytree(BENCH_DIR, dst, ignore=shutil.ignore_patterns(
        "tests", "__pycache__"))
    with open(os.path.join(REPO_DIR, "BENCHMARK.json")) as f:
        spec = json.load(f)
    for c in list(spec["configs"]):
        with open(os.path.join(dst, "configs", c["name"] + ".json")) as f:
            cfg = json.load(f)
        cfg["name"] = "tiny_" + c["name"]
        cfg["camera"].update(TINY_CAMERA)
        cfg["params"].update(TINY_PARAMS)
        cfg["params"]["solver"]["n_iters_per_frame"] = 20
        with open(os.path.join(dst, "configs", cfg["name"] + ".json"),
                  "w") as f:
            json.dump(cfg, f)
    for t in sorted({w["traffic"] for w in spec["workloads"]}):
        with open(os.path.join(dst, "traffic", t + ".json")) as f:
            tr = json.load(f)
        tr["name"] = "tiny_" + t
        tr["loop"].update(samples=2, trace_frames=8,
                          warmup_frames=min(tr["loop"]["warmup_frames"], 48))
        with open(os.path.join(dst, "traffic", tr["name"] + ".json"),
                  "w") as f:
            json.dump(tr, f)
    for w in list(spec["workloads"]):
        with open(os.path.join(dst, "workloads", w["name"] + ".json")) as f:
            wl = json.load(f)
        name = "tiny." + w["name"]
        wl["name"] = name
        with open(os.path.join(dst, "workloads", name + ".json"), "w") as f:
            json.dump(wl, f)
        spec["workloads"].append(dict(w, name=name,
                                      config="tiny_" + w["config"],
                                      traffic="tiny_" + w["traffic"]))
        for m in spec["end_to_end"] + spec["per_layer"]:
            if w["name"] in m.get("workloads", []):
                m["workloads"].append(name)
    spec_path = os.path.join(tmp, "BENCHMARK.json")
    with open(spec_path, "w") as f:
        json.dump(spec, f)
    return dict(bench_dir=dst, spec_path=spec_path)


def run(paths: dict, cell: str, seed: int = 2 ** 31 + 7,
        seconds: float = 2.0, control: bool = False) -> dict:
    from harness import cell as cell_mod
    return cell_mod.run("tiny." + cell, seed, seconds, False,
                        time.perf_counter(), device="cpu", control=control,
                        **paths)
