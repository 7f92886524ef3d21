"""The flame_tpu_torch benchmark: one run of one cell.

    python3 benchmark/run.py --workload tum_vga.sync --seed 12345 \\
        --seconds 30 --trace 0

Runs from the root of a checkout on a machine with the card(s) the cell
asks for (BENCHMARK.json). It makes the cell's scene and poses from
--seed on the card, builds flame_tpu_torch.Flame with the cell's Params,
warms up, measures a closed loop for --seconds and compares what the
window produced with the plain references (benchmark/reference/). With
--trace 0 the result's metrics are the cell's end-to-end metrics; with
--trace 1 a profiled slice follows the window and the metrics are the
cell's per-layer metrics.

Standard output ends with one JSON line: correct, attempted, failed,
metrics, device (and breakdown with --trace 1), then checks, each
compared number with its limit; standard error ends with the same
numbers, one line each. Without a CUDA card, with fewer cards than the
cell asks for, or with jax, jaxlib, flax or flame_tpu loaded once the
window has closed, it exits with a code other than 0 and prints no
result.
"""

import argparse
import json
import os
import sys
import time


def _process_start() -> float:
    """perf_counter() reading of this process's start (Linux), else now."""
    now = time.perf_counter()
    try:
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        age = uptime - start_ticks / os.sysconf("SC_CLK_TCK")
        return now - max(0.0, age)
    except (OSError, ValueError, IndexError):
        return now


T_START = _process_start()
BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
REPO_DIR = os.path.dirname(BENCH_DIR)
FORBIDDEN = ("jax", "jaxlib", "flax", "flame_tpu")


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is a forbidden one, compared
    whole (flame_tpu_torch is not flame_tpu)."""
    return sorted({m for m in sys.modules if m.split(".")[0] in FORBIDDEN})


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    for p in (REPO_DIR, BENCH_DIR):
        if p not in sys.path:
            sys.path.insert(0, p)
    from harness import registry
    spec = registry.spec()
    chips = {w["name"]: int(w["chips"]) for w in spec["workloads"]}
    if args.workload not in chips:
        print(f"unknown workload {args.workload!r}", file=sys.stderr)
        return 2

    import torch
    if not torch.cuda.is_available() \
            or torch.cuda.device_count() < chips[args.workload]:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"benchmark: the cell needs {chips[args.workload]} CUDA "
              f"card(s), found {n}; no result", file=sys.stderr)
        return 3

    from harness import cell

    def log(msg):
        print(f"benchmark: {msg}", file=sys.stderr, flush=True)

    result = cell.run(args.workload, args.seed, args.seconds,
                      bool(args.trace), T_START, device="cuda", log=log)
    bad = forbidden_modules()
    if bad:
        print(f"benchmark: forbidden modules loaded: {bad}; no result",
              file=sys.stderr)
        return 4
    extra = result.pop("_extra")
    print("benchmark: readings " + json.dumps(extra), file=sys.stderr)
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
