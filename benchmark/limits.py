"""Readings for the limits of `correct`: runs one cell on several seeds
in one process, each with a short window at the cell's own size, and
prints per seed the numbers compared by the program and by the control
(the references in bfloat16 in the program's place).

    python3 benchmark/limits.py --workload tum_vga.sync \\
        --seeds 101,102,103 --seconds 8 [--out FILE]

One JSON line per seed on standard output (and appended to --out);
the benchmark's own runs never run this.
"""

import argparse
import json
import os
import sys
import time

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [os.path.dirname(BENCH_DIR), BENCH_DIR]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=8.0)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    from harness import cell
    for seed in (int(s) for s in args.seeds.split(",")):
        t = time.perf_counter()
        r = cell.run(args.workload, seed, args.seconds, False, t,
                     control=True)
        e = r["_extra"]
        line = dict(workload=args.workload, seed=seed, correct=r["correct"],
                    values=e["values"], e2e=e["e2e"], frames=e["frames"],
                    samples=e["n_samples"], reference_s=e["reference_s"])
        print(json.dumps(line), flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(json.dumps(line) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
