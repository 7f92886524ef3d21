"""Finds the benchmark's data and plug-in files by name.

  BENCHMARK.json             the cells and metrics (repo root)
  configs/<config>.json      a deployment: camera, scene, Params overrides
  traffic/<traffic>.json     a traffic mix: the posture (Params overrides),
                             poseframe cadence, pose noise and loop
  workloads/<cell>.json      a cell: the limits of its compared numbers
  metrics/<metric>.py        a per-layer metric's reader: read(ctx)
  roofline/<kernel>.py       a kernel's bytes and operations per call
  compare/<name>.py          compared numbers of a cell's own: NUMBERS,
                             HOOKS (points, a method as "Class.method"),
                             Listener and numbers(); installed where a
                             cell's limits name one of its NUMBERS

A new cell, configuration, metric, kernel or compared number is a new
file here and an entry in BENCHMARK.json or a workload's limits;
nothing else is edited.
"""

import glob
import importlib.util
import json
import os
import re

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REPO_DIR = os.path.dirname(BENCH_DIR)


def _read_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def spec(path: str = None) -> dict:
    return _read_json(path or os.path.join(REPO_DIR, "BENCHMARK.json"))


def config(name: str, bench_dir: str = BENCH_DIR) -> dict:
    return _read_json(os.path.join(bench_dir, "configs", f"{name}.json"))


def workload(name: str, bench_dir: str = BENCH_DIR) -> dict:
    return _read_json(os.path.join(bench_dir, "workloads", f"{name}.json"))


def traffic(name: str, bench_dir: str = BENCH_DIR) -> dict:
    return _read_json(os.path.join(bench_dir, "traffic", f"{name}.json"))


def cell(sp: dict, name: str) -> dict:
    """The spec's entry of a cell (its config, traffic and chips)."""
    for w in sp["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no cell {name!r} in BENCHMARK.json")


def load_module(path: str):
    """A plug-in file as a module of its own (file names may hold dots)."""
    name = "bench_plugin_" + re.sub(r"\W", "_", os.path.relpath(
        path, os.path.dirname(path) + "/.."))
    sp = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(sp)
    sp.loader.exec_module(mod)
    return mod


def metric_reader(name: str, bench_dir: str = BENCH_DIR):
    return load_module(os.path.join(bench_dir, "metrics", f"{name}.py"))


def rooflines(bench_dir: str = BENCH_DIR) -> dict:
    """Every kernel's roofline file, by kernel name."""
    return {os.path.basename(p)[:-3]: load_module(p) for p in sorted(
        glob.glob(os.path.join(bench_dir, "roofline", "*.py")))
        if not os.path.basename(p).startswith("_")}


def compare_plugins(bench_dir: str = BENCH_DIR, reserved=()) -> dict:
    """Every compared-number plug-in file, by file name. A name in a
    plug-in's NUMBERS that is reserved (the built-in checks') or that
    another plug-in gives, or that ends in ".control", raises."""
    plugins, owner = {}, dict.fromkeys(reserved, "the built-in checks")
    for p in sorted(glob.glob(os.path.join(bench_dir, "compare", "*.py"))):
        name = os.path.basename(p)[:-3]
        if name.startswith("_"):
            continue
        mod = load_module(p)
        for n in mod.NUMBERS:
            taken = owner.get(n) or (n.endswith(".control")
                                     and "the control readings")
            if taken:
                raise ValueError(f"compare/{name}.py: number {n!r} is "
                                 f"taken by {taken}")
            owner[n] = f"compare/{name}.py"
        plugins[name] = mod
    return plugins


def cell_metrics(sp: dict, cell: str, kind: str) -> list:
    """The spec's end_to_end or per_layer entries that the cell reports."""
    return [m for m in sp[kind] if cell in m.get("workloads", [cell])]
