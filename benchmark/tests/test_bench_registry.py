"""Every file of the benchmark is found by name, and a cell added as
new files is picked up without an edit elsewhere."""

import json
import os
import re

import pytest

import bench_tiny
from harness import registry

SPEC = registry.spec()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_spec_shape():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert SPEC["paths"] == ["benchmark"]
    assert 1 <= SPEC["run_seconds"] <= 51
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in SPEC[k]]
    assert all(NAME.match(n) for n in names)
    assert len(set(names)) == len(names)
    for m in SPEC["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert 0.01 <= m["bound"] <= 0.25
    assert "setup_s" in [m["name"] for m in SPEC["end_to_end"]]
    cells = {w["name"] for w in SPEC["workloads"]}
    for m in SPEC["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert UNIT.match(m["unit"]) and m["moves"] == "fps"
        assert set(m["workloads"]) <= cells
    assert len(json.dumps(SPEC)) < 64 * 1024


@pytest.mark.parametrize("cfg", SPEC["configs"], ids=lambda c: c["name"])
def test_config_found(cfg):
    c = registry.config(cfg["name"])
    assert c["name"] == cfg["name"]
    assert os.path.exists(os.path.join(registry.REPO_DIR, cfg["file"]))
    assert c["reduced"] == cfg["reduced"] == []
    assert len(cfg["source"]) <= 200


@pytest.mark.parametrize("cell", SPEC["workloads"], ids=lambda w: w["name"])
def test_workload_found(cell):
    wl = registry.workload(cell["name"])
    assert wl["name"] == cell["name"]
    assert cell["chips"] == 1
    assert wl["limits"] and all(v >= 0 for v in wl["limits"].values())
    tr = registry.traffic(cell["traffic"])
    assert tr["name"] == cell["traffic"]
    assert {"posture", "poseframe_every", "pose_noise", "loop"} <= set(tr)


@pytest.mark.parametrize("metric", SPEC["per_layer"],
                         ids=lambda m: m["name"])
def test_metric_reader_found(metric):
    assert callable(registry.metric_reader(metric["name"]).read)


def test_every_cell_reports_its_map_latency():
    """A cell that does not report map_latency_ms_p95 end to end reports
    it per layer, as loop.map_latency_ms_p95, beside fps."""
    for w in SPEC["workloads"]:
        e2e = [m["name"] for m in registry.cell_metrics(SPEC, w["name"],
                                                        "end_to_end")]
        layer = [m["name"] for m in registry.cell_metrics(SPEC, w["name"],
                                                          "per_layer")]
        assert "setup_s" in e2e and "fps" in e2e
        assert ("map_latency_ms_p95" in e2e) != (
            "loop.map_latency_ms_p95" in layer)


def test_loop_latency_reader_reads_the_window():
    """The reader gives the window's map latency p95 from the Context the
    traced run builds, and None from one without end-to-end readings."""
    from harness import cell
    out = dict(frames=16, reads=2, trace=dict(kernels={}),
               e2e=dict(fps=140.0, map_latency_ms_p95=66.5, setup_s=12.0))
    ctx = cell._context(out, {}, {}, None)
    reader = registry.metric_reader("loop.map_latency_ms_p95")
    assert reader.read(ctx) == 66.5
    assert reader.read(cell.Context(frames=16, reads=2)) is None


@pytest.mark.parametrize("name", sorted(registry.rooflines()))
def test_roofline_found(name):
    mod = registry.rooflines()[name]
    assert len(mod.HOOK) == 2 and mod.KERNEL
    assert callable(mod.record) and callable(mod.cost)


def test_new_cell_is_a_new_file(tmp_path):
    """A cell (and a metric that reports in every cell) added as new
    files in a copy of the benchmark is found without editing another
    file of it."""
    paths = bench_tiny.make(str(tmp_path))
    wl = registry.workload("tiny.tum_vga.sync", paths["bench_dir"])
    wl["name"] = "added.cell"
    with open(os.path.join(paths["bench_dir"], "workloads",
                           "added.cell.json"), "w") as f:
        json.dump(wl, f)
    tr = registry.traffic("tiny_sync_closed_loop", paths["bench_dir"])
    tr["name"] = "added_traffic"
    with open(os.path.join(paths["bench_dir"], "traffic",
                           "added_traffic.json"), "w") as f:
        json.dump(tr, f)
    with open(os.path.join(paths["bench_dir"], "metrics",
                           "added.metric.py"), "w") as f:
        f.write("def read(ctx):\n    return 1.0\n")
    sp = registry.spec(paths["spec_path"])
    sp["workloads"].append(dict(name="added.cell", config="tiny_tum_fr1_vga",
                                traffic="added_traffic", chips=1, why="w"))
    sp["per_layer"].append(dict(name="added.metric", unit="ms",
                                better="lower", source="program_span",
                                layer="l", moves="fps"))
    with open(paths["spec_path"], "w") as f:
        json.dump(sp, f)
    from harness import cell
    r = cell.run("added.cell", 2 ** 31 + 5, 1.0, False, 0.0, device="cpu",
                 **paths)
    assert r["attempted"] > 0 and set(r["checks"]) == set(wl["limits"])
    names = [m["name"] for m in registry.cell_metrics(sp, "added.cell",
                                                      "per_layer")]
    assert names == ["added.metric"]
    assert registry.metric_reader("added.metric",
                                  paths["bench_dir"]).read(None) == 1.0
