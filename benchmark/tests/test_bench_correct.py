"""`correct` on the CPU at a size a test run holds: sound runs of the
tiny cells pass their cell's limits; the bfloat16 control fails them;
and with the timed path broken underneath (the harness's look for a
card skipped), `correct` comes out false for each fault the cell can
have: a step that returns its state unchanged, half of a batch left
out, an answer altered where it is produced."""

import pytest
import torch

import bench_tiny
from flame_tpu_torch.core import pipeline
from flame_tpu_torch.mesh import delaunay
from flame_tpu_torch.ops import raster_kernel
from flame_tpu_torch.optimize import smoother_kernel
from harness import checks, registry


@pytest.fixture(scope="module")
def paths(tmp_path_factory):
    return bench_tiny.make(str(tmp_path_factory.mktemp("bench")))


CELLS = ["tum_vga.sync", "tum_vga.batched"]


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_passes_and_control_fails(paths, cell):
    r = bench_tiny.run(paths, cell, control=True)
    assert r["correct"], r["checks"]
    values = r["_extra"]["values"]
    limits = registry.workload("tiny." + cell, paths["bench_dir"])["limits"]
    failed = [n for n in limits if n + ".control" in values
              and values[n + ".control"] > limits[n]]
    assert failed, values


def _state_unchanged_smoother(monkeypatch):
    monkeypatch.setattr(smoother_kernel, "smooth", lambda p, g, n: g)


def _state_unchanged_tracking(monkeypatch):
    orig = pipeline.track_project_sync

    def track(params, K, Kinv, stack, feats, fnew, slot):
        _f, curr, member, stats, obs = orig(params, K, Kinv, stack, feats,
                                            fnew, slot)
        return feats, curr, member, stats, obs
    monkeypatch.setattr(pipeline, "track_project_sync", track)


def _half_of_batch(monkeypatch):
    orig = raster_kernel.rasterize_batch_with_count

    def raster(verts, *args, **kw):
        maps, count = orig(verts, *args, **kw)
        maps = maps.clone()
        maps[maps.shape[0] // 2:] = float("nan")
        return maps, count
    monkeypatch.setattr(raster_kernel, "rasterize_batch_with_count", raster)


def _answer_altered(monkeypatch):
    orig = raster_kernel.rasterize

    def raster(*args, **kw):
        out = orig(*args, **kw).clone()
        ok = ~torch.isnan(out)
        if bool(ok.any()):
            i = int(torch.nonzero(ok.reshape(-1))[0])
            out.view(-1)[i] *= 10.0
        return out
    monkeypatch.setattr(raster_kernel, "rasterize", raster)


def _triangle_dropped(monkeypatch):
    orig = delaunay.triangulate

    def triangulate(points):
        tri = orig(points)
        return tri._replace(triangles=tri.triangles[:-1])
    monkeypatch.setattr(delaunay, "triangulate", triangulate)


def _data_term_stale(monkeypatch):
    orig = pipeline._graph_sync_inner

    def sync(params, graph, *args, **kw):
        return orig(params, graph, *args, **kw).replace(
            data_term=graph.data_term)
    monkeypatch.setattr(pipeline, "_graph_sync_inner", sync)


def _map_unsmoothed(monkeypatch):
    orig = pipeline.mesh_outputs

    def outputs(params, K, Kinv, width, height, graph, *args, **kw):
        return orig(params, K, Kinv, width, height,
                    graph.replace(x=graph.data_term), *args, **kw)
    monkeypatch.setattr(pipeline, "mesh_outputs", outputs)


def _mesh_stale(monkeypatch):
    orig = pipeline._post_delaunay_inner
    last = {}

    def post(*args, **kw):
        topo = {k: kw[k] for k in ("tris", "n_tris", "edges", "n_edges",
                                   "edge_ranks")}
        kw.update(last or topo)
        last.update(topo)
        return orig(*args, **kw)
    monkeypatch.setattr(pipeline, "_post_delaunay_inner", post)


FAULTS = [
    ("tum_vga.sync", _state_unchanged_smoother, "k1_gap"),
    ("tum_vga.sync", _state_unchanged_tracking, "track_miss"),
    ("tum_vga.sync", _answer_altered, "map_gap"),
    ("tum_vga.sync", _triangle_dropped, "tri_gap"),
    ("tum_vga.sync", _data_term_stale, "sync_gap"),
    ("tum_vga.sync", _mesh_stale, "sync_miss"),
    ("tum_vga.sync", _map_unsmoothed, "sync_gap"),
    ("tum_vga.batched", _state_unchanged_smoother, "k1_gap"),
    ("tum_vga.batched", _half_of_batch, "views_miss"),
    ("tum_vga.batched", _answer_altered, "map_gap"),
    ("tum_vga.batched", _triangle_dropped, "tri_gap"),
    ("tum_vga.batched", _data_term_stale, "sync_gap"),
]


@pytest.mark.parametrize("cell,fault,number", FAULTS,
                         ids=[f"{c}-{f.__name__[1:]}" for c, f, _ in FAULTS])
def test_fault_is_not_correct(paths, monkeypatch, cell, fault, number):
    fault(monkeypatch)
    r = bench_tiny.run(paths, cell)
    assert not r["correct"]
    c = r["checks"][number]
    assert not (c["value"] is not None and c["value"] <= c["limit"]), c


def test_decide_fails_missing_and_nan():
    ok, _ = checks.decide({"a": 0.1}, {"a": 1.0, "b": 1.0})
    assert not ok
    ok, _ = checks.decide({"a": float("nan")}, {"a": 1.0})
    assert not ok
    ok, rows = checks.decide({"a": 0.5}, {"a": 1.0})
    assert ok and rows == [("a", 0.5, 1.0)]
