"""Bundle adjustment in the benchmark: compare/ba.py's listener keeps the
solves staged after an armed read with their results and a digest of
the frames they solved on; the plug-in is installed only in a cell
whose limits name its numbers (the tiny copy of euroc_wvga.ba, not of
tum_vga.batched), where it gives every name of its NUMBERS and their
controls; the three BA readers on a recorded ring."""

import math

import numpy as np
import pytest
import torch

import bench_tiny
from flame_tpu_torch.utils import stats
from harness import cell, registry
from test_bench_compare import _spied_run

PACK = ("flame_tpu_torch.ba.window", "_pack_problem")
STAGE = ("flame_tpu_torch.ba.window", "BundleAdjuster._stage_solve")
APPLY = ("flame_tpu_torch.ba.window", "BundleAdjuster._apply")


@pytest.fixture(scope="module")
def paths(tmp_path_factory):
    return bench_tiny.make(str(tmp_path_factory.mktemp("bench")))


@pytest.fixture(scope="module")
def plugin(paths):
    return registry.compare_plugins(paths["bench_dir"])["ba"]


class _Ba:
    K, Kinv = [[1.0]], [[1.0]]

    def __init__(self, accepted):
        self.params = "params"
        self.last_accepted = accepted


class _Fl:
    """A Flame whose frame stack's row i holds the value i."""

    class params:
        pad = 5

    class _stack:
        img_pad = torch.arange(8.0)[:, None, None].expand(8, 2, 3)


def _stage(ls, value):
    """A stage: the pack of upload `value` for the window slots [value,
    value + 1] inside _stage_solve."""
    fl = _Fl()
    tok = ls.before(STAGE, (_Ba(None), fl), {})
    tp = ls.before(PACK, (None, np.array([value, value + 1])), {})
    ls.after(PACK, tp, np.full(3, value, np.int32))
    ls.after(STAGE, tok, None)


def _apply(ls, value, accepted):
    """An apply; the program's gate decides inside it (last_accepted)."""
    ba = _Ba(None)
    meta = dict(order=[1, 2, 3], P=3, L=1, n_obs=4)
    tok = ls.before(APPLY, (ba, _Fl(), np.full(2, value), meta), {})
    ba.last_accepted = accepted
    ls.after(APPLY, tok, None)


def test_listener_keeps_solves_after_an_armed_read(plugin):
    """Every solve staged after an armed read is kept until one that the
    program's gate accepts lands, even after the last sampled read,
    with the digest of the frames its window slots held when it was
    staged."""
    ls = plugin.Listener()
    _stage(ls, 1)  # staged before any armed read
    _apply(ls, 1, True)
    ls.arm()
    _stage(ls, 2)  # the first solve after the armed read: rejected
    _apply(ls, 2, False)
    _stage(ls, 3)  # kept as well, and accepted
    ls.arm()  # armed again before it lands
    _apply(ls, 3, True)
    _stage(ls, 4)  # the first solve after the second armed read
    _apply(ls, 4, True)
    _stage(ls, 5)  # no read armed since an accepted solve landed
    _apply(ls, 5, False)
    ls.arm()
    _stage(ls, 6)  # lands only after the last sampled read
    _apply(ls, 6, True)
    kept = ls.take()
    assert [int(k["buf"][0]) for k in kept] == [2, 3, 4, 6]
    assert [float(k["flat"][0]) for k in kept] == [2.0, 3.0, 4.0, 6.0]
    for k in kept:
        v = int(k["buf"][0])
        assert torch.equal(k["digest"], plugin.digest(
            _Fl._stack.img_pad[[v, v + 1]]))
    assert kept[0]["order"] == [1, 2, 3] and kept[0]["pad"] == 5
    assert "ba" not in kept[0]
    assert ls.take() == []


def test_plugin_only_where_its_numbers_are_named(paths, plugin,
                                                 monkeypatch):
    # Long enough on a slow CPU that a solve staged after a sampled read
    # lands before the window's last read.
    seen = _spied_run(paths, monkeypatch, seconds=20.0)
    r = cell.run("tiny.euroc_wvga.ba", 2 ** 31 + 23, 0, False, 0.0,
                 control=True)
    b = cell.run("tiny.tum_vga.batched", 2 ** 31 + 23, 0, False, 0.0)
    ba_points, plain_points = (i["points"] for i in seen["installs"])
    assert {PACK, STAGE, APPLY} <= ba_points
    assert not {PACK, STAGE, APPLY} & plain_points
    assert not set(plugin.NUMBERS) & set(b["checks"])
    values = r["_extra"]["values"]
    for name in plugin.NUMBERS:
        assert math.isfinite(values[name]), name
        assert name + ".control" in values
        assert r["checks"][name]["value"] == values[name]
    assert r["correct"], r["checks"]


def _ring():
    """Sixteen frames in batches of 8, a poseframe every 4th; each
    batch's last update runs BA: an apply, then a stage that solves
    (the first batch) or builds too small a window (the second)."""
    tr = stats.StatsTracker()
    for f in range(16):
        with tr.span("update", frames=(f,), poseframe=f % 4 == 0):
            if f % 8 == 7:
                with tr.span("ba"):
                    with tr.span("ba_apply"):
                        pass
                    with tr.span("ba_stage"):
                        if f == 7:
                            with tr.timed("ba_solve"):
                                pass
    return tr.spans


def _read(paths, name, ctx):
    return registry.metric_reader(name, paths["bench_dir"]).read(ctx)


def test_ba_readers_on_a_recorded_ring(paths, monkeypatch):
    ring = _ring()
    monkeypatch.setattr(stats, "latest", lambda: ring)
    ctx = cell.Context(frames=16, reads=2, stages={"ba_solve": [1.0, 3.0]},
                       trace=None, rooflines={})
    assert _read(paths, "ba_solve.ms_per_solve", ctx) == 2.0
    spans = ring.spans()
    host = sum(s.ms for s in spans if s.name in ("ba_stage", "ba_apply"))
    assert _read(paths, "ba.host_ms_per_frame", ctx) == \
        pytest.approx(host / 16)
    assert _read(paths, "ba.solves_per_poseframe", ctx) == 1 / 4
    # No solve block, an empty ring, a program without a ring: None.
    ctx.stages = {}
    assert _read(paths, "ba_solve.ms_per_solve", ctx) is None
    monkeypatch.setattr(stats, "latest", lambda: stats.SpanRing(8))
    for name in ("ba.host_ms_per_frame", "ba.solves_per_poseframe"):
        assert _read(paths, name, ctx) is None
    monkeypatch.delattr(stats, "latest")
    for name in ("ba.host_ms_per_frame", "ba.solves_per_poseframe"):
        assert _read(paths, name, ctx) is None
