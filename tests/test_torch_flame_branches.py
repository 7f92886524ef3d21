"""detection.continuous and solver.fetch_stride at the Flame level: the
port's per-update host counters against the JAX package's on the CPU.

Both packages run the tests/test_flame_e2e.py scene (160x120, 512
features, a poseframe every second frame) from the same Params; the
asynchronous runs use solver.deterministic=True, so that every snapshot
and triangulation is joined at once and both follow one schedule. After
each update the test records, in each package:

- the number of detection passes the update ran (the feature-id counter
  advances by one detection's cell count per pass, bootstrap included),
  the live feature count of the host mirror and update()'s boolean;
- the packed transfers it staged (constructions of core.flame's
  _AsyncFetch) and the triangulations it adopted (_adopt_tri_result
  calls that took the pending one).

Held: the booleans, the detection passes, the staged transfers and the
adoptions equal per update; the live feature count within 3% (jitted JAX
tracking keeps or kills a few features that eager JAX and the port
decide the other way, ROADMAP's known traps: 2-3 of 84-141 here). Cases:
detection.continuous=False on the synchronous path and on the batched
path (frame_batch=4), where no detection may follow the first update
that meshed; solver.fetch_stride=2 on the single-frame and on the
batched async path, where a transfer is staged on every second update or
dispatch only. A last case holds the shed policy's default join age
(topology_lag * fetch_stride) to the JAX package's.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import flame_tpu.core.flame as jflame_mod  # noqa: E402
import flame_tpu_torch  # noqa: E402
import flame_tpu_torch.core.flame as tflame_mod  # noqa: E402
from flame_tpu.geometry import camera as jcam  # noqa: E402
from flame_tpu.params import (DetectionParams, Params,  # noqa: E402
                              SolverParams)
from flame_tpu_torch import convert  # noqa: E402
from test_flame_e2e import FX, H, W, render  # noqa: E402
from test_shed_policy import FakeFetch  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this module's small CPU tensors: the test
    workers run side by side, and more threads only oversubscribe the
    cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


CASES = {
    # name: (detection kw, solver kw, frames)
    "continuous_off_sync": (dict(continuous=False), {}, 10),
    "continuous_off_batched": (dict(continuous=False), dict(
        async_topology=True, frame_batch=4, deterministic=True), 14),
    "stride2_single": ({}, dict(async_topology=True, fetch_stride=2,
                                deterministic=True), 12),
    "stride2_batched": ({}, dict(async_topology=True, frame_batch=4,
                                 fetch_stride=2, deterministic=True), 22),
}


def make_params(det_kw=None, solver_kw=None):
    return Params(
        feature_capacity=512, edge_capacity=2048, triangle_capacity=1024,
        poseframe_capacity=8, min_height=-100.0, max_height=100.0,
        idepth_init=0.05, idepth_var_init=0.25, photo_error_num_pfs=0,
        detection=DetectionParams(win_size=16, **(det_kw or {})),
        solver=SolverParams(n_iters_per_frame=30, max_vertex_degree=16,
                            **(solver_kw or {})),
        debug_quiet=True)


def _instrument(fl, mod, log):
    """Count fl's staged transfers (constructions of mod._AsyncFetch) and
    adopted triangulations into log["staged"] / log["adopted"]."""
    adopt = fl._adopt_tri_result

    def counted_adopt(force):
        before = fl._tri_pending
        adopt(force)
        if before is not None and fl._tri_pending is None:
            log["adopted"] += 1
    fl._adopt_tri_result = counted_adopt

    class Counted(mod._AsyncFetch):
        def __init__(self, *a, **kw):
            log["staged"] += 1
            super().__init__(*a, **kw)
    return Counted


def _run(case):
    det_kw, solver_kw, n_frames = CASES[case]
    jp = make_params(det_kw, solver_kw)
    K = jcam.make_k(FX, FX, W / 2, H / 2)
    Kinv = jcam.inv_k(K)
    jf = jflame_mod.Flame(W, H, K, Kinv, jp)
    tf = flame_tpu_torch.Flame(W, H, np.array(K), np.array(Kinv),
                               convert.params_from_dict(
                                   dataclasses.asdict(jp)), device="cpu")
    per_update = {}
    with pytest.MonkeyPatch.context() as mp:
        for name, fl, mod in (("jax", jf, jflame_mod),
                              ("torch", tf, tflame_mod)):
            log = dict(staged=0, adopted=0)
            mp.setattr(mod, "_AsyncFetch", _instrument(fl, mod, log))
            rows = []
            for i in range(n_frames):
                q = np.array([1.0, 0, 0, 0], np.float32)
                t = np.array([0.15 * i, 0, 0], np.float32)
                img = render(0.15 * i).astype(np.uint8)
                pose = ((jnp.asarray(q), jnp.asarray(t)) if name == "jax"
                        else (q, t))
                ids0, staged0, adopted0 = (fl._feat_id_counter,
                                           log["staged"], log["adopted"])
                ok = fl.update(i * 0.1, i, pose, img, i % 2 == 0)
                rows.append(dict(
                    ok=bool(ok),
                    detections=(fl._feat_id_counter - ids0) // fl._add_cap,
                    staged=log["staged"] - staged0,
                    adopted=log["adopted"] - adopted0,
                    n_valid=int(fl._n_valid)))
            per_update[name] = rows
    return per_update


@pytest.fixture(scope="module", params=list(CASES))
def runs(request):
    return request.param, _run(request.param)


def test_host_counters_match_jax(runs):
    case, per_update = runs
    j, t = per_update["jax"], per_update["torch"]
    for key in ("ok", "detections", "staged", "adopted"):
        assert [r[key] for r in t] == [r[key] for r in j], key
    for i, (a, b) in enumerate(zip(j, t)):
        assert abs(a["n_valid"] - b["n_valid"]) <= 0.03 * max(
            a["n_valid"], 1), (i, a, b)
    assert sum(r["ok"] for r in t) >= 3  # the runs mesh
    if case.startswith("continuous_off"):
        # Detection runs up to the first update that meshes, never after.
        first = next(i for i, r in enumerate(t) if r["ok"])
        assert sum(r["detections"] for r in t[:first + 1]) >= 1
        assert all(r["detections"] == 0 for r in t[first + 1:])
    else:
        # A transfer on every second update or batched step only: fewer
        # staged than the updates (steps) that could stage one.
        assert 1 <= sum(r["staged"] for r in t) < sum(r["ok"] for r in t)
        assert sum(r["adopted"] for r in t) >= 1


@pytest.mark.parametrize("age, shed", [(3, False), (4, True)])
def test_default_join_age_is_lag_times_stride(age, shed):
    """join_age=0 means topology_lag * fetch_stride (2 * 2 here): a head
    younger than that is left in flight, one that old is shed, in both
    packages."""
    jp = make_params(solver_kw=dict(async_topology=True, fetch_stride=2,
                                    topology_lag=2, join_age=0))
    K = jcam.make_k(FX, FX, W / 2, H / 2)
    Kinv = jcam.inv_k(K)
    flames = (jflame_mod.Flame(W, H, K, Kinv, jp),
              flame_tpu_torch.Flame(W, H, np.array(K), np.array(Kinv),
                                    convert.params_from_dict(
                                        dataclasses.asdict(jp)),
                                    device="cpu"))
    for fl in flames:
        pk = FakeFetch(ready=False)
        fl._packed_queue.append((pk, 10, ([10], [True]), [None]))
        fl.num_imgs = 10 + age
        assert fl._drain_packed_queue()
        assert len(fl._packed_queue) == (0 if shed else 1)
        assert fl.stats.stats("packed_sheds") == (1 if shed else 0)
        assert not pk.joined
