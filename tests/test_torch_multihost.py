"""flame_tpu_torch.parallel.multihost over real processes.

The counterpart of tests/test_multihost.py and, over a process group, of
tests/test_sharded_e2e.py: CPU processes join a gloo group at a local TCP
address (multihost.initialize) and run tests/torch_multihost_worker.py's
checks on global_mesh() (one partition per rank):

  * two ranks: a psum, the edge-sharded smoother and the observation-
    sharded BA solve across the process boundary, a grid DeviceMesh; the
    plain "halo" smoother and K3's plain version over the group, and
    sharded_update_step holding only the rank's block, each bit-equal to
    make_mesh(2) in one process; a checkpoint round trip of a group
    ShardedFlame (blocks back on their ranks, the resumed run equal to
    the continued one);
  * two ranks, ShardedFlame on test_sharded_e2e.py's scene (160x120, 14
    frames): "vertex" (512 features), "halo" and "pallas_halo" (1024),
    each rank holding capacity / 2 rows of the feature and graph state,
    the map bit-equal (max |d| <= 1e-6, equal NaN masks) to ShardedFlame
    on make_mesh(2) and within that file's bounds (coverage > 0.5,
    median relative error < 0.02); do_ba with test_sharded_ba_e2e's
    Params (max_obs=1001, aniso weights) to its assertions; and the
    asynchronous path, whose ranks agree on every timing decision;
  * two ranks, the batched step (pipeline.batch_step with K2b's plain
    version: frame_batch=4, async topology, deterministic, uint8 frames,
    16 frames): "vertex", and "pallas_halo" with bench.py's comparison-
    poseframe scoring and eviction (4 poseframe slots), each bit-equal
    to make_mesh(2) with the same poseframe slots on every rank;
    tests/test_torch_checkpoint.py's batched BA configuration, every
    solve sharded, the poseframes within 0.02 m of the truth (ATE too)
    and the map equal to make_mesh(2)'s; automatic poseframes, every
    rank declaring make_mesh(2)'s frames; a save mid-batch whose resumed
    run equals the continued one;
  * four ranks: a psum, both plain halo smoothers and the "pallas_halo"
    ShardedFlame (1024 features: 8 rank rows, 2 per rank = the reach),
    single-frame and batched.

Each check, the group's start-up and its shutdown have their own 120 s
limit on every rank (_launch), and each worker destroys its group; the
pytest process initializes none. The other tolerances: the edge-sharded
smoother within 1e-5 of nltgv2.smooth after 10 iterations, the sharded
BA within 1e-4 of schur.solve_window on t, q and lm and within 1e-2
relative on the cost (tests/test_multihost.py's).

In the pytest process, test_group_map_matches_jax and
test_group_batch_map_matches_jax hold the group runs' "vertex" maps to
the JAX package's ShardedFlame on as many virtual CPU devices
(tests/conftest.py) with the same Params and frames: both within
test_sharded_e2e's bounds, covering the same pixels (IoU >= 0.95)
with median relative |d idepth| <= 1e-2 (tests/test_torch_flame_e2e.py's
whole-run bound: accept/reject decisions flip on float noise, so whole
runs are held to bounds, not bits). Stage by stage,
test_group_step_matches_eager_jax holds the group's sharded_update_step
on tests/test_torch_sharding.py's dry-run state to eager JAX tracking
(rtol 1e-2 on idepths and variances, 0.02 px, decisions exactly: that
file's tolerances) and to JAX's sharded step's graph on 2 virtual
devices (atol 1e-5).
"""

import os
import socket
import subprocess
import sys
import threading
import time

import numpy as np
import pytest

pytest.importorskip("torch")

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

CHECK_TIMEOUT_S = 120
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "tests", "torch_multihost_worker.py")
CHECKS = ("psum", "smooth", "ba", "grid", "halo", "kernel", "step",
          "checkpoint", "stage")
FLAME_CHECKS = ("flame_vertex", "flame_halo", "flame_pallas_halo",
                "flame_ba", "flame_async")
BATCH_CHECKS = ("flame_batch_vertex", "flame_batch_pallas_halo",
                "flame_batch_ba", "flame_batch_auto", "checkpoint_batch")
FOUR_CHECKS = ("psum", "halo", "kernel", "flame_pallas_halo",
               "flame_batch_pallas_halo")
BATCH_FRAMES = 16


def _launch(out_dir, n, checks):
    """Exit codes and output of n workers running checks. Each worker
    prints "proc <rank> <check> START" and "... OK" around each check;
    the group's start-up, each check and the shutdown after the last
    one have their own CHECK_TIMEOUT_S on every rank, and a rank that
    runs past it ends the launch with a line naming the check."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    procs, logs, marks = [], [], []
    for pid in range(n):
        env = dict(os.environ, COORD=f"127.0.0.1:{port}", PID_IDX=str(pid),
                   NPROC=str(n), CHECKS=",".join(checks),
                   OUT_DIR=str(out_dir), FLAME_REPO=REPO,
                   MASTER_ADDR="127.0.0.1", CUDA_VISIBLE_DEVICES="")
        procs.append(subprocess.Popen(
            [sys.executable, WORKER], env=env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT))
        logs.append([])
        marks.append(["start-up", time.monotonic()])
    readers = [threading.Thread(target=_read_marks, args=(p, log, mark))
               for p, log, mark in zip(procs, logs, marks)]
    for r in readers:
        r.start()
    late = None
    while late is None and any(p.poll() is None for p in procs):
        now = time.monotonic()
        late = next((pid for pid, p in enumerate(procs) if p.poll() is None
                     and now - marks[pid][1] > CHECK_TIMEOUT_S), None)
        time.sleep(0.1)
    if late is not None:
        for p in procs:
            p.kill()
        logs[late].append(f"proc {late}: {marks[late][0]} ran past its "
                          f"{CHECK_TIMEOUT_S} s limit\n")
    outs = []
    for p, r, log in zip(procs, readers, logs):
        p.wait()
        r.join()
        outs.append((p.returncode, "".join(log)))
    return outs


def _read_marks(proc, log, mark):
    """Collect a worker's output; mark: [what it runs, since when], moved
    on at each check's START and OK line."""
    for raw in proc.stdout:
        line = raw.decode(errors="replace")
        log.append(line)
        words = line.split()
        if len(words) == 4 and words[0] == "proc" \
                and words[3] in ("START", "OK"):
            mark[:] = [words[2] if words[3] == "START"
                       else f"the shutdown after {words[2]}",
                       time.monotonic()]


@pytest.fixture(scope="module")
def maps_dir(tmp_path_factory):
    return tmp_path_factory.mktemp("multihost_maps")


@pytest.fixture(scope="module")
def dryrun(maps_dir):
    """tests/test_torch_sharding.py's dry-run state in both packages; the
    port's side written for the workers' "stage" check."""
    import torch
    from test_torch_sharding import dryrun_state
    d = dryrun_state()
    torch.save({k: d[k] for k in ("targs", "trcm", "tp")},
               maps_dir / "stage_in.pt")
    return d


@pytest.fixture(scope="module")
def outputs(maps_dir, dryrun):
    return _launch(maps_dir, 2, CHECKS)


@pytest.fixture(scope="module")
def flame_outputs(maps_dir):
    return _launch(maps_dir, 2, FLAME_CHECKS)


@pytest.fixture(scope="module")
def batch_outputs(maps_dir):
    return _launch(maps_dir, 2, BATCH_CHECKS)


@pytest.fixture(scope="module")
def four_outputs(maps_dir):
    return _launch(maps_dir, 4, FOUR_CHECKS)


def _finished(outs):
    for pid, (rc, out) in enumerate(outs):
        assert rc == 0, f"proc {pid} failed:\n{out}"
        assert f"proc {pid} OK" in out, out


def _passed(outs, check):
    for pid, (_, out) in enumerate(outs):
        assert f"proc {pid} {check} OK" in out, out


def test_workers_finish(outputs):
    _finished(outputs)


@pytest.mark.parametrize("check", CHECKS)
def test_across_processes(outputs, check):
    _passed(outputs, check)


def test_flame_workers_finish(flame_outputs):
    _finished(flame_outputs)


@pytest.mark.parametrize("check", FLAME_CHECKS)
def test_sharded_flame_across_processes(flame_outputs, check):
    _passed(flame_outputs, check)


def test_batch_workers_finish(batch_outputs):
    _finished(batch_outputs)


@pytest.mark.parametrize("check", BATCH_CHECKS)
def test_batched_step_across_processes(batch_outputs, check):
    _passed(batch_outputs, check)


def test_four_workers_finish(four_outputs):
    _finished(four_outputs)


@pytest.mark.parametrize("check", FOUR_CHECKS)
def test_across_four_processes(four_outputs, check):
    _passed(four_outputs, check)


@pytest.mark.parametrize("smoother", ["edge", "halo", "pallas_halo"])
def test_group_step_matches_eager_jax(outputs, maps_dir, dryrun, smoother):
    """The group's sharded_update_step, stage by stage: its tracking
    (gathered from the two ranks' blocks) against eager JAX
    track_project_sync (ROADMAP's known trap: jitted JAX rounds
    otherwise) to test_torch_sharding.py's tolerances, its smoothed graph
    against JAX's sharded_update_step on 2 virtual devices at atol 1e-5."""
    import jax
    import torch
    from flame_tpu.core import pipeline as jpipe
    from flame_tpu.parallel import sharding as jsh
    from test_torch_sharding import TRACK_PX, TRACK_RTOL, _assert_fields
    feats2, curr, member, graph2, stats = torch.load(
        maps_dir / "stage_out.pt", weights_only=False)[smoother]
    K, Kinv, stack, feats, fnew, slot, graph = dryrun["jargs"]
    with jax.disable_jit():
        jfe, jcu, jmem, jst, _ = jpipe.track_project_sync(
            dryrun["jp"], K, Kinv, stack, feats, fnew, slot)
    v = np.asarray(jfe.valid)
    assert v.sum() > 10
    for name in ("valid", "pf_slot", "num_updates", "search_status", "xy"):
        np.testing.assert_array_equal(getattr(feats2, name).numpy(),
                                      np.asarray(getattr(jfe, name)))
    np.testing.assert_array_equal(member.numpy(), np.asarray(jmem))
    np.testing.assert_array_equal(stats.numpy(), np.asarray(jst))
    for got, want in ((feats2.idepth_mu, jfe.idepth_mu),
                      (feats2.idepth_var, jfe.idepth_var),
                      (curr.idepth, jcu.idepth), (curr.var, jcu.var)):
        np.testing.assert_allclose(got.numpy()[v], np.asarray(want)[v],
                                   rtol=TRACK_RTOL)
    np.testing.assert_allclose(curr.xy.numpy()[v], np.asarray(jcu.xy)[v],
                               atol=TRACK_PX)
    jstep = jsh.sharded_update_step(dryrun["jp"], jsh.make_mesh(
        jax.devices()[:2]), smoother=smoother)
    jout = jstep(*dryrun["jargs"],
                 *(dryrun["jrcm"] if smoother != "edge" else ()))
    _assert_fields(graph2, jout[3], 1e-5)


def _jax_sharded_map(smoother, n, batched=False):
    """The JAX package's ShardedFlame on n virtual devices, with
    test_sharded_e2e.py's Params for the mode, on its 14 frames; batched:
    with the worker's batch_params (frame_batch=4, async topology,
    deterministic) on its 16 uint8 frames."""
    import jax
    import jax.numpy as jnp

    from flame_tpu.geometry import camera, se3
    from flame_tpu.params import DetectionParams, Params, SolverParams
    from flame_tpu.parallel import sharding
    from flame_tpu.parallel.orchestrator import ShardedFlame
    from test_sharded_e2e import FX, H, W, render
    big = smoother != "vertex"
    solver = dict(n_iters_per_frame=30, max_vertex_degree=16,
                  smoother=smoother)
    if batched:
        solver.update(frame_batch=4, async_topology=True, deterministic=True)
    params = Params(
        feature_capacity=1024 if big else 512,
        edge_capacity=4096 if big else 2048,
        triangle_capacity=2048 if big else 1024, poseframe_capacity=8,
        min_height=-100.0, max_height=100.0, idepth_init=0.05,
        idepth_var_init=0.25, detection=DetectionParams(win_size=16),
        solver=SolverParams(**solver), debug_quiet=True)
    K = camera.make_k(FX, FX, W / 2, H / 2)
    fl = ShardedFlame(W, H, K, camera.inv_k(K), params,
                      mesh=sharding.make_mesh(jax.devices()[:n]))
    for i in range(BATCH_FRAMES if batched else 14):
        cam_x = 0.15 * i
        img = render(cam_x)
        if batched:
            img = np.clip(img, 0, 255).astype(np.uint8)
        fl.update(i * 0.1, i, (se3.quat_identity(),
                               jnp.array([cam_x, 0.0, 0.0])),
                  img, i % 2 == 0)
    assert len(fl._feats.idepth_mu.sharding.device_set) == n
    assert fl._dispatches >= (2 if batched else 0)
    return fl.get_inverse_depth_map()


def _assert_matches_jax(port, ref):
    for idm in (port, ref):
        cov = np.mean(~np.isnan(idm))
        assert cov > 0.5, cov
        err = np.abs(idm[~np.isnan(idm)] - 0.2) * 5.0
        assert np.median(err) < 0.02, np.median(err)
    ca, cb = ~np.isnan(port), ~np.isnan(ref)
    assert (ca & cb).sum() / (ca | cb).sum() >= 0.95
    both = ca & cb
    assert np.median(np.abs(port[both] - ref[both]) / np.abs(ref[both])) \
        <= 1e-2


@pytest.mark.parametrize("smoother,n", [("vertex", 2)])
def test_group_map_matches_jax(flame_outputs, maps_dir, smoother, n):
    path = maps_dir / f"{smoother}_{n}.npy"
    assert path.exists(), flame_outputs
    _assert_matches_jax(np.load(path), _jax_sharded_map(smoother, n))


def test_group_batch_map_matches_jax(batch_outputs, maps_dir):
    """The two-rank batched run (frame_batch=4, "vertex") against the
    JAX package's ShardedFlame on 2 virtual devices with the same Params
    and frames, at the whole-run bounds."""
    path = maps_dir / "batch_vertex_2.npy"
    assert path.exists(), batch_outputs
    _assert_matches_jax(np.load(path),
                        _jax_sharded_map("vertex", 2, batched=True))
