"""flame_tpu_torch.parallel.multihost over two real processes.

The counterpart of tests/test_multihost.py: two CPU processes join a gloo
process group at a local TCP address (multihost.initialize) and, on
global_mesh() (one partition per rank), run a psum, the edge-sharded
smoother and the observation-sharded BA solve across the process
boundary, build a grid DeviceMesh, and check that ShardedFlame, the halo
smoothers and the sharded update step refuse a mesh over a group. Each
worker has its own 120 s limit and destroys its group; the pytest
process initializes none.

Tolerances: the sharded smoother within 1e-5 of the port's
nltgv2.smooth after 10 iterations, the sharded BA within 1e-4 of
schur.solve_window on t, q and lm and within 1e-2 relative on the cost
(tests/test_multihost.py's), as the partitions' sums are taken in
another order.
"""

import os
import socket
import subprocess
import sys

import pytest

pytest.importorskip("torch")

WORKER_TIMEOUT_S = 120
CHECKS = ("psum", "smooth", "ba", "grid", "refused")

_WORKER = r"""
import os, sys
sys.path.insert(0, os.environ["FLAME_REPO"])
import numpy as np
import torch
import torch.distributed as dist

from flame_tpu_torch.parallel import multihost

rank = int(os.environ["PID_IDX"])
multihost.initialize(os.environ["COORD"], 2, rank, backend="gloo")
try:
    from flame_tpu_torch import BAParams, Params, RegularizerParams
    from flame_tpu_torch.ba import schur, window
    from flame_tpu_torch.optimize import nltgv2
    from flame_tpu_torch.parallel import (distributed_ba, halo,
                                          halo_kernel, sharding)
    from flame_tpu_torch.parallel.orchestrator import ShardedFlame

    assert dist.get_world_size() == 2
    mesh = multihost.global_mesh()
    assert mesh.size == 2 and mesh.first_block == rank
    assert mesh.device == torch.device("cpu")
    assert multihost.is_coordinator() == (rank == 0)

    total = sharding.psum(torch.tensor([[float(rank + 1)]]), mesh)
    assert float(total) == 3.0, total
    print(f"proc {rank} psum OK", flush=True)

    # A 16-vertex ring in a (32, 64) graph, as tests/test_multihost.py.
    V, E, nv = 32, 64, 16
    rng = np.random.default_rng(0)
    edges = np.zeros((E, 2), np.int64)
    edges[:nv, 0] = np.arange(nv)
    edges[:nv, 1] = (np.arange(nv) + 1) % nv
    emask = np.arange(E) < nv
    vmask = np.arange(V) < nv
    f32 = lambda a: torch.as_tensor(np.asarray(a, np.float32))
    x = f32(rng.uniform(0.1, 0.3, V))
    g = nltgv2.empty(V, E, 4, "cpu").replace(
        pos=f32(rng.uniform(0, 50, (V, 2))), x=x, x_bar=x.clone(),
        data_term=torch.full((V,), 0.2), data_weight=f32(vmask),
        vtx_mask=torch.as_tensor(vmask), edges=torch.as_tensor(edges),
        alpha=f32(emask * 0.2), beta=f32(emask),
        edge_mask=torch.as_tensor(emask))
    p = RegularizerParams()
    g2 = sharding.sharded_smooth(p, g, 10, mesh)
    ref = nltgv2.smooth(p, g, 10)
    for name in ("x", "w1", "w2", "x_bar", "w1_bar", "w2_bar", "q1", "q2",
                 "q3"):
        torch.testing.assert_close(getattr(g2, name), getattr(ref, name),
                                   rtol=0, atol=1e-5, msg=name)
    assert sharding.LAST_TRAFFIC["n_devices"] == 2
    print(f"proc {rank} smooth OK", flush=True)

    # A window every process holds whole; 63 rows pad to the 2 ranks.
    Kn = np.array([[100.0, 0, 64], [0, 100.0, 48], [0, 0, 1]])
    P, L, M = 4, 12, 63
    buf = torch.as_tensor(window.well_posed_window(P, L, M, Kn, 5, (20, 100),
                                                   n_invalid=3))
    problem, _ = window._decode_packed(buf, P, L, M)
    K = torch.as_tensor(Kn, dtype=torch.float32)
    Kinv = torch.linalg.inv(K)
    bp = BAParams(n_gn_iters=3)
    got = distributed_ba.solve_window_sharded(bp, K, Kinv, problem, mesh)
    want = schur.solve_window(bp, K, Kinv, problem)
    for a, b in zip(got[:3], want[:3]):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-4)
    assert abs(float(got[3]) - float(want[3])) \
        <= 1e-2 * max(float(want[3]), 1.0)
    print(f"proc {rank} ba OK", flush=True)

    grid = multihost.grid_mesh((1, 2), ("hosts", "graph"))
    assert grid.mesh.tolist() == [[0, 1]], grid.mesh
    assert tuple(grid.mesh_dim_names) == ("hosts", "graph")
    print(f"proc {rank} grid OK", flush=True)

    gp = Params(feature_capacity=256, edge_capacity=512)
    perm = torch.arange(V)
    ranks = torch.zeros((E, 2), dtype=torch.int64)
    refusals = (
        lambda: ShardedFlame(64, 48, Kn, np.linalg.inv(Kn), gp, mesh=mesh,
                             device="cpu"),
        lambda: halo.halo_smooth(p, g, perm, perm, ranks, 1, 4, mesh),
        lambda: halo_kernel.smooth_sharded(p, g, perm, perm, ranks, 1, 4,
                                           mesh),
        lambda: sharding.sharded_update_step(gp, mesh))
    for call in refusals:
        try:
            call()
        except NotImplementedError as e:
            assert "6.1" in str(e), e
        else:
            raise AssertionError("a mesh over a process group was taken")
    print(f"proc {rank} refused OK", flush=True)
finally:
    dist.destroy_process_group()
print(f"proc {rank} OK", flush=True)
"""


@pytest.fixture(scope="module")
def outputs(tmp_path_factory):
    """Both workers' exit codes and output."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    script = tmp_path_factory.mktemp("multihost") / "worker.py"
    script.write_text(_WORKER)
    procs = []
    for pid in range(2):
        env = dict(os.environ, COORD=f"127.0.0.1:{port}", PID_IDX=str(pid),
                   FLAME_REPO=repo, MASTER_ADDR="127.0.0.1",
                   CUDA_VISIBLE_DEVICES="")
        procs.append(subprocess.Popen(
            [sys.executable, str(script)], env=env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT))
    outs = []
    for p in procs:
        try:
            out, _ = p.communicate(timeout=WORKER_TIMEOUT_S)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            out, _ = p.communicate()
        outs.append((p.returncode, out.decode()))
    return outs


def test_workers_finish(outputs):
    for pid, (rc, out) in enumerate(outputs):
        assert rc == 0, f"proc {pid} failed:\n{out}"
        assert f"proc {pid} OK" in out, out


@pytest.mark.parametrize("check", CHECKS)
def test_across_processes(outputs, check):
    for pid, (_, out) in enumerate(outputs):
        assert f"proc {pid} {check} OK" in out, out
