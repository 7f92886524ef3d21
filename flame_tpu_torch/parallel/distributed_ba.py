"""Windowed BA with the normal-equation assembly sharded over observations.

Counterpart of flame_tpu/parallel/distributed_ba.py. The Schur assembly
(ba/schur.py) is sums over observations, so it splits as data
parallelism: each partition assembles (Hpp, bp, Hll, bl, W, cost) from
its contiguous block of observation rows, one psum per output combines
the blocks (parallel/sharding.psum: a sum over the partitions of one
card, then an all-reduce over the mesh's process group, if any), and the
small reduced solve runs the same on every partition, through the one
Gauss-Newton loop the single solve uses (schur.gn_solve).

While a graph runner is current (flame_tpu_torch/step_graph.py; on the
card BundleAdjuster makes the stack's current), each window shape
replays one CUDA graph of kind "ba_sharded": op by op a solve is some
thousands of small launches. Otherwise, and over a process group (the
all-reduces are NCCL's, or gloo's), the solve runs eagerly.
"""

import torch

from flame_tpu_torch import step_graph
from flame_tpu_torch.ba import residuals as resid
from flame_tpu_torch.ba import schur
from flame_tpu_torch.params import BAParams
from flame_tpu_torch.parallel.sharding import Mesh, psum


def _obs_rows(obs: resid.BAObservations, sl: slice) -> resid.BAObservations:
    return resid.BAObservations(*(a[sl] for a in obs))


def _solve(params: BAParams, n_fixed: int, mesh: Mesh, K, Kinv,
           problem: schur.BAProblem, sqrtW: torch.Tensor):
    """The sharded Gauss-Newton solve on materialized inputs: M rows
    divide into the partitions, the priors and sqrtW are given."""
    P = problem.q.shape[0]
    L = problem.lm_idepth.shape[0]
    Mb = problem.obs.u_ref.shape[0] // mesh.size
    blocks = [slice(b * Mb, (b + 1) * Mb) for b in range(
        mesh.first_block, mesh.first_block + mesh.n_local)]

    def assemble(q, t, lm):
        parts = [schur._assemble(K, Kinv, q, t, lm,
                                 _obs_rows(problem.obs, sl),
                                 params.huber_delta, P, L, sqrtW=sqrtW[sl])
                 for sl in blocks]
        return tuple(psum(outs, mesh) for outs in zip(*parts))
    return schur.gn_solve(params, problem, n_fixed, problem.lm_valid,
                          assemble)


def _materialize(problem: schur.BAProblem, n: int, sqrtW):
    """Observation rows padded (valid=False) to a multiple of n, sqrtW the
    identity where none is given, the priors set."""
    obs = problem.obs
    M = obs.u_ref.shape[0]
    pad = (-M) % n
    if pad:
        def padded(a):
            return torch.cat([a, a.new_zeros((pad,) + a.shape[1:])])
        obs = resid.BAObservations(*(padded(a) for a in obs))
        if sqrtW is not None:
            sqrtW = padded(sqrtW)
    if sqrtW is None:
        sqrtW = torch.eye(2, device=obs.u_ref.device).expand(M + pad, 2, 2)
    return problem._replace(
        obs=obs,
        prior_q=problem.prior_q if problem.prior_q is not None
        else problem.q,
        prior_t=problem.prior_t if problem.prior_t is not None
        else problem.t), sqrtW.contiguous()


def solve_window_sharded(params: BAParams, K, Kinv,
                         problem: schur.BAProblem, mesh: Mesh,
                         n_fixed: int = 2, sqrtW=None):
    """schur.solve_window with the assembly sharded over the mesh.

    Observation rows are padded (valid=False) to a multiple of the mesh
    size; sqrtW ((M, 2, 2) whitening, rematch.observation_weights) is
    split with them and is the identity where none is given. The same
    function as the single solve up to the order of the float sums.
    Returns (q', t', lm_idepth', final_cost)."""
    problem, sqrtW = _materialize(problem, mesh.size, sqrtW)
    if problem.q.device != mesh.device:
        raise ValueError(f"solve_window_sharded: window on "
                         f"{problem.q.device}, mesh on {mesh.device}")
    steps = step_graph.current()
    if mesh.group is not None or steps is None:
        return _solve(params, n_fixed, mesh, K, Kinv, problem, sqrtW)

    def body(ins, scalars):
        q, t, lm, lm_valid, a, o, l, u_ref, u_obs, valid, pq, pt, sw = ins
        return _solve(params, n_fixed, mesh, K, Kinv, schur.BAProblem(
            q, t, lm, lm_valid,
            resid.BAObservations(a, o, l, u_ref, u_obs, valid), pq, pt), sw)
    flat = [problem.q, problem.t, problem.lm_idepth, problem.lm_valid,
            *problem.obs, problem.prior_q, problem.prior_t, sqrtW]
    return steps.run("ba_sharded", body, flat, (), params, (K, Kinv),
                     static=(n_fixed, mesh))
