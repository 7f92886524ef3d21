"""ShardedFlame: the whole Flame pipeline over a partition mesh.

Counterpart of flame_tpu/parallel/orchestrator.py. Every update() runs
the Flame pipeline; the smoother of each post-Delaunay step is
partitioned over the mesh: smoother="pallas_halo" runs the halo kernel
K3 (parallel/halo_kernel.py) with a thread-block cluster per partition,
"halo" the plain partitioned smoother (parallel/halo.py). "auto" and
"pallas" become "vertex", as in the JAX package ("pallas" with a
warning). With do_ba, every bundle adjustment solve takes the
observation-sharded assembly over the mesh (parallel/distributed_ba.py)
and applies at once, as the JAX package routes it (_ba_mesh).

The mesh takes either form of parallel/sharding.py. On n partitions of
one card the pipeline state stays whole on that card. Over a process
group (multihost.global_mesh(), one rank per card, the form in which
several cards run) the state is placed as the JAX package's
NamedShardings place it (flame_tpu/parallel/orchestrator.py:100-113):
each rank holds only its block of the feature-indexed state (_feats,
_curr, _vtx_idepths, _vtx_normals) and of the graph's vertex- and
edge-indexed leaves, capacity / mesh.size rows of each; every rank holds
the frames, the poseframe stack, the dense maps and the triangles whole.
core/flame.py gathers the blocks where a stage reads the whole state,
the halo smoothers send their strips between ranks (K3 through CUDA IPC
peer buffers), and utils/checkpoint.py gathers on save and puts the
blocks back on load. Every rank runs the same update() calls, the
batched step (frame_batch > 1, pipeline.batch_step with K2b) included:
K2b draws the batch's maps whole on every rank, tracking runs on the
rank's block, and detection, the snapshot and the post-Delaunay section
read the gathered state.
"""

import dataclasses
import warnings
from typing import Optional

from flame_tpu_torch.core.flame import Flame
from flame_tpu_torch.optimize.smoother_kernel import LANES
from flame_tpu_torch.params import Params
from flame_tpu_torch.parallel.sharding import (Mesh, grouped, make_mesh,
                                               shard_rows)


class ShardedFlame(Flame):
    """Flame whose smoother runs over the partitions of `mesh` (by
    default one partition of `device`); over a process group, with the
    feature and graph state placed in blocks over the ranks."""

    def __init__(self, width: int, height: int, K, Kinv,
                 params: Optional[Params] = None,
                 mesh: Optional[Mesh] = None, *, device="cuda"):
        own = make_mesh(1, device)
        mesh = mesh if mesh is not None else own
        if mesh.device != own.device:
            raise ValueError(f"ShardedFlame: mesh on {mesh.device}, "
                             f"device {own.device}")
        self.mesh = mesh
        self._sharding_mesh = mesh
        self._ba_mesh = mesh  # BA through the observation-sharded assembly
        params = params or Params()
        n = mesh.size
        if params.feature_capacity % n or params.edge_capacity % n:
            raise ValueError("feature/edge capacity must divide into the "
                             f"mesh's {n} partitions")
        mode = params.solver.smoother
        if mode in ("auto", "pallas"):
            if mode == "pallas":
                warnings.warn(
                    "ShardedFlame: smoother='pallas' is the one-partition "
                    "banded kernel; using 'vertex' (for the partitioned "
                    "kernel use 'pallas_halo')", stacklevel=2)
            params = params.replace(solver=dataclasses.replace(
                params.solver, smoother="vertex"))
        if params.solver.smoother == "pallas_halo":
            rows = params.feature_capacity // LANES
            reach = params.solver.pallas_reach
            if params.feature_capacity % LANES or rows % n \
                    or rows // n < reach:
                raise ValueError(
                    f"pallas_halo needs rank rows (feature_capacity / "
                    f"{LANES} = {params.feature_capacity / LANES:g}) that "
                    f"divide into the mesh's {n} partitions with at least "
                    f"pallas_reach ({reach}) rows each; raise "
                    f"feature_capacity or use fewer partitions or a "
                    f"smaller reach")
        super().__init__(width, height, K, Kinv, params, device=mesh.device)

    def clear(self):
        """Flame.clear, then this rank's blocks of the feature and graph
        state over a process group."""
        super().clear()
        m = self.mesh
        if grouped(m):
            (self._feats, self._curr, self._graph, self._vtx_idepths,
             self._vtx_normals) = (shard_rows(a, m) for a in (
                self._feats, self._curr, self._graph, self._vtx_idepths,
                self._vtx_normals))
