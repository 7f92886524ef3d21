"""ShardedFlame: the whole Flame pipeline with a partitioned smoother.

Counterpart of flame_tpu/parallel/orchestrator.py. Every update() runs
the Flame pipeline; the smoother of each post-Delaunay step is
partitioned over the mesh: smoother="pallas_halo" runs the halo kernel
K3 (parallel/halo_kernel.py) with a thread-block cluster per partition,
"halo" the plain partitioned smoother (parallel/halo.py). "auto" and
"pallas" become "vertex", as in the JAX package ("pallas" with a
warning).

The port's mesh is n partitions of one card (parallel/sharding.py), so
the pipeline state stays on that card. The JAX package's NamedSharding
placement of the feature and graph state over the mesh belongs to a mesh
of several chips, and comes with the multi-card transport.
"""

import dataclasses
import warnings
from typing import Optional

from flame_tpu_torch.core.flame import Flame
from flame_tpu_torch.optimize.smoother_kernel import LANES
from flame_tpu_torch.params import Params
from flame_tpu_torch.parallel.sharding import Mesh, make_mesh


class ShardedFlame(Flame):
    """Flame whose smoother runs over the partitions of `mesh` (by
    default one partition of `device`)."""

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
        params = params or Params()
        if params.do_ba:
            raise NotImplementedError(
                "ShardedFlame with do_ba: the JAX package solves BA here "
                "with its observation-sharded psum assembly "
                "(parallel/distributed_ba.py), which comes with the "
                "multi-card transport (ROADMAP section 1 item 6.3)")
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
