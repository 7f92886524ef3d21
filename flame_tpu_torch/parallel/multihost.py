"""The multi-process runtime over torch.distributed.

Counterpart of flame_tpu/parallel/multihost.py. Every process runs the
same program: initialize() once at startup joins the process group
(NCCL on the card, gloo on the CPU); global_mesh() is then the mesh with
one partition per rank, over which sharding.sharded_smooth and
distributed_ba.solve_window_sharded run unchanged, their psums becoming
all-reduces over the group. Nothing on a machine tells a program of its
cluster, so the coordinator's address, the number of processes and this
process's rank are given, and a failed initialization raises: there is
no single-process fallback.
"""

from typing import Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from flame_tpu_torch.parallel.sharding import AXIS, Mesh


def initialize(coordinator_address: str, num_processes: int,
               process_id: int, backend: Optional[str] = None) -> None:
    """Join the process group at tcp://coordinator_address ("host:port")
    as rank process_id of num_processes. backend None: "nccl" where CUDA
    is present, else "gloo"; with NCCL this process first takes card
    process_id modulo the cards present."""
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    if backend == "nccl":
        torch.cuda.set_device(process_id % torch.cuda.device_count())
    dist.init_process_group(
        backend, init_method=f"tcp://{coordinator_address}",
        world_size=num_processes, rank=process_id)


def _device() -> torch.device:
    if dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def global_mesh(axis: str = AXIS) -> Mesh:
    """The 1-D mesh over every process of the group, one partition each,
    in rank order."""
    return Mesh((_device(),), axis, group=dist.group.WORLD)


def grid_mesh(shape: Sequence[int], axes: Sequence[str]):
    """An N-D torch.distributed DeviceMesh over all ranks, laid out as
    np.arange(world).reshape(shape) (e.g. (hosts, cards per host))."""
    from torch.distributed.device_mesh import DeviceMesh
    ranks = np.arange(dist.get_world_size()).reshape(tuple(shape))
    return DeviceMesh(_device().type, ranks.tolist(),
                      mesh_dim_names=tuple(axes))


def is_coordinator() -> bool:
    return dist.get_rank() == 0
