"""The multi-process runtime over torch.distributed.

Counterpart of flame_tpu/parallel/multihost.py. Every process runs the
same program: initialize() once at startup joins the process group
(NCCL on the card, gloo on the CPU); global_mesh() is then the mesh with
one partition per rank, over which sharding.sharded_smooth,
distributed_ba.solve_window_sharded, the halo smoothers,
sharding.sharded_update_step and orchestrator.ShardedFlame run, their
psums becoming all-reduces and their halo strips point-to-point messages
over the group. Nothing on a machine tells a program of its cluster, so
the coordinator's address, the number of processes and this process's
rank are given, and a failed initialization raises: there is no
single-process fallback.

NCCL refuses two ranks on one card, so several ranks that share a card
join a gloo group and take global_mesh(device="cuda"): their compute
stays on the card and their collectives move through host tensors
(sharding.Mesh.staged). shutdown() frees the halo kernel's peer buffers
and leaves the group.
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


def _device(device=None) -> torch.device:
    """The mesh's device: the backend's own (NCCL: this process's card;
    gloo: the CPU) unless given. NCCL carries card tensors only; gloo
    carries the CPU's, and a card's through host copies."""
    backend = dist.get_backend()
    if device is None:
        if backend == "nccl":
            return torch.device("cuda", torch.cuda.current_device())
        return torch.device("cpu")
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    if dev.type not in ("cpu", "cuda") or (backend == "nccl"
                                          and dev.type != "cuda"):
        raise ValueError(f"a {backend} group cannot carry tensors on {dev}")
    return dev


def global_mesh(axis: str = AXIS, device=None) -> Mesh:
    """The 1-D mesh over every process of the group, one partition each,
    in rank order, on device (by default the backend's own, see
    _device)."""
    return Mesh((_device(device),), axis, group=dist.group.WORLD)


def grid_mesh(shape: Sequence[int], axes: Sequence[str]):
    """An N-D torch.distributed DeviceMesh over all ranks, laid out as
    np.arange(world).reshape(shape) (e.g. (hosts, cards per host))."""
    from torch.distributed.device_mesh import DeviceMesh
    ranks = np.arange(dist.get_world_size()).reshape(tuple(shape))
    return DeviceMesh(_device().type, ranks.tolist(),
                      mesh_dim_names=tuple(axes))


def is_coordinator() -> bool:
    return dist.get_rank() == 0


def shutdown() -> None:
    """Free the halo kernel's peer buffers of the group (each rank closes
    its neighbours' handles before any rank frees its own) and destroy
    the process group."""
    from flame_tpu_torch.parallel import halo_kernel
    halo_kernel.release_peer_buffers(dist.group.WORLD)
    dist.destroy_process_group()
