"""The partition mesh, the edge-sharded smoother and the sharded update step.

Counterpart of flame_tpu/parallel/sharding.py. The JAX package's mesh is
a row of chips; the port's Mesh takes one of two forms:

  * n partitions of one card (make_mesh): a partition is a block of rows
    along a leading tensor axis, and the JAX package's lax.psum over the
    mesh axis becomes a sum over that axis (psum). The halo kernel K3
    runs a thread-block cluster per partition (parallel/halo_kernel.py)
    and the plain "halo" smoother shifts strips along the partition axis
    (parallel/halo.py).
  * one partition per process of a torch.distributed group
    (parallel/multihost.global_mesh): psum sums the process's partition,
    then all-reduces over the group (NCCL on the card, gloo on the CPU).
    Every process holds the whole graph or window, as every JAX process
    does, and computes its own block.

On either form: sharded_smooth splits the NLTGV2 edge rows into
contiguous blocks with one (V, 3) psum per iteration and a replicated
vertex update (the JAX package's "edge" smoother), and
sharded_update_step runs tracking on contiguous feature blocks and then
the edge, halo or halo-kernel smoother. The halo smoothers, ShardedFlame
and sharded_update_step need the one-card form: placing the feature and
graph state, and the halo strips, across cards is the multi-card
transport (ROADMAP section 1 item 6.1), and they raise
NotImplementedError for a group. A mesh whose entries name different
cards raises NotImplementedError for the same reason.
"""

import dataclasses
from dataclasses import dataclass, field
from typing import Any, Optional

import torch
import torch.distributed as dist

from flame_tpu_torch.optimize import nltgv2
from flame_tpu_torch.params import Params, RegularizerParams

AXIS = "graph"

# Traffic of the most recent sharded_smooth call (psum_traffic_model's
# dict with edge_rows_per_device set); for several configurations call
# psum_traffic_model directly.
LAST_TRAFFIC = None


def _canonical(device) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None and torch.cuda.is_available():
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


MULTI_CARD = ("the multi-card transport (ROADMAP section 1 item 6.1: K3's "
              "strips and ShardedFlame's feature and graph state across "
              "cards)")


@dataclass(frozen=True)
class Mesh:
    """A 1-D mesh: the device of each local partition, in axis order, and
    optionally the process group whose ranks hold one partition each."""

    devices: tuple
    axis: str = AXIS
    group: Optional[Any] = None  # a torch.distributed ProcessGroup
    # Captured CUDA graphs of the sharded BA solve, by window shape
    # (parallel/distributed_ba.py).
    graphs: dict = field(default_factory=dict, compare=False, repr=False)

    def __post_init__(self):
        devs = tuple(_canonical(d) for d in self.devices)
        if not devs:
            raise ValueError("a mesh needs at least one partition")
        if len(set(devs)) > 1:
            raise NotImplementedError(
                f"a mesh over several devices needs {MULTI_CARD}, got "
                f"{sorted(str(d) for d in set(devs))}")
        if self.group is not None and len(devs) != 1:
            raise ValueError("a mesh over a process group holds one "
                             f"partition per rank, got {len(devs)}")
        object.__setattr__(self, "devices", devs)

    @property
    def size(self) -> int:
        """Number of partitions, over all ranks of the group."""
        if self.group is not None:
            return dist.get_world_size(self.group)
        return len(self.devices)

    @property
    def device(self) -> torch.device:
        """The one device this process's partitions lie on."""
        return self.devices[0]

    @property
    def first_block(self) -> int:
        """Axis index of this process's first partition."""
        return dist.get_rank(self.group) if self.group is not None else 0

    @property
    def n_local(self) -> int:
        """Partitions this process computes."""
        return len(self.devices)

    def require_one_card(self, what: str) -> None:
        if self.group is not None:
            raise NotImplementedError(
                f"{what} on a mesh over a process group needs {MULTI_CARD}")


def make_mesh(n: int = 1, device="cuda") -> Mesh:
    """n partitions of one device."""
    if n < 1:
        raise ValueError(f"a mesh needs n >= 1 partitions, got {n}")
    return Mesh((device,) * n, AXIS)


def psum(parts, mesh: Mesh) -> torch.Tensor:
    """The sum over the mesh axis: parts holds this process's partitions'
    values along a leading axis (a tensor or a sequence), summed in
    partition order; then all-reduced over the mesh's group, if any."""
    out = parts[0]
    for part in parts[1:]:
        out = out + part
    if mesh.group is not None:
        out = out.clone() if len(parts) == 1 else out
        dist.all_reduce(out, op=dist.ReduceOp.SUM, group=mesh.group)
    return out


def psum_traffic_model(V: int, n_dev: int, n_iters: int,
                       dtype_bytes: int = 4) -> dict:
    """Bytes the edge-sharded smoother moves between partitions: one
    (V, 3) float32 psum per iteration, of which a ring all-reduce moves
    ~2(n-1)/n of the payload through each partition; O(V) in volume,
    against the halo smoothers' O(1) strips (halo.traffic_model)."""
    payload = V * 3 * dtype_bytes
    per_dev = int(2 * (n_dev - 1) / max(n_dev, 1) * payload)
    return {
        "smoother": "edge_psum",
        "n_devices": n_dev,
        "edge_rows_per_device": None,  # set by the caller (E // n)
        "collectives_per_iter": 1,  # one (V, 3) psum
        "bytes_per_device_per_iter": per_dev,
        "bytes_per_device_total": per_dev * n_iters,
        "bytes_all_devices_total": per_dev * n_iters * n_dev,
    }


# ---------------------------------------------------------------------------
# Edge-sharded NLTGV2 smoothing.
# ---------------------------------------------------------------------------


def sharded_smooth(p: RegularizerParams, g: nltgv2.GraphState, n_iters: int,
                   mesh: Mesh) -> nltgv2.GraphState:
    """n_iters edge-sharded stacked iterations (nltgv2._smooth_stacked)
    over the mesh: the edge rows split into mesh.size contiguous blocks;
    each block gathers its rows' bars and segment-sums its contributions
    into its own (V, 3) slice, one psum per iteration combines the
    slices, and the vertex update and extragradient are the same on every
    partition. The same function as nltgv2.smooth up to the order of the
    float sums. The edge capacity must divide into the partitions.

    Over a process group every rank holds the whole graph and iterates
    its own block of dual rows; the q blocks are all-gathered at the end,
    so the returned GraphState is whole on every rank."""
    global LAST_TRAFFIC
    V = g.x.shape[0]
    E = g.q1.shape[0]
    n = mesh.size
    if E % n:
        raise ValueError(f"sharded_smooth: edge capacity {E} does not "
                         f"divide into {n} partitions")
    if g.x.device != mesh.device:
        raise ValueError(f"sharded_smooth: graph on {g.x.device}, mesh on "
                         f"{mesh.device}")
    Eb = E // n
    LAST_TRAFFIC = psum_traffic_model(V, n, n_iters)
    LAST_TRAFFIC["edge_rows_per_device"] = Eb
    rows = slice(mesh.first_block * Eb, (mesh.first_block + mesh.n_local)
                 * Eb)
    t = nltgv2.edge_terms(p, g, rows)
    # Each row's index into the (n_local * V, 3) partition slices.
    base = torch.arange(mesh.n_local * Eb, device=g.x.device) // Eb * V
    at_i = base + t.ii
    at_j = base + t.jj

    def combine(Ci, Cj):
        S = Ci.new_zeros((mesh.n_local * V, 3))
        S.index_add_(0, at_i, Ci).index_add_(0, at_j, Cj)
        return psum(S.view(mesh.n_local, V, 3), mesh)

    x, w1, w2, VB, q = nltgv2.stacked_iterations(
        p, g, t, (g.q1[rows], g.q2[rows], g.q3[rows]), n_iters, combine)
    if mesh.group is not None:
        q = tuple(_all_gather(qk, mesh) for qk in q)
    return nltgv2.stacked_result(g, x, w1, w2, VB, q)


def _all_gather(block: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    parts = [torch.empty_like(block) for _ in range(mesh.size)]
    dist.all_gather(parts, block.contiguous(), group=mesh.group)
    return torch.cat(parts)


# ---------------------------------------------------------------------------
# Feature-sharded tracking + the sharded smoother: the whole per-frame
# step.
# ---------------------------------------------------------------------------


def _rows(state, sl: slice):
    return dataclasses.replace(state, **{
        f.name: getattr(state, f.name)[sl]
        for f in dataclasses.fields(state)})


def _cat(states):
    return dataclasses.replace(states[0], **{
        f.name: torch.cat([getattr(s, f.name) for s in states])
        for f in dataclasses.fields(states[0])})


def sharded_update_step(params: Params, mesh: Mesh, smoother: str = "edge"):
    """The per-frame step sharded over the mesh's partitions.

    Returns step(K, Kinv, stack, feats, fnew, curr_pf_slot, graph[, perm,
    inv_perm, ranks_p]) -> (feats', curr, member, graph', stats):
    pipeline.track_project_sync runs on each of mesh.size contiguous
    feature blocks (gating and fusion are elementwise over features, so
    the blocks concatenate to the unsharded result; stats are summed over
    the blocks), then n_iters_per_frame smoother iterations: "edge" is
    sharded_smooth; "halo" (halo.halo_smooth, strips of halo.strip_width
    ranks) and "pallas_halo" (the halo kernel K3) take the RCM order and
    RCM-order edge ranks as the trailing arguments (see parallel/halo.py).
    The feature and edge capacities must divide into the partitions."""
    # Imported here: core/pipeline.py imports this module.
    from flame_tpu_torch.core import pipeline
    from flame_tpu_torch.parallel import halo, halo_kernel
    mesh.require_one_card("sharded_update_step")
    if smoother not in ("edge", "halo", "pallas_halo"):
        raise ValueError(f"unknown sharded smoother {smoother!r}; one of "
                         "('edge', 'halo', 'pallas_halo')")
    n = mesh.size
    N = params.feature_capacity
    if N % n or params.edge_capacity % n:
        raise ValueError("feature/edge capacity must divide into the "
                         f"mesh's {n} partitions")
    rp = params.rparams
    n_iters = params.solver.n_iters_per_frame
    D = params.solver.max_vertex_degree
    reach = params.solver.pallas_reach

    def tracked(K, Kinv, stack, feats, fnew, curr_pf_slot):
        outs = [pipeline.track_project_sync(
            params, K, Kinv, stack, _rows(feats, slice(b * N // n,
                                                       (b + 1) * N // n)),
            fnew, curr_pf_slot) for b in range(n)]
        stats = torch.stack([o[3] for o in outs]).reshape(n, -1) \
            .sum(0, dtype=torch.int32)
        return (_cat([o[0] for o in outs]), _cat([o[1] for o in outs]),
                torch.cat([o[2] for o in outs]), stats)

    if smoother == "edge":
        def step(K, Kinv, stack, feats, fnew, curr_pf_slot, graph):
            feats2, curr, member, stats = tracked(K, Kinv, stack, feats,
                                                  fnew, curr_pf_slot)
            return (feats2, curr, member,
                    sharded_smooth(rp, graph, n_iters, mesh), stats)
        return step

    def step(K, Kinv, stack, feats, fnew, curr_pf_slot, graph, perm,
             inv_perm, ranks_p):
        feats2, curr, member, stats = tracked(K, Kinv, stack, feats, fnew,
                                              curr_pf_slot)
        if smoother == "pallas_halo":
            graph2 = halo_kernel.smooth_sharded(
                rp, graph, perm, inv_perm, ranks_p, n_iters, D, mesh,
                reach=reach)
        else:
            graph2 = halo.halo_smooth(
                rp, graph, perm, inv_perm, ranks_p, n_iters, D, mesh,
                halo=halo.strip_width(N, n, reach))
        return feats2, curr, member, graph2, stats
    return step
