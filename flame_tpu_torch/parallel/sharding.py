"""The partition mesh, the placement helpers, the edge-sharded smoother
and the sharded update step.

Counterpart of flame_tpu/parallel/sharding.py. The JAX package's mesh is
a row of chips; the port's Mesh takes one of two forms:

  * n partitions of one card (make_mesh): a partition is a block of rows
    along a leading tensor axis, and the JAX package's lax.psum over the
    mesh axis becomes a sum over that axis (psum). The halo kernel K3
    runs a thread-block cluster per partition (parallel/halo_kernel.py)
    and the plain "halo" smoother shifts strips along the partition axis
    (parallel/halo.py).
  * one partition per process of a torch.distributed group
    (parallel/multihost.global_mesh), the form in which several cards
    run: one rank per card, NCCL between them (gloo on the CPU, or for
    several ranks on one card). psum sums the process's partition, then
    all-reduces over the group. The placement helpers stand in for the
    JAX package's NamedSharding: shard_rows takes this rank's block of a
    state along its capacity axis, gather_rows all-gathers the blocks
    back into the whole state in rank order. The halo smoothers send
    their boundary strips to the ring neighbours with point-to-point
    messages (ring_exchange; K3 stores them into the neighbours' receive
    slots itself), and ShardedFlame (parallel/orchestrator.py) keeps
    only the rank's block of the feature and graph state.

On either form: sharded_smooth splits the NLTGV2 edge rows into
contiguous blocks with one (V, 3) psum per iteration and a replicated
vertex update (the JAX package's "edge" smoother), and
sharded_update_step runs tracking on contiguous feature blocks and then
the edge, halo or halo-kernel smoother. A mesh whose entries name
different cards in one process raises NotImplementedError: several cards
run as a process group.

Under a gloo group whose tensors lie on the card, every collective and
every strip moves through host tensors (gloo carries CPU tensors); the
compute stays on the card.
"""

import dataclasses
from dataclasses import dataclass
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


MULTI_CARD = ("several cards run as a process group, one rank per card: "
              "multihost.initialize, then multihost.global_mesh()")


@dataclass(frozen=True)
class Mesh:
    """A 1-D mesh: the device of each local partition, in axis order, and
    optionally the process group whose ranks hold one partition each;
    a value (the sharded BA solve's graphs are keyed on it)."""

    devices: tuple
    axis: str = AXIS
    group: Optional[Any] = None  # a torch.distributed ProcessGroup

    def __post_init__(self):
        devs = tuple(_canonical(d) for d in self.devices)
        if not devs:
            raise ValueError("a mesh needs at least one partition")
        if len(set(devs)) > 1:
            raise NotImplementedError(
                f"a mesh of one process lies on one device, got "
                f"{sorted(str(d) for d in set(devs))}; {MULTI_CARD}")
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

    @property
    def staged(self) -> bool:
        """True where the group's collectives take host tensors although
        the mesh lies on the card (gloo)."""
        return (self.group is not None and self.device.type == "cuda"
                and dist.get_backend(self.group) == "gloo")


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
        out = _to_wire(out.clone() if len(parts) == 1 else out, mesh)
        dist.all_reduce(out, op=dist.ReduceOp.SUM, group=mesh.group)
        out = out.to(mesh.device)
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


# ---------------------------------------------------------------------------
# Placement over a process group: the counterpart of NamedSharding.
# ---------------------------------------------------------------------------


def _to_wire(t: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """t as the group's collectives take it: a host copy under a staged
    (gloo, card) mesh, else t itself."""
    return t.cpu() if mesh.staged else t


def _all_gather(block: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The ranks' blocks concatenated in rank order, on mesh.device."""
    block = _to_wire(block.contiguous(), mesh)
    parts = [torch.empty_like(block) for _ in range(mesh.size)]
    dist.all_gather(parts, block, group=mesh.group)
    return torch.cat(parts).to(mesh.device)


def grouped(mesh: Optional[Mesh]) -> bool:
    """True for a mesh over a process group."""
    return mesh is not None and mesh.group is not None


def _leaves(state):
    """(names, values) of a dataclass, a NamedTuple or a tensor (one
    leaf named None)."""
    if isinstance(state, torch.Tensor):
        return [None], [state]
    if dataclasses.is_dataclass(state):
        names = [f.name for f in dataclasses.fields(state)]
    else:
        names = list(state._fields)
    return names, [getattr(state, k) for k in names]


def _rebuild(state, names, values):
    if isinstance(state, torch.Tensor):
        return values[0]
    kw = dict(zip(names, values))
    if dataclasses.is_dataclass(state):
        return dataclasses.replace(state, **kw)
    return state._replace(**kw)


def block_slice(length: int, mesh: Mesh) -> slice:
    """This rank's rows of a capacity axis of `length` rows."""
    if length % mesh.size:
        raise ValueError(f"a capacity of {length} rows does not divide "
                         f"into the mesh's {mesh.size} partitions")
    b = length // mesh.size
    return slice(mesh.first_block * b, (mesh.first_block + 1) * b)


def shard_rows(state, mesh: Optional[Mesh]):
    """This rank's block of every leaf of state (a dataclass such as
    FeatureState or GraphState, a NamedTuple or a tensor) along its
    leading capacity axis, as its own storage; None leaves stay None.
    The whole state on a mesh of one process."""
    if not grouped(mesh):
        return state
    names, vals = _leaves(state)
    return _rebuild(state, names, [
        None if v is None else v[block_slice(v.shape[0], mesh)].clone()
        for v in vals])


def gather_rows(mesh: Optional[Mesh], *states):
    """The whole states from every rank's block (shard_rows' inverse), in
    rank order, so that the slots keep their order. One all-gather per
    leading block size: the leaves of that size travel as one byte
    tensor. Returns one state for one argument, else a tuple. The states
    themselves on a mesh of one process."""
    if not grouped(mesh):
        return states[0] if len(states) == 1 else states
    flat = [_leaves(s) for s in states]
    by_rows = {}
    for i, (_, vals) in enumerate(flat):
        for j, v in enumerate(vals):
            if v is not None:
                by_rows.setdefault(v.shape[0], []).append((i, j))
    out = [list(vals) for _, vals in flat]
    for rows, where in by_rows.items():
        cols = [flat[i][1][j].contiguous().reshape(rows, -1)
                .view(torch.uint8) for i, j in where]
        whole = _all_gather(torch.cat(cols, 1), mesh)
        at = 0
        for (i, j), c in zip(where, cols):
            v = flat[i][1][j]
            out[i][j] = whole[:, at:at + c.shape[1]].contiguous() \
                .view(v.dtype).reshape((mesh.size * rows,) + v.shape[1:])
            at += c.shape[1]
    got = tuple(_rebuild(s, names, vals)
                for s, (names, _), vals in zip(states, flat, out))
    return got[0] if len(got) == 1 else got


def agree(flag: bool, mesh: Optional[Mesh]) -> bool:
    """The coordinator's flag on every rank (a decision that depends on
    timing, such as whether a copy has landed, taken once for the group
    so that every rank issues the same collectives); flag itself on a
    mesh of one process."""
    if not grouped(mesh):
        return flag
    t = _to_wire(torch.tensor([int(flag)], dtype=torch.int32,
                              device=mesh.device), mesh)
    dist.broadcast(t, src=dist.get_global_rank(mesh.group, 0),
                   group=mesh.group)
    return bool(t.item())


def ring_exchange(mesh: Mesh, to_left: torch.Tensor,
                  to_right: torch.Tensor):
    """One halo exchange over the group's ring: this rank sends to_left
    to its left neighbour and to_right to its right one, and returns
    (from_left, from_right): the left neighbour's to_right and the right
    neighbour's to_left (the JAX package's two ppermutes). Point-to-point
    through dist.batch_isend_irecv; under a staged mesh through host
    tensors. On a group of one rank the ring wraps onto the rank itself."""
    n = mesh.size
    if n == 1:
        return to_right.clone(), to_left.clone()
    r = mesh.first_block
    g = mesh.group
    left = dist.get_global_rank(g, (r - 1) % n)
    right = dist.get_global_rank(g, (r + 1) % n)
    sl = _to_wire(to_left.contiguous(), mesh)
    sr = _to_wire(to_right.contiguous(), mesh)
    from_left = torch.empty_like(sr)
    from_right = torch.empty_like(sl)
    # Tag 0 travels leftwards, tag 1 rightwards; at two ranks both
    # neighbours are one peer, and its messages match in this order.
    ops = [dist.P2POp(dist.isend, sl, left, g, 0),
           dist.P2POp(dist.isend, sr, right, g, 1),
           dist.P2POp(dist.irecv, from_right, right, g, 0),
           dist.P2POp(dist.irecv, from_left, left, g, 1)]
    for w in dist.batch_isend_irecv(ops):
        w.wait()
    return from_left.to(mesh.device), from_right.to(mesh.device)


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
    The feature and edge capacities must divide into the partitions.

    Over a process group, feats is this rank's block (shard_rows) and
    feats', curr and member are its block too; stats are all-reduced over
    the group. The graph is whole on every rank, and so is graph': each
    smoother gathers its partitions' outputs."""
    # Imported here: core/pipeline.py imports this module.
    from flame_tpu_torch.core import pipeline
    from flame_tpu_torch.parallel import halo, halo_kernel
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
        if grouped(mesh):
            if feats.valid.shape[0] != N // n:
                raise ValueError(
                    f"sharded_update_step: over a process group feats is "
                    f"the rank's block of {N // n} rows, got "
                    f"{feats.valid.shape[0]}")
            f2, curr, member, stats, _ = pipeline.track_project_sync(
                params, K, Kinv, stack, feats, fnew, curr_pf_slot)
            return f2, curr, member, psum([stats], mesh)
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
