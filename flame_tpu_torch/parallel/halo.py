"""Vertex-partitioned NLTGV2 smoothing with a halo exchange, plain torch.

Counterpart of flame_tpu/parallel/halo.py (smoother="halo"), which the
JAX package runs in XLA under shard_map. Vertices are in RCM rank order
(smoother_kernel.rcm_order), cut into n contiguous blocks of Vb = V / n
ranks, one per mesh partition. The partitions are a leading tensor axis
(n, Vb, ...): each iteration a partition reads `halo` boundary ranks of
the extragradient state from each ring neighbour (the JAX package's two
ppermutes, here two index shifts over that axis; the wrap-around strips
are garbage that no edge reads), then runs the vertex-centric
Chambolle-Pock step on its block. Each endpoint keeps its own copy of an
edge's duals, so the halo is read-only.

Over a process group (multihost.global_mesh) each rank holds the whole
graph, iterates its own block, and sends its two boundary strips to its
ring neighbours every iteration (sharding.ring_exchange: point-to-point
messages, through host tensors under gloo with the state on the card);
the blocks' outputs are all-gathered, so every rank returns the whole
GraphState.

This mode drops an edge whose endpoints lie more than `halo` RANKS apart
(rank_layout); the banded halo kernel (halo_kernel.py) drops by ROW
distance. Both rules are kept as the JAX package has them.
"""

import torch

from flame_tpu_torch.optimize import nltgv2
from flame_tpu_torch.optimize.smoother_kernel import LANES, write_back
from flame_tpu_torch.params import RegularizerParams
from flame_tpu_torch.parallel.sharding import (Mesh, block_slice,
                                               gather_rows, grouped,
                                               ring_exchange)


def strip_width(v_cap: int, n_dev: int, reach: int) -> int:
    """The halo width halo_smooth runs with on the pipeline: the band the
    RCM ranks target, clamped to a partition's block. Flame's drop
    counter uses the same number."""
    return min(v_cap // n_dev, (reach + 1) * LANES)


def traffic_model(V: int, n_dev: int, n_iters: int, halo: int,
                  dtype_bytes: int = 4) -> dict:
    """Bytes one halo_smooth call exchanges: per iteration each partition
    sends its two boundary strips of (halo, 3) bar state, independent of
    V."""
    strip = halo * 3 * dtype_bytes
    return {
        "smoother": "halo",
        "n_devices": n_dev,
        "block_rows_per_device": V // n_dev,
        "collectives_per_iter": 2,
        "bytes_per_device_per_iter": 2 * strip,
        "bytes_per_device_total": 2 * strip * n_iters,
        "bytes_all_devices_total": 2 * strip * n_iters * n_dev,
    }


def rank_layout(g: nltgv2.GraphState, perm, inv_perm, ranks_p, degree: int,
                halo: int):
    """Rank-order tables: (vtx 9-tuple of (V,), slots 10-tuple of (V, D)
    [nbr global rank, sdx, sdy, sal, sbe, sgn, srcf, q1, q2, q3], src_slot
    (E,) flat rank * D + d of each edge's src copy (V * D when dropped),
    alive (E,) bool)."""
    V = g.x.shape[0]
    D = degree
    dev = g.x.device
    perm = perm.long()
    inv_perm = inv_perm.long()
    vtx = tuple(a[perm] for a in (
        g.x, g.w1, g.w2, g.x_bar, g.w1_bar, g.w2_bar, g.data_term,
        g.data_weight, g.vtx_mask.float()))

    lo = g.edges[:, 0].long()
    hi = g.edges[:, 1].long()
    lo_p = inv_perm[lo]
    hi_p = inv_perm[hi]
    sr = ranks_p[:, 0].long()
    dr = ranks_p[:, 1].long()
    alive = (g.edge_mask & (torch.abs(lo_p - hi_p) <= halo)
             & (sr < D) & (dr < D))

    d = g.pos[lo] - g.pos[hi]
    sent = V * D
    slot_s = torch.where(alive, lo_p * D + sr, sent)
    slot_d = torch.where(alive, hi_p * D + dr, sent)

    def scat2(vals_s, vals_d, dtype=torch.float32):
        buf = torch.zeros(V * D + 1, dtype=dtype, device=dev)
        buf[slot_s] = vals_s.to(dtype)
        buf[slot_d] = vals_d.to(dtype)
        return buf[:-1].reshape(V, D)

    zero = torch.zeros_like(d[:, 0])
    alpha = torch.where(alive, g.alpha, zero)
    beta = torch.where(alive, g.beta, zero)
    one = alive.float()
    slots = (scat2(hi_p, lo_p, torch.int64),
             scat2(d[:, 0], d[:, 0]), scat2(d[:, 1], d[:, 1]),
             scat2(alpha, alpha), scat2(beta, beta),
             scat2(one, -one), scat2(one, zero),
             scat2(g.q1, g.q1), scat2(g.q2, g.q2), scat2(g.q3, g.q3))
    return vtx, slots, slot_s, alive


def _iterate(p: RegularizerParams, n_iters: int, halo: int, n_dev: int,
             vtx, slots, mesh: Mesh = None):
    """The n_iters iterations over (n_dev, Vb, ...) partitions; returns
    (x, w1, w2, x_bar, w1_bar, w2_bar) as (V,) and (q1, q2, q3) as
    (V, D). Over a process group (mesh) vtx and slots are this rank's
    block of Vb ranks, and so are the outputs."""
    V, D = slots[0].shape
    first = 0
    if grouped(mesh):
        first, n_dev = mesh.first_block, 1
    Vb = V // n_dev
    dev = slots[0].device
    x, w1, w2, xb, w1b, w2b, data, weight, vmaskf = (
        a.reshape(n_dev, Vb) for a in vtx)
    nbr, sdx, sdy, sal, sbe, sgn, srcf, q1, q2, q3 = (
        a.reshape(n_dev, Vb, D) for a in slots)

    is_src = srcf > 0.0
    vmask = vmaskf > 0.0
    wgt = p.data_factor * weight
    # Index of each slot's neighbour in its partition's extended block.
    block_start = ((first + torch.arange(n_dev, device=dev))
                   * Vb)[:, None, None]
    nbr_ext = torch.clamp(nbr - block_start + halo, 0, Vb + 2 * halo - 1)
    part = torch.arange(n_dev, device=dev)[:, None, None]

    def extend(VB):
        """(n, Vb, 3) -> (n, Vb + 2 * halo, 3): partition i gets the last
        halo ranks of i - 1 and the first halo ranks of i + 1 (ring)."""
        if grouped(mesh):
            left, right = ring_exchange(mesh, VB[:, :halo], VB[:, -halo:])
        else:
            left = torch.roll(VB[:, -halo:], 1, dims=0)
            right = torch.roll(VB[:, :halo], -1, dims=0)
        return torch.cat([left, VB, right], dim=1)

    q = (q1, q2, q3)
    VB = torch.stack([xb, w1b, w2b], dim=2)
    for _ in range(n_iters):
        nb = extend(VB)[part, nbr_ext]  # (n, Vb, D, 3)
        q, d = nltgv2.slot_step(
            p, is_src, sdx, sdy, sal, sbe, sgn,
            (VB[:, :, None, 0], VB[:, :, None, 1], VB[:, :, None, 2]),
            (nb[..., 0], nb[..., 1], nb[..., 2]), q)
        x, w1, w2, *bars = nltgv2.vertex_step(
            p, x, w1, w2, [v.sum(2) for v in d], data, wgt, vmask)
        VB = torch.stack(bars, dim=2)
    return (tuple(a.reshape(V) for a in (x, w1, w2))
            + tuple(VB[..., k].reshape(V) for k in range(3))
            + tuple(a.reshape(V, D) for a in q))


def halo_smooth(p: RegularizerParams, g: nltgv2.GraphState, perm, inv_perm,
                ranks_p, n_iters: int, degree: int, mesh: Mesh,
                halo: int = 384) -> nltgv2.GraphState:
    """n_iters vertex-partitioned iterations over the mesh's partitions.
    perm / inv_perm / ranks_p come from smoother_kernel.rcm_order and
    perm_edge_ranks. V must divide into mesh.size blocks of at least
    `halo` ranks. Over a process group every rank passes the whole graph
    and gets the whole result."""
    V = g.x.shape[0]
    n_dev = mesh.size
    if V % n_dev:
        raise ValueError(f"halo_smooth: vertex capacity {V} does not "
                         f"divide into {n_dev} partitions")
    if V // n_dev < halo:
        raise ValueError(f"halo_smooth: halo {halo} is wider than a "
                         f"partition's block of {V // n_dev} ranks")
    if g.x.device != mesh.device:
        raise ValueError(f"halo_smooth: graph on {g.x.device}, mesh on "
                         f"{mesh.device}")
    vtx, slots, src_slot, alive = rank_layout(g, perm, inv_perm, ranks_p,
                                              degree, halo)
    if grouped(mesh):
        rows = block_slice(V, mesh)
        outs = gather_rows(mesh, *_iterate(
            p, n_iters, halo, n_dev, [a[rows] for a in vtx],
            [a[rows] for a in slots], mesh))
    else:
        outs = _iterate(p, n_iters, halo, n_dev, vtx, slots)
    return write_back(g, outs, inv_perm, src_slot, alive)
