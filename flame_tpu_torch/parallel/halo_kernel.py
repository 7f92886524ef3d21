"""The partitioned banded smoother with its CUDA halo kernel (K3).

Counterpart of flame_tpu/parallel/pallas_halo.py (smoother="pallas_halo",
and smoother="pallas" at one partition), as optimize/smoother_kernel.py
is of pallas_smoother.py. The banded layout (smoother_kernel.build_layout)
is cut into mesh.size partitions of Rb = R / n contiguous rows of 128
lanes. Every iteration each partition sends its top `reach` rows of the
extragradient state (x_bar, w1_bar, w2_bar) to its left ring neighbour
and its bottom `reach` rows to its right one, installs the two strips it
receives as halo rows around its own block, and runs K1's
Chambolle-Pock step on its block, reading neighbours through the
extended (Rb + 2 * reach, 128) state. The RCM band keeps every live edge
within `reach` rows, so a partition never needs more.

For tensors on the CPU the iterations run the plain version
(iterate_plain). For CUDA tensors csrc/halo_smoother.cu runs all
iterations of all partitions in one launch, a thread-block cluster per
partition (launch_plan), or the call raises; there is no fallback.

Over a process group (multihost.global_mesh) each rank launches the
kernel over its own block of rows, and the ring crosses ranks at the
block's ends: every rank allocates the receive slots and flags of its
partitions itself (halo_peer_alloc, once per shape and group, _PeerRing),
the ranks exchange their CUDA IPC handles with one all-gather, and each
maps its two ring neighbours' buffers; the kernel stores its boundary
strips and raises its flags there. The flags are epoch-counted across
calls, never reset (csrc/halo_smoother.cu). release_peer_buffers (called
by multihost.shutdown) frees them. The plain version runs over a group
too, its strips through sharding.ring_exchange. smooth_sharded gathers
every rank's outputs, so each rank returns the whole GraphState.
"""

import ctypes
import functools
from typing import Callable, NamedTuple

import torch
import torch.distributed as dist

from flame_tpu_torch import _kernels
from flame_tpu_torch.optimize import nltgv2
from flame_tpu_torch.optimize.smoother_kernel import (LANES, _rows,
                                                      build_layout,
                                                      write_back)
from flame_tpu_torch.params import RegularizerParams
from flame_tpu_torch.parallel.sharding import (Mesh, block_slice,
                                               gather_rows, grouped,
                                               ring_exchange)

KERNEL = "halo_smoother"
# The kernel's compile-time shape (csrc/halo_smoother.cu): CTAs of 32
# warps, a lane per slot (D <= 32), 1, 2, 4 or 8 vertices per warp,
# clusters of at most 16 CTAs.
WARPS_PER_CTA = 32
MAX_DEGREE = 32
VERTICES_PER_WARP = (1, 2, 4, 8)
MAX_CLUSTER = 16


class LaunchPlan(NamedTuple):
    cluster: int  # CTAs per cluster, C
    vertices_per_warp: int
    splits: int  # clusters per partition
    clusters: int  # n * splits, all resident at once
    max_active_clusters: int  # what the card holds of this shape


def fitting_plans(V: int, D: int, n: int, n_sms: int,
                  max_active_clusters: Callable[[int, int], int],
                  reach: int = 2):
    """Every shape whose clusters the card holds resident at once, the
    fewest vertices per warp first and, among those, the fewest clusters.
    A partition may be split along its rows over several clusters (the
    kernel then runs n * splits partitions of the same ring; the outputs
    do not depend on the count). max_active_clusters(cluster,
    vertices_per_warp) is what the card holds of that shape (its cluster
    occupancy)."""
    if not 1 <= D <= MAX_DEGREE:
        raise ValueError(f"{KERNEL}: degree D={D} outside [1, {MAX_DEGREE}]")
    R = _rows(V)
    _check_blocks(R, n, reach)
    Rb = R // n
    for vpw in VERTICES_PER_WARP:
        for splits in (s for s in range(1, Rb + 1)
                       if Rb % s == 0 and Rb // s >= reach):
            nv = Rb // splits * LANES
            clusters = n * splits
            c = -(-nv // (WARPS_PER_CTA * vpw))
            if c > MAX_CLUSTER or clusters * c > n_sms:
                continue
            held = max_active_clusters(c, vpw)
            if clusters <= held:
                yield LaunchPlan(c, vpw, splits, clusters, held)


def launch_plan(V: int, D: int, n: int, n_sms: int,
                max_active_clusters: Callable[[int, int], int],
                reach: int = 2) -> LaunchPlan:
    """The first of fitting_plans: the fewest vertices per warp, then the
    fewest clusters. An iteration's time follows the vertices per warp
    (each adds a slot update and a slot-order sum to a warp's chain), far
    more than the clusters' flag handshakes. Raises ValueError, naming
    the limit, for a V, D or n the kernel cannot hold."""
    for plan in fitting_plans(V, D, n, n_sms, max_active_clusters, reach):
        return plan
    Rb = _rows(V) // n
    most = max(min(max_active_clusters(c, vpw), n_sms // c) * c
               * WARPS_PER_CTA * vpw
               for c in range(1, MAX_CLUSTER + 1) for vpw in VERTICES_PER_WARP)
    raise ValueError(
        f"{KERNEL}: V={V} vertices in {n} partitions of {Rb} rows do not "
        f"fit the card at once: at most {most} ({n_sms} SMs, clusters of "
        f"at most {MAX_CLUSTER} CTAs of {WARPS_PER_CTA} warps, at most "
        f"{VERTICES_PER_WARP[-1]} vertices per warp, every cluster "
        f"resident)")


def card_occupancy(device_index: int, reach: int):
    """The card's SM count and its cluster occupancy for the kernel's
    shapes, as launch_plan takes them."""
    lib = _kernels.load()

    def max_active_clusters(cluster, vpw):
        with torch.cuda.device(device_index):
            k = ctypes.c_int()
            _kernels.check_cuda_error(lib.halo_smoother_occupancy(
                cluster, vpw, reach, ctypes.byref(k)), KERNEL)
        return k.value
    props = torch.cuda.get_device_properties(device_index)
    return props.multi_processor_count, max_active_clusters


@functools.lru_cache(maxsize=None)
def _plan(device_index: int, V: int, D: int, n: int,
          reach: int) -> LaunchPlan:
    return launch_plan(V, D, n, *card_occupancy(device_index, reach), reach)


def traffic_model(V: int, n_dev: int, n_iters: int, reach: int,
                  dtype_bytes: int = 4) -> dict:
    """Bytes one smooth_sharded call exchanges: per iteration each
    partition sends its top and bottom `reach` rows of the three bar
    fields, independent of V."""
    strip = reach * LANES * 3 * dtype_bytes
    return {
        "smoother": "pallas_halo",
        "n_devices": n_dev,
        "block_rows_per_device": _rows(V) // n_dev,
        "collectives_per_iter": 2,
        "bytes_per_device_per_iter": 2 * strip,
        "bytes_per_device_total": 2 * strip * n_iters,
        "bytes_all_devices_total": 2 * strip * n_iters * n_dev,
    }


def _check_blocks(R: int, n: int, reach: int):
    if n < 1 or R % n:
        raise ValueError(f"{KERNEL}: {R} rank rows do not divide into {n} "
                         f"partitions")
    if R // n < reach:
        raise ValueError(f"{KERNEL}: a partition's {R // n} rows must "
                         f"cover the halo of reach {reach}")


def iterate_plain(p: RegularizerParams, n_iters: int, degree: int,
                  reach: int, n: int, vtx, slots, mesh: Mesh = None):
    """The plain version of the kernel: n_iters iterations of every
    partition over (n, Rb + 2 * reach, 128) extended bar state
    (pallas_halo._halo_kernel of the JAX package). vtx / slots as
    BandedLayout's; returns (x, w1, w2, x_bar, w1_bar, w2_bar) as
    (R, 128) and (q1, q2, q3) as (R * D, 128). Over a process group
    (mesh) vtx and slots are this rank's block, its one partition, and so
    are the outputs; the strips travel through sharding.ring_exchange."""
    R = vtx[0].shape[0]
    D = degree
    r = reach
    if grouped(mesh):
        n = 1
    _check_blocks(R, n, r)
    Rb = R // n
    x, w1, w2, xb, w1b, w2b, data, weight, vmaskf = (
        a.reshape(n, Rb, LANES) for a in vtx)
    nbr, rf, sdx, sdy, sal, sbe, sgn, srcf, q1, q2, q3 = (
        a.reshape(n, Rb * D, LANES) for a in slots)
    nbr = nbr.long()

    is_src = srcf > 0.0
    vmask = vmaskf > 0.0
    wgt = p.data_factor * weight

    def rep(v):  # (n, Rb, 128) -> (n, Rb * D, 128): slot row i*D+d = row i
        return v[:, :, None, :].expand(n, Rb, D, LANES).reshape(
            n, Rb * D, LANES)

    def nbr_read(vE):
        """Per-slot neighbour value from (n, Rb + 2r, 128) extended state:
        a slot with rowflag k reads extended rows [k, k + Rb)."""
        out = None
        for k in range(2 * r + 1):
            gk = torch.gather(rep(vE[:, k:k + Rb]), 2, nbr)
            out = gk if out is None else torch.where(rf == k, gk, out)
        return out

    def dsum(v):
        return v.reshape(n, Rb, D, LANES).sum(2)

    # Extended bar state; rows [0, r) come from the left neighbour, rows
    # [Rb + r, Rb + 2r) from the right one (ring; at n = 1 a partition
    # is its own neighbour and the wrapped rows are never read).
    be = torch.zeros((3, n, Rb + 2 * r, LANES), dtype=torch.float32,
                     device=x.device)
    be[0, :, r:Rb + r] = xb
    be[1, :, r:Rb + r] = w1b
    be[2, :, r:Rb + r] = w2b
    q = (q1, q2, q3)
    for _ in range(n_iters):
        if grouped(mesh):
            be[:, :, :r], be[:, :, Rb + r:] = ring_exchange(
                mesh, be[:, :, r:2 * r], be[:, :, Rb:Rb + r])
        else:
            be[:, :, :r] = torch.roll(be[:, :, Rb:Rb + r], 1, dims=1)
            be[:, :, Rb + r:] = torch.roll(be[:, :, r:2 * r], -1, dims=1)
        q, d = nltgv2.slot_step(
            p, is_src, sdx, sdy, sal, sbe, sgn,
            [rep(v[:, r:Rb + r]) for v in be], [nbr_read(v) for v in be], q)
        x, w1, w2, *bars = nltgv2.vertex_step(
            p, x, w1, w2, [dsum(v) for v in d], data, wgt, vmask)
        for k in range(3):
            be[k, :, r:Rb + r] = bars[k]
    own = be[:, :, r:Rb + r]
    return (tuple(a.reshape(R, LANES) for a in (x, w1, w2, own[0], own[1],
                                                 own[2]))
            + tuple(a.reshape(R * D, LANES) for a in q))


class _PeerRing:
    """The receive slots (parts, 2, 2, 3, reach, 128) f32 and flags
    (parts, 2) i32 of this rank's partitions, in one zeroed cudaMalloc
    allocation, and the addresses of the two ring neighbours' (the
    previous rank's last partition and the next rank's first), mapped
    from their IPC handles. epoch: the sum of n_iters + 1 over the calls
    made on these flags."""

    def __init__(self, mesh: Mesh, device: torch.device, parts: int,
                 reach: int):
        lib = _kernels.load()
        self.device = device
        slot_bytes = 4 * 3 * reach * LANES * 4  # a partition's 4 strips
        self.rx_bytes = parts * slot_bytes
        self.base = ctypes.c_void_p()
        self.opened = {}  # peer rank -> mapped address
        self.epoch = 0
        hs = lib.halo_peer_handle_size()
        with torch.cuda.device(device):
            _kernels.check_cuda_error(lib.halo_peer_alloc(
                self.rx_bytes + 8 * parts, ctypes.byref(self.base)), KERNEL)
            handle = (ctypes.c_char * hs)()
            _kernels.check_cuda_error(
                lib.halo_peer_handle(self.base, handle), KERNEL)
            # One all-gather of (handle bytes, partition count) per rank.
            mine = torch.frombuffer(bytearray(bytes(handle)
                                              + parts.to_bytes(8, "little")),
                                    dtype=torch.uint8)
            table = gather_rows(mesh, mine[None].to(device)).cpu()
            n, r = mesh.size, mesh.first_block

            def peer(k):  # (base address, partitions) of rank k's buffer
                if k == r:
                    return self.base.value, parts
                if k not in self.opened:
                    ptr = ctypes.c_void_p()
                    _kernels.check_cuda_error(lib.halo_peer_open(
                        bytes(table[k, :hs].numpy()), ctypes.byref(ptr)),
                        KERNEL)
                    self.opened[k] = ptr.value
                return self.opened[k], int.from_bytes(
                    bytes(table[k, hs:].numpy()), "little")
            lo, lo_parts = peer((r - 1) % n)
            hi, hi_parts = peer((r + 1) % n)
        # A buffer's flags follow its slots.
        self.rx = self.base.value
        self.flags = self.base.value + self.rx_bytes
        self.rx_lo = lo + (lo_parts - 1) * slot_bytes
        self.flags_lo = lo + lo_parts * slot_bytes + 8 * (lo_parts - 1)
        self.rx_hi = hi
        self.flags_hi = hi + hi_parts * slot_bytes

    def close(self, lib):
        with torch.cuda.device(self.device):
            for ptr in self.opened.values():
                _kernels.check_cuda_error(lib.halo_peer_close(
                    ctypes.c_void_p(ptr)), KERNEL)
            self.opened = {}

    def free(self, lib):
        with torch.cuda.device(self.device):
            _kernels.check_cuda_error(lib.halo_peer_free(self.base), KERNEL)


# (group, device index, partitions, reach) -> _PeerRing of this process.
_PEER_RINGS = {}


def _peer_ring(mesh: Mesh, dev: torch.device, parts: int,
               reach: int) -> _PeerRing:
    key = (mesh.group, dev.index, parts, reach)
    ring = _PEER_RINGS.get(key)
    if ring is None:
        ring = _PEER_RINGS[key] = _PeerRing(mesh, dev, parts, reach)
    return ring


def release_peer_buffers(group) -> None:
    """Free the peer buffers of the group's rings: every rank closes the
    neighbours' mappings, then (after a barrier of the group) frees its
    own. Every rank of the group calls it, or none."""
    rings = [k for k in _PEER_RINGS if k[0] is group]
    if not rings:
        return
    lib = _kernels.load()
    for k in rings:
        _PEER_RINGS[k].close(lib)
    dist.barrier(group=group)
    for k in rings:
        _PEER_RINGS.pop(k).free(lib)


def _check(name, t, shape, dtype, device):
    if t.device != device or t.dtype != dtype or tuple(t.shape) != shape \
            or not t.is_contiguous():
        raise ValueError(f"{KERNEL}: {name} must be a contiguous {dtype} "
                         f"tensor of shape {shape} on {device}, got "
                         f"{t.dtype} {tuple(t.shape)} on {t.device}")


def iterate(p: RegularizerParams, n_iters: int, degree: int, reach: int,
            n: int, vtx, slots, mesh: Mesh = None):
    """n_iters iterations over n partitions; same contract as
    iterate_plain. On CUDA tensors: one launch of the halo kernel, a
    cluster per partition (_plan), raising where the card cannot hold
    every cluster at once. Over a process group (mesh) vtx and slots are
    this rank's block: one launch over it, its ring's ends in the
    neighbour ranks' peer buffers (_PeerRing)."""
    dev = vtx[0].device
    if dev.type == "cpu":
        return iterate_plain(p, n_iters, degree, reach, n, vtx, slots, mesh)
    if dev.type != "cuda":
        raise ValueError(f"{KERNEL}: unsupported device {dev}")
    if grouped(mesh):
        n = 1
    R = vtx[0].shape[0]
    D = degree
    f32, i32 = torch.float32, torch.int32
    names = ("x", "w1", "w2", "x_bar", "w1_bar", "w2_bar", "data_term",
             "data_weight", "vtx_mask")
    for name, t in zip(names, vtx):
        _check(name, t, (R, LANES), f32, dev)
    for k, (name, t) in enumerate(zip(
            ("nbr", "rowflag", "sdx", "sdy", "sal", "sbe", "sgn", "srcf",
             "q1", "q2", "q3"), slots)):
        _check(name, t, (R * D, LANES), i32 if k < 2 else f32, dev)
    plan = _plan(dev.index, R * LANES, D, n, reach)
    parts = plan.clusters  # the kernel's ring: n * splits partitions
    # The kernel updates its state in place: work on copies.
    state = [t.clone() for t in vtx[:6]] + [t.clone() for t in slots[8:]]
    if grouped(mesh):
        ring = _peer_ring(mesh, dev, parts, reach)
        epoch = ring.epoch
        ring.epoch += n_iters + 1
        buffers = (ring.rx, ring.flags, ring.rx_lo, ring.flags_lo,
                   ring.rx_hi, ring.flags_hi)
    else:
        # This launch's own ring: flags zeroed for it, epoch 0.
        rx = torch.empty((parts, 2, 2, 3, reach, LANES), dtype=f32,
                         device=dev)
        flags = torch.zeros((parts, 2), dtype=i32, device=dev)
        epoch = 0
        buffers = (rx.data_ptr(), flags.data_ptr(), None, None, None, None)
    err = _kernels.load().halo_smoother(
        *(t.data_ptr() for t in state[:6]),
        *(t.data_ptr() for t in vtx[6:]),
        *(t.data_ptr() for t in slots[:8]),
        *(t.data_ptr() for t in state[6:]),
        *buffers, parts, R // parts, D, reach, n_iters, epoch, plan.cluster,
        plan.vertices_per_warp, p.step_x, p.step_q, p.theta, p.x_min,
        p.x_max, p.data_factor, torch.cuda.current_stream(dev).cuda_stream)
    _kernels.check_cuda_error(err, KERNEL)
    _kernels.LAUNCHES[KERNEL] += 1
    return tuple(state)


def smooth_sharded(p: RegularizerParams, g: nltgv2.GraphState, perm,
                   inv_perm, ranks_p, n_iters: int, degree: int, mesh: Mesh,
                   reach: int = 2) -> nltgv2.GraphState:
    """The banded layout of g, n_iters iterations over mesh.size
    partitions (the kernel on the card), and the write-back; the same
    GraphState contract as smoother_kernel.smooth. perm / inv_perm /
    ranks_p from smoother_kernel.rcm_order and perm_edge_ranks. Over a
    process group every rank passes the whole graph, iterates its own
    block of rows, and returns the whole result (the blocks'
    outputs all-gathered)."""
    V = g.x.shape[0]
    R = _rows(V)
    _check_blocks(R, mesh.size, reach)
    if g.x.device != mesh.device:
        raise ValueError(f"{KERNEL}: graph on {g.x.device}, mesh on "
                         f"{mesh.device}")
    lay = build_layout(g, perm, inv_perm, ranks_p, degree, reach)
    if grouped(mesh):
        rows, slot_rows = block_slice(R, mesh), block_slice(R * degree, mesh)
        outs = gather_rows(mesh, *iterate(
            p, n_iters, degree, reach, 1, [a[rows] for a in lay.vtx],
            [a[slot_rows] for a in lay.slots], mesh))
    else:
        outs = iterate(p, n_iters, degree, reach, mesh.size, lay.vtx,
                       lay.slots)
    return write_back(g, outs, inv_perm, lay.src_slot, lay.alive)
