"""The NLTGV2-L1 smoother with its CUDA iteration kernel, and the
RCM-banded layout.

Counterpart of flame_tpu/optimize/pallas_smoother.py, in two halves:

  * iterate/smooth: the vertex-centric smoother. The loop-invariant slot
    prologue and the dual write-back are plain torch
    (nltgv2.slot_prologue / nltgv2.unslot), as they are XLA outside the
    Pallas call in the JAX package; all iterations are one cooperative
    launch of csrc/nltgv2_smoother.cu on the [V, D] tables, a warp per
    vertex (launch_plan). For tensors on the CPU the iterations run the
    plain version (nltgv2.iterate_plain). For CUDA tensors the kernel
    runs or the call raises; there is no fallback.
  * the banded layout the halo kernel (parallel/halo_kernel.py) runs on:
    the host's reverse Cuthill-McKee order (rcm_order) and edge ranks in
    that order (perm_edge_ranks), the device-side (R, 128) vertex and
    (R * D, 128) slot tables (build_layout) and the write-back
    (write_back). Vertex rank u lives at row u // 128, lane u % 128; its
    slot d at row (u // 128) * D + d. An edge whose endpoints lie more
    than `reach` rows apart, or that overflows `degree` slots at either
    end, is dropped on both sides for the frame and keeps its carried
    duals.
"""

import ctypes
import dataclasses
import functools
from typing import Callable, NamedTuple

import numpy as np
import torch

from flame_tpu_torch import _kernels, step_graph
from flame_tpu_torch.optimize import nltgv2, topology
from flame_tpu_torch.params import RegularizerParams

KERNEL = "nltgv2_smoother"
# The kernel's compile-time shape (csrc/nltgv2_smoother.cu): CTAs of 32
# warps, a lane per slot for up to 2 slots per lane, 1, 2, 4 or 8 vertices
# per warp, at most 8 (vertex, slot) groups per lane.
WARPS_PER_CTA = 32
MAX_DEGREE = 64
VERTICES_PER_WARP = (1, 2, 4, 8)
MAX_GROUPS = 8


class LaunchPlan(NamedTuple):
    slots_per_lane: int  # ceil(D / 32)
    vertices_per_warp: int
    grid: int  # CTAs, all resident at once


def launch_plan(V: int, D: int, n_sms: int,
                blocks_per_sm: Callable[[int, int], int]) -> LaunchPlan:
    """The fewest vertices per warp whose CTAs the card holds resident at
    once. blocks_per_sm(slots_per_lane, vertices_per_warp) is the CTAs one
    SM holds of that instantiation (its occupancy). Raises ValueError,
    naming the limit, for a V or D the kernel cannot hold."""
    if not 1 <= D <= MAX_DEGREE:
        raise ValueError(f"{KERNEL}: degree D={D} outside [1, {MAX_DEGREE}]")
    spl = -(-D // 32)
    most = 0
    for vpw in VERTICES_PER_WARP:
        if spl * vpw > MAX_GROUPS:
            break
        cap = n_sms * blocks_per_sm(spl, vpw) * WARPS_PER_CTA * vpw
        most = max(most, cap)
        if V <= cap:
            warps = -(-V // vpw)
            return LaunchPlan(spl, vpw, -(-warps // WARPS_PER_CTA))
    raise ValueError(
        f"{KERNEL}: V={V} vertices of degree {D} do not fit the card at "
        f"once: at most {most} ({n_sms} SMs, {WARPS_PER_CTA} warps per CTA, "
        f"at most {MAX_GROUPS // spl} vertices per warp)")


@functools.lru_cache(maxsize=None)
def _plan(device_index: int, V: int, D: int) -> LaunchPlan:
    lib = _kernels.load()
    props = torch.cuda.get_device_properties(device_index)

    def blocks_per_sm(spl, vpw):
        with torch.cuda.device(device_index):
            n = ctypes.c_int()
            _kernels.check_cuda_error(
                lib.nltgv2_smoother_occupancy(spl, vpw, ctypes.byref(n)),
                KERNEL)
        return n.value
    return launch_plan(V, D, props.multi_processor_count, blocks_per_sm)


def _check(name, t, shape, dtype, device):
    if t.device != device or t.dtype != dtype or tuple(t.shape) != shape \
            or not t.is_contiguous():
        raise ValueError(f"{KERNEL}: {name} must be a contiguous {dtype} "
                         f"tensor of shape {shape} on {device}, got "
                         f"{t.dtype} {tuple(t.shape)} on {t.device}")


def iterate(p: RegularizerParams, tables: nltgv2.SlotTables,
            data: torch.Tensor, weight: torch.Tensor, vmask: torch.Tensor,
            state: nltgv2.SmoothState, n_iters: int) -> nltgv2.SmoothState:
    """n_iters iterations; same contract as nltgv2.iterate_plain. On CUDA
    one launch for all of them (none for n_iters == 0)."""
    dev = data.device
    if dev.type == "cpu":
        return nltgv2.iterate_plain(p, tables, data, weight, vmask, state,
                                    n_iters)
    if dev.type != "cuda":
        raise ValueError(f"{KERNEL}: unsupported device {dev}")
    V, D = tables.nbr.shape
    f32 = torch.float32
    nbr = tables.nbr.int()
    slot_f = [t.contiguous() for t in tables[1:]]
    q_in = [t.contiguous() for t in state[6:]]
    for name, t, shape in [("nbr", nbr, (V, D))] + [
            (n, t, (V, D)) for n, t in zip(
                ("sdx", "sdy", "sal", "sbe", "sgn", "srcf", "q1", "q2", "q3"),
                slot_f + q_in)] + [
            (n, t, (V,)) for n, t in zip(
                ("x", "w1", "w2", "x_bar", "w1_bar", "w2_bar", "data",
                 "weight", "vmask"), (*state[:6], data, weight, vmask))]:
        dtype = {"nbr": torch.int32, "vmask": torch.bool}.get(name, f32)
        _check(name, t, shape, dtype, dev)
    plan = _plan(dev.index, V, D)
    if n_iters == 0:
        return state

    out = nltgv2.SmoothState(*(torch.empty_like(t) for t in state))
    scratch = torch.empty((2, V, 4), dtype=f32, device=dev)  # ping-pong bars
    barrier = torch.empty(64, dtype=torch.int32, device=dev)
    err = _kernels.load().nltgv2_smoother(
        *(t.data_ptr() for t in state[3:6]),
        *(t.data_ptr() for t in state[:3]),
        *(t.data_ptr() for t in q_in), nbr.data_ptr(),
        *(t.data_ptr() for t in slot_f),
        data.data_ptr(), weight.data_ptr(), vmask.data_ptr(),
        *(t.data_ptr() for t in out), scratch.data_ptr(), barrier.data_ptr(),
        V, D, n_iters, plan.vertices_per_warp,
        p.step_x, p.step_q, p.theta, p.x_min, p.x_max,
        torch.cuda.current_stream(dev).cuda_stream)
    _kernels.check_cuda_error(err, KERNEL)
    _kernels.LAUNCHES[KERNEL] += 1
    return out


def _smooth(p: RegularizerParams, g: nltgv2.GraphState,
            n_iters: int) -> nltgv2.GraphState:
    tables, state = nltgv2.slot_prologue(g)
    state = iterate(p, tables, g.data_term.contiguous(),
                    (p.data_factor * g.data_weight).contiguous(),
                    g.vtx_mask, state, n_iters)
    return nltgv2.unslot(g, state)


def smooth(p: RegularizerParams, g: nltgv2.GraphState,
           n_iters: int) -> nltgv2.GraphState:
    """Prologue, n_iters iterations (kernel on CUDA), write-back. While a
    step_graph.Steps is current (the post-Delaunay section on a CUDA
    device) the three replay one CUDA graph, K1's launch in it; the
    fields the write-back leaves are g's own."""
    steps = step_graph.current()
    if steps is None:
        return _smooth(p, g, n_iters)
    names = tuple(f.name for f in dataclasses.fields(g)
                  if getattr(g, f.name) is not None)

    def body(ins, scalars):
        return _smooth(p, nltgv2.GraphState(**dict(zip(names, ins))),
                       n_iters)
    return steps.run("smooth", body, [getattr(g, k) for k in names], (), p,
                     (), static=(names, n_iters))


# ---------------------------------------------------------------------------
# The RCM-banded layout.
# ---------------------------------------------------------------------------

LANES = 128


def _rows(v_cap: int) -> int:
    if v_cap % LANES:
        raise ValueError(f"the banded layout needs V % {LANES} == 0, got "
                         f"V={v_cap}")
    return v_cap // LANES


def rcm_order(edges: np.ndarray, n_valid_edges: int, v_cap: int,
              member: np.ndarray) -> np.ndarray:
    """Bandwidth-reducing vertex order: perm (V,) int32, rank -> vertex
    slot. Members in reverse Cuthill-McKee order over the edge graph,
    then the non-members in slot order."""
    perm_members = _rcm(edges[:n_valid_edges], v_cap, member)
    rest = np.nonzero(~member)[0]
    perm = np.concatenate([perm_members, rest]).astype(np.int32)
    assert perm.shape[0] == v_cap
    return perm


def _rcm(e: np.ndarray, v_cap: int, member: np.ndarray) -> np.ndarray:
    try:
        import scipy.sparse as sp
        from scipy.sparse.csgraph import reverse_cuthill_mckee
    except ImportError as exc:
        # The JAX package falls back to a BFS order, which is another
        # permutation: the layouts would no longer agree.
        raise RuntimeError("rcm_order needs scipy (scipy.sparse.csgraph."
                           "reverse_cuthill_mckee)") from exc
    nodes = np.nonzero(member)[0]
    n = nodes.shape[0]
    dense_id = np.full(v_cap, -1, np.int64)
    dense_id[nodes] = np.arange(n)
    a = dense_id[e[:, 0]]
    b = dense_id[e[:, 1]]
    ok = (a >= 0) & (b >= 0)
    A = sp.coo_matrix((np.ones(ok.sum(), np.int8), (a[ok], b[ok])),
                      shape=(n, n)).tocsr()
    A = A + A.T
    order = reverse_cuthill_mckee(A, symmetric_mode=True)
    return nodes[order].astype(np.int32)


def perm_edge_ranks(edges: np.ndarray, n_e: int, inv_perm: np.ndarray,
                    e_cap: int, degree: int, reach: int = 2,
                    tie=None) -> np.ndarray:
    """(E, 2) uint8 [src_rank, dst_rank] of each edge among its permuted
    lo / hi vertex's edges, src ranks first and dst ranks above them. An
    edge whose endpoints lie more than `reach` rows apart, or whose rank
    reaches `degree` at either end, gets 255 on both sides. tie: optional
    per-edge key ordering a vertex's edges (shortest first), so degree
    overflow drops the weakest couplings."""
    ranks = np.full((e_cap, 2), 255, np.uint8)
    if n_e == 0:
        return ranks
    lo_p = inv_perm[edges[:n_e, 0]].astype(np.int64)
    hi_p = inv_perm[edges[:n_e, 1]].astype(np.int64)
    v_cap = inv_perm.shape[0]
    band_ok = np.abs(lo_p // LANES - hi_p // LANES) <= reach
    sr = topology.rank_within(lo_p, tie)
    n_src = np.bincount(lo_p, minlength=v_cap)
    dr = n_src[hi_p] + topology.rank_within(hi_p, tie)
    ok = band_ok & (sr < degree) & (dr < degree)
    ranks[:n_e, 0] = np.where(ok, sr, 255).astype(np.uint8)
    ranks[:n_e, 1] = np.where(ok, dr, 255).astype(np.uint8)
    return ranks


class BandedLayout(NamedTuple):
    """build_layout's tables, R = V / 128 rows of 128 lanes."""

    vtx: tuple  # 9 x (R, 128) f32: x w1 w2 x_bar w1_bar w2_bar data_term
    # data_weight vtx_mask
    slots: tuple  # 11 x (R * D, 128): nbr lane (int32), rowflag (int32),
    # sdx sdy sal sbe sgn srcf q1 q2 q3 (f32)
    src_slot: torch.Tensor  # (E,) flat slot of the edge's src copy
    # (R * D * 128 when dropped)
    alive: torch.Tensor  # (E,) bool, the edge takes part this frame


def build_layout(g: nltgv2.GraphState, perm, inv_perm, ranks_p,
                 degree: int, reach: int = 2) -> BandedLayout:
    """The banded tables of g (pallas_smoother.build_layout of the JAX
    package). perm (V,) rank -> vertex slot, inv_perm its inverse,
    ranks_p (E, 2) from perm_edge_ranks. A slot's rowflag is the row
    offset of its neighbour plus reach (0 .. 2 * reach), its nbr the
    neighbour's lane; an empty slot has rowflag reach, nbr 0 and zero
    weights. src slots carry sgn +1 and srcf 1, dst slots -1 and 0."""
    V = g.x.shape[0]
    D = degree
    R = _rows(V)
    dev = g.x.device
    perm = perm.long()
    inv_perm = inv_perm.long()

    def vperm(a):
        return a[perm].reshape(R, LANES).contiguous()

    vtx = tuple(vperm(a) for a in (
        g.x, g.w1, g.w2, g.x_bar, g.w1_bar, g.w2_bar, g.data_term,
        g.data_weight, g.vtx_mask.float()))

    lo = g.edges[:, 0].long()
    hi = g.edges[:, 1].long()
    lo_p = inv_perm[lo]
    hi_p = inv_perm[hi]
    band_ok = torch.abs(lo_p // LANES - hi_p // LANES) <= reach
    sr = ranks_p[:, 0].long()
    dr = ranks_p[:, 1].long()
    alive = g.edge_mask & band_ok & (sr < D) & (dr < D)

    d = g.pos[lo] - g.pos[hi]
    zero = torch.zeros_like(d[:, 0])
    alpha_e = torch.where(alive, g.alpha, zero)
    beta_e = torch.where(alive, g.beta, zero)

    def flat_slot(u, dd):
        return ((u // LANES) * D + dd) * LANES + (u % LANES)

    sent = R * D * LANES
    slot_s = torch.where(alive, flat_slot(lo_p, sr), sent)
    slot_d = torch.where(alive, flat_slot(hi_p, dr), sent)
    rf_s = (hi_p // LANES) - (lo_p // LANES) + reach
    rf_d = (lo_p // LANES) - (hi_p // LANES) + reach

    # Row `sent` catches every dropped edge and is cut off below.
    ibuf = torch.zeros((sent + 1, 2), dtype=torch.int32, device=dev)
    ibuf[:, 1] = reach
    ibuf[slot_s] = torch.stack([hi_p % LANES, rf_s], dim=1).int()
    ibuf[slot_d] = torch.stack([lo_p % LANES, rf_d], dim=1).int()
    one = alive.float()
    fbuf = torch.zeros((sent + 1, 9), dtype=torch.float32, device=dev)
    fbuf[slot_s] = torch.stack([d[:, 0], d[:, 1], alpha_e, beta_e, one, one,
                                g.q1, g.q2, g.q3], dim=1)
    fbuf[slot_d] = torch.stack([d[:, 0], d[:, 1], alpha_e, beta_e, -one,
                                zero, g.q1, g.q2, g.q3], dim=1)
    ints = [ibuf[:-1, k].reshape(R * D, LANES).contiguous() for k in (0, 1)]
    floats = [fbuf[:-1, k].reshape(R * D, LANES).contiguous()
              for k in range(9)]
    return BandedLayout(vtx=tuple(vtx), slots=tuple(ints + floats),
                        src_slot=slot_s, alive=alive)


def write_back(g: nltgv2.GraphState, outs, inv_perm, src_slot,
               alive) -> nltgv2.GraphState:
    """g with the smoother's outputs in slot order: outs = (x, w1, w2,
    x_bar, w1_bar, w2_bar) in rank order, any shape of V elements, then
    (q1, q2, q3) in any slot layout that src_slot indexes flat. A dropped
    edge keeps its carried duals; duals outside edge_mask are zero."""
    V = g.x.shape[0]
    inv_perm = inv_perm.long()
    x, w1, w2, xb, w1b, w2b = [o.reshape(V)[inv_perm] for o in outs[:6]]
    em = g.edge_mask

    def back(qs, prev):
        flat = torch.nn.functional.pad(qs.reshape(-1), (0, 1))
        q = torch.where(alive, flat[src_slot], prev)
        return torch.where(em, q, torch.zeros_like(q))

    return g.replace(x=x, w1=w1, w2=w2, x_bar=xb, w1_bar=w1b, w2_bar=w2b,
                     q1=back(outs[6], g.q1), q2=back(outs[7], g.q2),
                     q3=back(outs[8], g.q3))
