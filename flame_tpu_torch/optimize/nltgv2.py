"""NLTGV2-L1 variational smoothing on fixed-capacity graphs.

Port of flame_tpu/optimize/nltgv2.py (reference
nltgv2_l1_graph_regularizer.cc). The energy is

    min_x  NLTGV2(x, w1, w2) + data_factor * sum_v weight_v |x_v - data_v|

with per-vertex primal state (x, w1, w2) coupled along edges by per-edge
duals (q1, q2, q3). One Chambolle-Pock iteration is dual ascent with a
unit-ball projection, primal descent, an L1 proximal step toward the data
term and a theta-overrelaxed extragradient.

The port keeps the JAX package's vertex-centric formulation
(_smooth_vertex_centric): every vertex holds a copy of each incident
edge's duals in its [V, D] incidence slots. Both endpoints update their
copy from the same operands in the same order, so the copies stay
bit-equal and no scatter is needed. The iteration body is split out
(iterate_plain) so that optimize/smoother_kernel.py can run the same
prologue and write-back around its CUDA kernel.
"""

from dataclasses import dataclass, replace
from typing import NamedTuple, Optional

import torch

from flame_tpu_torch.params import RegularizerParams


@dataclass
class GraphState:
    """Fixed-capacity SoA graph (same fields and layouts as the JAX
    GraphState)."""

    pos: torch.Tensor  # (V, 2) pixel positions
    x: torch.Tensor  # (V,) primal
    w1: torch.Tensor
    w2: torch.Tensor
    x_bar: torch.Tensor  # extragradient
    w1_bar: torch.Tensor
    w2_bar: torch.Tensor
    data_term: torch.Tensor
    data_weight: torch.Tensor
    vtx_mask: torch.Tensor  # bool
    edges: torch.Tensor  # (E, 2) int endpoint slots (0 when invalid)
    alpha: torch.Tensor  # 1/edge length (0 when invalid)
    beta: torch.Tensor  # 1.0 (0 when invalid)
    q1: torch.Tensor  # (E,) duals
    q2: torch.Tensor
    q3: torch.Tensor
    edge_mask: torch.Tensor  # bool
    inc_edge: Optional[torch.Tensor] = None  # (V, D) edge ids (0 pad)
    inc_sign: Optional[torch.Tensor] = None  # +1 src, -1 dst, 0 pad
    src_slot: Optional[torch.Tensor] = None  # (E,) flat V*D slot of the
    # edge's src entry (dst fallback, V*D when dropped) for the write-back

    def replace(self, **kw) -> "GraphState":
        return replace(self, **kw)


def empty(v_capacity: int, e_capacity: int, degree: int,
          device) -> GraphState:
    def z(*shape, dtype=torch.float32):
        return torch.zeros(shape, dtype=dtype, device=device)
    return GraphState(
        pos=z(v_capacity, 2), x=z(v_capacity), w1=z(v_capacity),
        w2=z(v_capacity), x_bar=z(v_capacity), w1_bar=z(v_capacity),
        w2_bar=z(v_capacity), data_term=z(v_capacity),
        data_weight=z(v_capacity), vtx_mask=z(v_capacity, dtype=torch.bool),
        edges=z(e_capacity, 2, dtype=torch.int64), alpha=z(e_capacity),
        beta=z(e_capacity), q1=z(e_capacity), q2=z(e_capacity),
        q3=z(e_capacity), edge_mask=z(e_capacity, dtype=torch.bool),
        inc_edge=z(v_capacity, degree, dtype=torch.int64),
        inc_sign=z(v_capacity, degree),
        src_slot=torch.full((e_capacity,), v_capacity * degree,
                            dtype=torch.int64, device=device))


class SlotTables(NamedTuple):
    """Loop-invariant per-slot state, (V, D) each, canonical orientation."""

    nbr: torch.Tensor  # int64 neighbour vertex of the slot's edge
    sdx: torch.Tensor  # pos[src].x - pos[dst].x of the slot's edge
    sdy: torch.Tensor
    sal: torch.Tensor  # alpha (0 on empty slots)
    sbe: torch.Tensor  # beta (0 on empty slots)
    sgn: torch.Tensor  # +1 src, -1 dst, 0 empty
    srcf: torch.Tensor  # 1.0 where the vertex is the edge's source


class SmoothState(NamedTuple):
    x: torch.Tensor  # (V,)
    w1: torch.Tensor
    w2: torch.Tensor
    x_bar: torch.Tensor
    w1_bar: torch.Tensor
    w2_bar: torch.Tensor
    q1: torch.Tensor  # (V, D) per-slot dual copies
    q2: torch.Tensor
    q3: torch.Tensor


def slot_prologue(g: GraphState):
    """Replicate the per-edge state into the [V, D] slots: returns
    (SlotTables, SmoothState) (nltgv2.py:396-432 of the JAX package)."""
    V = g.x.shape[0]
    e = g.inc_edge
    hasf = (g.inc_sign != 0.0).float()
    is_src = g.inc_sign > 0.0
    ii = g.edges[:, 0]
    jj = g.edges[:, 1]
    zero = torch.zeros_like(g.alpha)
    EM = torch.stack([g.pos[ii, 0] - g.pos[jj, 0], g.pos[ii, 1] - g.pos[jj, 1],
                      torch.where(g.edge_mask, g.alpha, zero),
                      torch.where(g.edge_mask, g.beta, zero),
                      g.q1, g.q2, g.q3], dim=1)
    S = EM[e]  # (V, D, 7)
    nbr = torch.clamp((ii + jj)[e] - torch.arange(V, device=e.device)[:, None],
                      0, V - 1)
    tables = SlotTables(
        nbr=nbr, sdx=S[..., 0], sdy=S[..., 1], sal=S[..., 2] * hasf,
        sbe=S[..., 3] * hasf,
        sgn=torch.where(is_src, 1.0, -1.0) * hasf, srcf=is_src.float())
    state = SmoothState(g.x, g.w1, g.w2, g.x_bar, g.w1_bar, g.w2_bar,
                        S[..., 4] * hasf, S[..., 5] * hasf, S[..., 6] * hasf)
    return tables, state


def _prox_l1(p: RegularizerParams, weight, x, data):
    """Soft-threshold toward the data term, clamped to [x_min, x_max]
    (reference .h:179-197); weight already includes data_factor."""
    diff = x - data
    thresh = p.step_x * weight
    new_x = torch.where(diff > thresh, x - thresh,
                        torch.where(diff < -thresh, x + thresh, data))
    return torch.clamp(new_x, p.x_min, p.x_max)


def _unit_ball(q):
    return q / torch.clamp(torch.abs(q), min=1.0)


def slot_step(p: RegularizerParams, is_src, sdx, sdy, sal, sbe, sgn, own,
              nbr, q):
    """One iteration's per-slot work in any slot layout: dual ascent with
    the unit-ball projection on the slot's copy of the duals, then the
    slot's primal contribution to its own vertex (reference .cc:89-142).
    own / nbr: the (x_bar, w1_bar, w2_bar) of the slot's vertex and of its
    neighbour, broadcastable to the slot tables; q: (q1, q2, q3). Returns
    (new q, (d_x, d_w1, d_w2))."""
    xb_s, w1b_s, w2b_s = own
    xb_n, w1b_n, w2b_n = nbr
    # Canonical (src i, dst j) orientation.
    xb_i = torch.where(is_src, xb_s, xb_n)
    xb_j = torch.where(is_src, xb_n, xb_s)
    w1b_i = torch.where(is_src, w1b_s, w1b_n)
    w1b_j = torch.where(is_src, w1b_n, w1b_s)
    w2b_i = torch.where(is_src, w2b_s, w2b_n)
    w2b_j = torch.where(is_src, w2b_n, w2b_s)

    qa = p.step_q * sal
    qb = p.step_q * sbe
    K1 = (xb_i - xb_j) - sdx * w1b_i - sdy * w2b_i
    q1 = _unit_ball(q[0] + qa * K1)
    q2 = _unit_ball(q[1] + qb * (w1b_i - w1b_j))
    q3 = _unit_ball(q[2] + qb * (w2b_i - w2b_j))

    sxa = p.step_x * sal
    sxb = p.step_x * sbe
    zero = torch.zeros_like(q1)
    d_x = -sgn * q1 * sxa
    d_w1 = torch.where(is_src, q1 * sxa * sdx, zero) - sgn * q2 * sxb
    d_w2 = torch.where(is_src, q1 * sxa * sdy, zero) - sgn * q3 * sxb
    return (q1, q2, q3), (d_x, d_w1, d_w2)


def vertex_step(p: RegularizerParams, x, w1, w2, sums, data, weight, vmask):
    """One iteration's per-vertex work: the summed slot contributions,
    proxL1 toward the data term, the vertex mask and the theta
    extragradient (reference .cc:156-174). weight = data_factor *
    data_weight; vmask bool. Returns (x, w1, w2, x_bar, w1_bar, w2_bar)."""
    nx = torch.where(vmask, _prox_l1(p, weight, x + sums[0], data), x)
    nw1 = torch.where(vmask, w1 + sums[1], w1)
    nw2 = torch.where(vmask, w2 + sums[2], w2)
    return (nx, nw1, nw2,
            torch.clamp(nx + p.theta * (nx - x), p.x_min, p.x_max),
            nw1 + p.theta * (nw1 - w1), nw2 + p.theta * (nw2 - w2))


def iterate_plain(p: RegularizerParams, t: SlotTables,
                  data: torch.Tensor, weight: torch.Tensor,
                  vmask: torch.Tensor, s: SmoothState,
                  n_iters: int) -> SmoothState:
    """n_iters vertex-centric iterations (nltgv2.py:438-481 of the JAX
    package); the plain counterpart of the CUDA smoother kernel.
    weight = data_factor * data_weight; vmask is bool."""
    is_src = t.srcf > 0.0
    x, w1, w2, xb, w1b, w2b, q1, q2, q3 = s
    for _ in range(n_iters):
        nb = torch.stack([xb, w1b, w2b], dim=1)[t.nbr]  # (V, D, 3)
        (q1, q2, q3), d = slot_step(
            p, is_src, t.sdx, t.sdy, t.sal, t.sbe, t.sgn,
            (xb[:, None], w1b[:, None], w2b[:, None]),
            (nb[..., 0], nb[..., 1], nb[..., 2]), (q1, q2, q3))
        x, w1, w2, xb, w1b, w2b = vertex_step(
            p, x, w1, w2, [v.sum(1) for v in d], data, weight, vmask)
    return SmoothState(x, w1, w2, xb, w1b, w2b, q1, q2, q3)


def unslot(g: GraphState, s: SmoothState) -> GraphState:
    """Write the state back; duals return through each edge's src slot
    (dst fallback). An edge with both entries dropped by degree overflow
    keeps its carried duals (nltgv2.py:486-503 of the JAX package)."""
    V, D = g.inc_edge.shape
    slotted = g.src_slot < V * D
    idx = torch.clamp(g.src_slot, max=V * D - 1)
    em = g.edge_mask

    def back(q, prev):
        vals = torch.where(slotted, q.reshape(-1)[idx], prev)
        return torch.where(em, vals, torch.zeros_like(vals))

    return g.replace(x=s.x, w1=s.w1, w2=s.w2, x_bar=s.x_bar,
                     w1_bar=s.w1_bar, w2_bar=s.w2_bar,
                     q1=back(s.q1, g.q1), q2=back(s.q2, g.q2),
                     q3=back(s.q3, g.q3))


def _smooth_vertex_centric(p: RegularizerParams, g: GraphState,
                           n_iters: int) -> GraphState:
    """The plain smoother: prologue, n_iters iterations, write-back."""
    tables, state = slot_prologue(g)
    state = iterate_plain(p, tables, g.data_term,
                          p.data_factor * g.data_weight, g.vtx_mask, state,
                          n_iters)
    return unslot(g, state)


def smoothness_cost(p: RegularizerParams, g: GraphState) -> torch.Tensor:
    ii = g.edges[:, 0]
    jj = g.edges[:, 1]
    dx = g.pos[ii, 0] - g.pos[jj, 0]
    dy = g.pos[ii, 1] - g.pos[jj, 1]
    c = (g.alpha * torch.abs(g.x[ii] - g.x[jj] - g.w1[ii] * dx
                             - g.w2[ii] * dy)
         + g.beta * torch.abs(g.w1[ii] - g.w1[jj])
         + g.beta * torch.abs(g.w2[ii] - g.w2[jj]))
    return p.data_factor * torch.sum(torch.where(g.edge_mask, c,
                                                 torch.zeros_like(c)))


def data_cost(p: RegularizerParams, g: GraphState) -> torch.Tensor:
    c = torch.abs((g.x - g.data_term) * g.data_weight)
    return torch.sum(torch.where(g.vtx_mask, c, torch.zeros_like(c)))


def total_cost(p: RegularizerParams, g: GraphState) -> torch.Tensor:
    """The reference's logged cost (flame.cc:2172-2177): data_factor times
    the raw smoothness plus the raw data term. It is not the functional
    the iteration minimizes (energy)."""
    return smoothness_cost(p, g) + data_cost(p, g)


def energy(p: RegularizerParams, g: GraphState) -> torch.Tensor:
    """The functional the iteration minimizes: raw NLTGV2 smoothness plus
    data_factor times the weighted L1 data term."""
    return smoothness_cost(p, g) / p.data_factor \
        + p.data_factor * data_cost(p, g)
