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

The JAX package's other formulations are here too, as plain torch: the
field-per-field step (segment-sum or incidence-gather primal), the
stacked loop of two row gathers and two segment sums per iteration that
parallel/sharding.py's edge-sharded smoother splits over partitions,
smooth(mode=...) over all three, and the incidence tables built on the
host. The production smoother stays optimize/smoother_kernel.py (K1).
"""

from dataclasses import dataclass, replace
from typing import NamedTuple, Optional

import numpy as np
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


def build_incidence(edges: np.ndarray, edge_mask: np.ndarray,
                    n_vertices: int, max_degree: int):
    """Host-side per-vertex incident-edge table: (inc_edge (V, D) int32,
    inc_sign (V, D) float32, +1 src, -1 dst, 0 pad). Entries past
    max_degree are dropped (the JAX package's build_incidence)."""
    V, D = n_vertices, max_degree
    inc_edge = np.zeros((V, D), np.int32)
    inc_sign = np.zeros((V, D), np.float32)
    eidx = np.nonzero(edge_mask)[0]
    if eidx.shape[0] == 0:
        return inc_edge, inc_sign
    # Sort the (vertex, edge id, sign) triples by vertex, rank them within
    # each vertex and keep the ranks below D.
    verts = np.concatenate([edges[eidx, 0], edges[eidx, 1]])
    eids = np.concatenate([eidx, eidx]).astype(np.int32)
    signs = np.concatenate([np.ones(eidx.shape[0], np.float32),
                            -np.ones(eidx.shape[0], np.float32)])
    order = np.argsort(verts, kind="stable")
    vs = verts[order]
    rank = np.arange(vs.shape[0]) - np.searchsorted(vs, vs, side="left")
    keep = rank < D
    inc_edge[vs[keep], rank[keep]] = eids[order][keep]
    inc_sign[vs[keep], rank[keep]] = signs[order][keep]
    return inc_edge, inc_sign


def build_src_slot(inc_edge: np.ndarray, inc_sign: np.ndarray,
                   e_capacity: int) -> np.ndarray:
    """Host-side: each edge's flat (V * D) slot of its src incidence entry
    (dst fallback, V * D when both were dropped), for the vertex-centric
    smoother's dual write-back."""
    V, D = inc_edge.shape
    src_slot = np.full(e_capacity, V * D, np.int32)
    flat_e = inc_edge.reshape(-1)
    flat_s = inc_sign.reshape(-1)
    dst = np.nonzero(flat_s < 0)[0]
    src_slot[flat_e[dst]] = dst
    src = np.nonzero(flat_s > 0)[0]
    src_slot[flat_e[src]] = src
    return src_slot


# ---------------------------------------------------------------------------
# The field-per-field iteration (the reference's semantics, op for op).
# ---------------------------------------------------------------------------


def _edge_geometry(g: GraphState):
    ii = g.edges[:, 0]
    jj = g.edges[:, 1]
    return ii, jj, g.pos[ii, 0] - g.pos[jj, 0], g.pos[ii, 1] - g.pos[jj, 1]


def _segment_sum(vals: torch.Tensor, idx: torch.Tensor, n: int):
    return vals.new_zeros((n,) + vals.shape[1:]).index_add_(0, idx, vals)


def _dual_step(p: RegularizerParams, g: GraphState) -> GraphState:
    """Dual ascent with the unit-ball projection (reference .cc:89-114)."""
    ii, jj, dx, dy = _edge_geometry(g)
    K1x = g.alpha * (g.x_bar[ii] - g.x_bar[jj] - dx * g.w1_bar[ii]
                     - dy * g.w2_bar[ii])
    K2x = g.beta * (g.w1_bar[ii] - g.w1_bar[jj])
    K3x = g.beta * (g.w2_bar[ii] - g.w2_bar[jj])
    m = g.edge_mask
    zero = torch.zeros_like(K1x)
    return g.replace(
        q1=torch.where(m, _unit_ball(g.q1 + p.step_q * K1x), zero),
        q2=torch.where(m, _unit_ball(g.q2 + p.step_q * K2x), zero),
        q3=torch.where(m, _unit_ball(g.q3 + p.step_q * K3x), zero))


def _primal_edge_terms(p: RegularizerParams, g: GraphState):
    """Per-edge primal-descent deltas to the source (i) and target (j)
    vertex (reference .cc:116-142): (ii, jj, d_x_i, d_x_j, d_w1_i,
    d_w1_j, d_w2_i, d_w2_j)."""
    ii, jj, dx, dy = _edge_geometry(g)
    sxa = p.step_x * g.alpha
    sxb = p.step_x * g.beta
    return (ii, jj, -g.q1 * sxa, g.q1 * sxa, g.q1 * sxa * dx - g.q2 * sxb,
            g.q2 * sxb, g.q1 * sxa * dy - g.q3 * sxb, g.q3 * sxb)


def _masked_prox(p: RegularizerParams, g: GraphState, x, w1,
                 w2) -> GraphState:
    x = _prox_l1(p, p.data_factor * g.data_weight, x, g.data_term)
    m = g.vtx_mask
    return g.replace(x=torch.where(m, x, g.x), w1=torch.where(m, w1, g.w1),
                     w2=torch.where(m, w2, g.w2))


def _primal_step_segment(p: RegularizerParams, g: GraphState) -> GraphState:
    """Primal descent by segment sums over the edges."""
    V = g.x.shape[0]
    ii, jj, d_x_i, d_x_j, d_w1_i, d_w1_j, d_w2_i, d_w2_j = \
        _primal_edge_terms(p, g)
    return _masked_prox(
        p, g,
        g.x + _segment_sum(d_x_i, ii, V) + _segment_sum(d_x_j, jj, V),
        g.w1 + _segment_sum(d_w1_i, ii, V) + _segment_sum(d_w1_j, jj, V),
        g.w2 + _segment_sum(d_w2_i, ii, V) + _segment_sum(d_w2_j, jj, V))


def _primal_step_incidence(p: RegularizerParams, g: GraphState) -> GraphState:
    """Primal descent by gathers over the [V, D] incidence table: a
    vertex with incident edge e of sign s takes -s q1 sxa on x and, as the
    edge's source only, q1 sxa dx (dy) on w1 (w2), minus s q2 (q3) sxb."""
    e = g.inc_edge
    s = g.inc_sign
    is_src = s > 0
    _, _, dx_e, dy_e = _edge_geometry(g)
    q1, q2, q3 = g.q1[e], g.q2[e], g.q3[e]
    sxa = p.step_x * g.alpha[e]
    sxb = p.step_x * g.beta[e]
    zero = torch.zeros_like(q1)
    d_x = -s * q1 * sxa
    d_w1 = torch.where(is_src, q1 * sxa * dx_e[e], zero) - s * q2 * sxb
    d_w2 = torch.where(is_src, q1 * sxa * dy_e[e], zero) - s * q3 * sxb
    return _masked_prox(p, g, g.x + d_x.sum(1), g.w1 + d_w1.sum(1),
                        g.w2 + d_w2.sum(1))


def _extragradient_step(p: RegularizerParams, g: GraphState, x_prev,
                        w1_prev, w2_prev) -> GraphState:
    """Theta over-relaxation; x_bar clamped to [x_min, x_max], the w bars
    not (reference .cc:156-174)."""
    return g.replace(
        x_bar=torch.clamp(g.x + p.theta * (g.x - x_prev), p.x_min, p.x_max),
        w1_bar=g.w1 + p.theta * (g.w1 - w1_prev),
        w2_bar=g.w2 + p.theta * (g.w2 - w2_prev))


def step(p: RegularizerParams, g: GraphState,
         use_incidence: bool = False) -> GraphState:
    """One full Chambolle-Pock iteration (reference .cc:33-49); the primal
    step by segment sums or, with use_incidence, by the incidence table."""
    x_prev, w1_prev, w2_prev = g.x, g.w1, g.w2
    g = _dual_step(p, g)
    g = (_primal_step_incidence if use_incidence
         else _primal_step_segment)(p, g)
    return _extragradient_step(p, g, x_prev, w1_prev, w2_prev)


# ---------------------------------------------------------------------------
# The stacked iteration: two row gathers and two segment sums per
# iteration, over any block of edge rows (parallel/sharding.py splits the
# rows over partitions and sums their vertex contributions).
# ---------------------------------------------------------------------------


class EdgeTerms(NamedTuple):
    """Loop-invariant per-edge quantities of a block of edge rows."""

    ii: torch.Tensor  # source vertex
    jj: torch.Tensor  # target vertex
    dx: torch.Tensor  # pos[ii] - pos[jj]
    dy: torch.Tensor
    sxa: torch.Tensor  # step_x * alpha (0 on invalid edges)
    sxb: torch.Tensor  # step_x * beta
    qa: torch.Tensor  # step_q * alpha
    qb: torch.Tensor  # step_q * beta


def edge_terms(p: RegularizerParams, g: GraphState,
               rows: slice = slice(None)) -> EdgeTerms:
    """The EdgeTerms of g's edge rows `rows`."""
    ii = g.edges[rows, 0]
    jj = g.edges[rows, 1]
    em = g.edge_mask[rows]
    zero = torch.zeros_like(g.alpha[rows])
    a = torch.where(em, g.alpha[rows], zero)
    b = torch.where(em, g.beta[rows], zero)
    return EdgeTerms(ii, jj, g.pos[ii, 0] - g.pos[jj, 0],
                     g.pos[ii, 1] - g.pos[jj, 1], p.step_x * a, p.step_x * b,
                     p.step_q * a, p.step_q * b)


def edge_step(t: EdgeTerms, VB: torch.Tensor, q):
    """One iteration's per-edge work on the stacked bars VB (V, 3) =
    (x_bar, w1_bar, w2_bar): the dual ascent with the projection
    (reference .cc:89-114) and the (E, 3) primal contributions to each
    edge's source (Ci) and target (Cj) (.cc:116-142). q: (q1, q2, q3) of
    the block's rows. Returns (new q, Ci, Cj)."""
    gi = VB[t.ii]
    gj = VB[t.jj]
    K1 = (gi[:, 0] - gj[:, 0]) - t.dx * gi[:, 1] - t.dy * gi[:, 2]
    q1 = _unit_ball(q[0] + t.qa * K1)
    q2 = _unit_ball(q[1] + t.qb * (gi[:, 1] - gj[:, 1]))
    q3 = _unit_ball(q[2] + t.qb * (gi[:, 2] - gj[:, 2]))
    Ci = torch.stack([-q1 * t.sxa, q1 * t.sxa * t.dx - q2 * t.sxb,
                      q1 * t.sxa * t.dy - q3 * t.sxb], dim=1)
    Cj = torch.stack([q1 * t.sxa, q2 * t.sxb, q3 * t.sxb], dim=1)
    return (q1, q2, q3), Ci, Cj


def stacked_iterations(p: RegularizerParams, g: GraphState, t: EdgeTerms,
                       q, n_iters: int, combine):
    """n_iters stacked iterations over the edge rows of t, whose duals are
    q. combine(Ci, Cj) returns the (V, 3) sums of the contributions at
    each vertex over all of the graph's edges; the vertex update that
    follows is the same everywhere. Returns (x, w1, w2, VB, q)."""
    weight = p.data_factor * g.data_weight
    x, w1, w2 = g.x, g.w1, g.w2
    VB = torch.stack([g.x_bar, g.w1_bar, g.w2_bar], dim=1)
    for _ in range(n_iters):
        q, Ci, Cj = edge_step(t, VB, q)
        x, w1, w2, *bars = vertex_step(p, x, w1, w2,
                                       combine(Ci, Cj).unbind(1),
                                       g.data_term, weight, g.vtx_mask)
        VB = torch.stack(bars, dim=1)
    return x, w1, w2, VB, q


def stacked_result(g: GraphState, x, w1, w2, VB, q) -> GraphState:
    """The GraphState after stacked_iterations; duals of invalid edges
    are 0."""
    em = g.edge_mask
    zero = torch.zeros_like(g.q1)
    return g.replace(x=x, w1=w1, w2=w2, x_bar=VB[:, 0], w1_bar=VB[:, 1],
                     w2_bar=VB[:, 2], q1=torch.where(em, q[0], zero),
                     q2=torch.where(em, q[1], zero),
                     q3=torch.where(em, q[2], zero))


def _smooth_stacked(p: RegularizerParams, g: GraphState,
                    n_iters: int) -> GraphState:
    """n_iters stacked iterations over all edges. The JAX package packs
    the bars into (V, 8) rows for the TPU's lanes; here they are (V, 3)."""
    V = g.x.shape[0]
    t = edge_terms(p, g)

    def combine(Ci, Cj):
        return _segment_sum(Ci, t.ii, V).index_add_(0, t.jj, Cj)
    return stacked_result(g, *stacked_iterations(
        p, g, t, (g.q1, g.q2, g.q3), n_iters, combine))


SMOOTH_MODES = ("vertex", "stacked", "step")


def smooth(p: RegularizerParams, g: GraphState, n_iters: int,
           use_incidence: bool = False, stacked: bool = True,
           mode: Optional[str] = None) -> GraphState:
    """n_iters iterations in one of the equivalent formulations: "vertex"
    (the vertex-centric loop; needs the incidence tables and src_slot),
    "stacked" (two row gathers and two segment sums per iteration) or
    "step" (field per field, the primal by incidence with
    use_incidence). mode None: "stacked" if stacked else "step". Plain
    torch: the production smoother is smoother_kernel.smooth (K1)."""
    if mode is None:
        mode = "stacked" if stacked else "step"
    if mode == "vertex":
        return _smooth_vertex_centric(p, g, n_iters)
    if mode == "stacked":
        return _smooth_stacked(p, g, n_iters)
    if mode != "step":
        raise ValueError(f"unknown smooth mode {mode!r}; one of "
                         f"{SMOOTH_MODES}")
    for _ in range(n_iters):
        g = step(p, g, use_incidence=use_incidence)
    return g


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
