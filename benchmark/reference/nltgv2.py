"""Plain reference of the NLTGV2-L1 smoother (the port's K1).

The energy and the Chambolle-Pock iteration of the reference FLaME
(nltgv2_l1_graph_regularizer.cc:89-174), written edge by edge: per edge
(i, j), i the lower vertex, dual ascent on (q1, q2, q3) with the
unit-ball projection, then per vertex the sum of the edges' primal
contributions, the L1 proximal step toward the data term, the clamp and
the theta-overrelaxed extragradient.

From the graph handed to the smoother it takes the vertex positions,
the primal and dual state, the data term and weights, the vertex mask
and the edge list; it works out again what the port derives from them:
alpha = 1 / edge length (floored at 1 px, 0 for a zero-length edge),
beta = 1, and which edges fit the [V, D] incidence tables (an edge whose
rank among its lower vertex's outgoing edges, or whose slot at its upper
vertex after that vertex's outgoing edges, reaches D is left out at both
ends; edges rank by length within a vertex).

Plain torch in any dtype (float64 for the reference, bfloat16 for the
control); imports nothing of the port.
"""

import torch


def _rank_within(keys, tie):
    """Rank of each element among equal keys, by ascending tie."""
    order = torch.argsort(tie, stable=True)
    order = order[torch.argsort(keys[order], stable=True)]
    ks = keys[order]
    first = torch.searchsorted(ks, ks, right=False)
    r = torch.empty_like(keys)
    r[order] = torch.arange(keys.shape[0], device=keys.device) - first
    return r


def kept_edges(edges, n_vertices: int, degree: int, length):
    """Edges (E, 2) lower-upper of one topology that fit `degree` slots
    per vertex: (E,) bool."""
    lo, hi = edges[:, 0].long(), edges[:, 1].long()
    src_rank = _rank_within(lo, length)
    n_src = torch.bincount(lo, minlength=n_vertices)
    dst_rank = n_src[hi] + _rank_within(hi, length)
    return (src_rank < degree) & (dst_rank < degree)


def smooth(g: dict, rp: dict, n_iters: int, degree: int,
           dtype=torch.float64) -> torch.Tensor:
    """n_iters iterations from the state in g; returns x (V,).

    g: pos (V, 2), x, w1, w2, x_bar, w1_bar, w2_bar, data_term,
    data_weight (V,), vtx_mask (V,) bool, edges (E, 2), edge_mask (E,)
    bool (the topology's rows are those with lower < upper), q1, q2, q3
    (E,). rp: data_factor, step_x, step_q, theta, x_min, x_max."""
    V = g["x"].shape[0]
    topo = g["edges"][:, 0] < g["edges"][:, 1]
    e = g["edges"][topo].long()
    lo, hi = e[:, 0], e[:, 1]
    pos = g["pos"].to(dtype)
    d = pos[lo] - pos[hi]
    length = torch.sqrt((d.double() ** 2).sum(1))
    live = g["edge_mask"][topo].bool() \
        & kept_edges(e, V, degree, length)
    one = torch.ones((), dtype=dtype, device=pos.device)
    alpha = torch.where(live & (length > 1e-6),
                        one / torch.clamp(length.to(dtype), min=1.0),
                        torch.zeros_like(one))
    beta = live.to(dtype)
    q1, q2, q3 = (torch.where(live, g[k][topo].to(dtype),
                              torch.zeros_like(one)) for k in ("q1", "q2",
                                                               "q3"))
    x, w1, w2, xb, w1b, w2b = (g[k].to(dtype) for k in (
        "x", "w1", "w2", "x_bar", "w1_bar", "w2_bar"))
    data = g["data_term"].to(dtype)
    weight = rp["data_factor"] * g["data_weight"].to(dtype)
    vmask = g["vtx_mask"].bool()
    dx, dy = d[:, 0], d[:, 1]
    sx, sq, theta = rp["step_x"], rp["step_q"], rp["theta"]
    x_min, x_max = rp["x_min"], rp["x_max"]

    def ball(q):
        return q / torch.clamp(q.abs(), min=1.0)

    for _ in range(n_iters):
        k1 = (xb[lo] - xb[hi]) - dx * w1b[lo] - dy * w2b[lo]
        q1 = ball(q1 + sq * alpha * k1)
        q2 = ball(q2 + sq * beta * (w1b[lo] - w1b[hi]))
        q3 = ball(q3 + sq * beta * (w2b[lo] - w2b[hi]))
        sxa, sxb = sx * alpha, sx * beta
        s_x = torch.zeros_like(x).index_add_(0, lo, -q1 * sxa) \
            .index_add_(0, hi, q1 * sxa)
        s_w1 = torch.zeros_like(x).index_add_(0, lo, q1 * sxa * dx
                                              - q2 * sxb) \
            .index_add_(0, hi, q2 * sxb)
        s_w2 = torch.zeros_like(x).index_add_(0, lo, q1 * sxa * dy
                                              - q3 * sxb) \
            .index_add_(0, hi, q3 * sxb)
        xt = x + s_x
        diff = xt - data
        th = sx * weight
        prox = torch.where(diff > th, xt - th,
                           torch.where(diff < -th, xt + th, data))
        nx = torch.where(vmask, torch.clamp(prox, x_min, x_max), x)
        nw1 = torch.where(vmask, w1 + s_w1, w1)
        nw2 = torch.where(vmask, w2 + s_w2, w2)
        xb = torch.clamp(nx + theta * (nx - x), x_min, x_max)
        w1b = nw1 + theta * (nw1 - w1)
        w2b = nw2 + theta * (nw2 - w2)
        x, w1, w2 = nx, nw1, nw2
    return x
