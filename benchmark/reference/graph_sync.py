"""Plain reference of the graph the smoother receives (graph sync).

After tracking, the port hands the frame's graph members (a mask over
the feature slots), their pixels and inverse depths in the current
frame, the graph scale and a triangulation to its post-Delaunay step,
which synchronises the solver graph before smoothing. What the
smoother then receives is stated by the reference FLaME
(flame.cc:1940-2163, syncGraph) with the port's defaults (no data
rescaling, unit data weights):

  * the vertices are the members, each at its current pixel, with the
    data term idepth / graph_scale;
  * the edges are those of the triangulation handed in whose two ends
    are members; with a synchronous topology that triangulation is the
    Delaunay triangulation of this frame's members, at the snapshot's
    1/32-pixel positions (the first member of each position kept), its
    triangles and edges cut at the configured capacities.

Plain torch and numpy in any dtype; imports nothing of the port.
"""

import numpy as np
import torch

XY_SCALE = 32.0  # the snapshot's fixed point: 1/32 pixel


def member_points(member, xy):
    """The members the host triangulates: (slots (n,), points (n, 2)
    float32 at 1/32 px), the first slot of each position kept."""
    m = torch.as_tensor(member).bool().cpu().numpy()
    slots = np.nonzero(m)[0]
    q = np.clip(np.floor(torch.as_tensor(xy).double().cpu().numpy()[slots]
                         * XY_SCALE + 0.5), 0, 65535).astype(np.int64)
    codes = (q[:, 0] << 16) | q[:, 1]
    _, first = np.unique(codes, return_index=True)
    keep = np.sort(first)
    return slots[keep], (q[keep] / XY_SCALE).astype(np.float32)


def triangulation_edges(tri_slots: np.ndarray, tri_cap: int, edge_cap: int,
                        n_vertices: int) -> set:
    """Edge codes lo * V + hi of a triangle list of slots, cut at the
    triangle and edge capacities in lo * V + hi order."""
    t = np.asarray(tri_slots, np.int64)[:tri_cap]
    a = t.reshape(-1)
    b = t[:, [1, 2, 0]].reshape(-1)
    codes = np.unique(np.minimum(a, b) * n_vertices + np.maximum(a, b))
    return set(codes[:edge_cap].tolist())


def edge_codes(edges, mask, n_vertices: int) -> set:
    e = torch.as_tensor(edges).long().cpu()
    m = torch.as_tensor(mask).bool().cpu()
    lo = torch.minimum(e[:, 0], e[:, 1])[m]
    hi = torch.maximum(e[:, 0], e[:, 1])[m]
    return set((lo * n_vertices + hi).tolist())


def data_term(idepth, member, graph_scale: float, dtype):
    """The members' data terms in dtype."""
    m = torch.as_tensor(member).bool()
    return torch.as_tensor(idepth).to(dtype)[m] / torch.tensor(
        graph_scale, dtype=dtype)
