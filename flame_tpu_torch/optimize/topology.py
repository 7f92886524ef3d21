"""Graph topology: dual carry-over, edge weights and the [V, D]
incidence tables.

Port of flame_tpu/optimize/topology.py (build_edge_ranks and rank_within
are the same numpy host code). On the main path (from_edges) the host
supplies the unique edges, canonical (lo, hi) and sorted by lo*V+hi, and
their slot ranks; the device carries duals over for vertex pairs that
survive the retriangulation (reference flame.cc:2094-2104), computes
alpha = 1/length and scatters the incidence tables from the ranks.
from_triangles derives the edges from a padded triangle array on the
device and ranks them there.
"""

from typing import NamedTuple, Optional

import numpy as np
import torch

# Edge-length floor (pixels) for alpha = 1/length: keeps the
# Chambolle-Pock step condition when two features drift onto one pixel.
MIN_EDGE_LENGTH = 1.0


class Topology(NamedTuple):
    edges: torch.Tensor  # (E, 2) int64 canonical (lo, hi), sorted by code
    alpha: torch.Tensor  # (E,) 1/length, 0 when invalid
    edge_mask: torch.Tensor  # (E,) bool
    q1: torch.Tensor  # (E,) carried duals (0 for new edges)
    q2: torch.Tensor
    q3: torch.Tensor
    inc_edge: torch.Tensor  # (V, D) int64
    inc_sign: torch.Tensor  # (V, D) float32
    n_edges: int
    src_slot: torch.Tensor  # (E,) flat V*D slot of the edge's src entry


def _build_incidence_from_ranks(lo_e, hi_e, edge_mask, ranks, e_cap, v_cap,
                                degree):
    """Scatter-only incidence build from host slot ranks (E, 2)
    [src_rank, dst_slot_rank]. Degree overflow drops the edge on both
    sides, keeping the primal update adjoint to the dual one."""
    sr = ranks[:, 0].long()
    dr = ranks[:, 1].long()
    keep = edge_mask & (sr < degree) & (dr < degree)
    sentinel = v_cap * degree
    slot_s = torch.where(keep, lo_e * degree + sr, sentinel)
    slot_d = torch.where(keep, hi_e * degree + dr, sentinel)
    dev = lo_e.device
    eids = torch.arange(e_cap, device=dev)
    inc_edge = torch.zeros(sentinel + 1, dtype=torch.int64, device=dev)
    inc_edge[slot_s] = eids
    inc_edge[slot_d] = eids
    inc_sign = torch.zeros(sentinel + 1, dtype=torch.float32, device=dev)
    one = keep.float()
    inc_sign[slot_s] = one
    inc_sign[slot_d] = -one
    # Every dropped edge wrote the sentinel entry; it is cut off below.
    return (inc_edge[:-1].reshape(v_cap, degree),
            inc_sign[:-1].reshape(v_cap, degree),
            torch.where(keep, slot_s, sentinel))


def _build_incidence_device(lo_e, hi_e, edge_mask, e_cap, v_cap, degree):
    """The [V, D] incidence tables and src_slot without host ranks: the 2E
    (vertex, edge, sign) entries sorted by vertex (stably, so by edge id
    within a vertex), ranked within each vertex, kept below degree. An
    edge that overflows either end is dropped at both, as in
    _build_incidence_from_ranks."""
    dev = lo_e.device
    sentinel = v_cap * degree
    eids = torch.arange(e_cap, device=dev).repeat(2)
    signs = torch.cat([torch.ones(e_cap, device=dev),
                       -torch.ones(e_cap, device=dev)])
    vkey = torch.where(torch.cat([edge_mask, edge_mask]),
                       torch.cat([lo_e, hi_e]), v_cap)
    vs, order = torch.sort(vkey, stable=True)
    rankv = torch.arange(2 * e_cap, device=dev) \
        - torch.searchsorted(vs, vs)
    eo = eids[order]
    so = signs[order]
    entry_ok = (rankv < degree) & (vs < v_cap)

    def per_edge(sel):
        ok = torch.zeros(e_cap + 1, dtype=torch.bool, device=dev)
        ok[torch.where(sel, eo, e_cap)] = entry_ok
        return ok[:e_cap]
    keep = entry_ok & (per_edge(so > 0) & per_edge(so < 0))[eo]
    islot = torch.where(keep, vs * degree + rankv, sentinel)
    inc_edge = torch.zeros(sentinel + 1, dtype=torch.int64, device=dev)
    inc_edge[islot] = eo
    inc_sign = torch.zeros(sentinel + 1, device=dev)
    inc_sign[islot] = so
    # dst entries first, src entries override; each edge has at most one
    # of each, and the dropped ones write the cut-off sentinel row.
    src_slot = torch.full((e_cap + 1,), sentinel, dtype=torch.int64,
                          device=dev)
    src_slot[torch.where(keep & (so < 0), eo, e_cap)] = islot
    src_slot[torch.where(keep & (so > 0), eo, e_cap)] = islot
    return (inc_edge[:-1].reshape(v_cap, degree),
            inc_sign[:-1].reshape(v_cap, degree), src_slot[:e_cap])


def _alpha(pos, lo_e, hi_e, edge_mask):
    """1 / pixel length of each edge (reference flame.cc:2102), floored at
    MIN_EDGE_LENGTH; 0 for invalid or zero-length edges."""
    d = pos[lo_e] - pos[hi_e]
    length = torch.sqrt(torch.sum(d * d, dim=1))
    return torch.where(edge_mask & (length > 1e-6),
                       1.0 / torch.clamp(length, min=MIN_EDGE_LENGTH),
                       torch.zeros_like(length))


def _carry(codes, edge_mask, prev_edges, prev_edge_mask, prev_qs, v_cap,
           e_cap):
    """The duals of the vertex pairs that were edges before (0 for new
    ones), by binary search of the new codes in the previous codes."""
    big = v_cap * v_cap
    prev = prev_edges.long()
    prev_codes = torch.where(prev_edge_mask, prev[:, 0] * v_cap + prev[:, 1],
                             big)
    # The previous mask has holes wherever an edge lost a member vertex
    # (async topology lags membership), so its codes are sorted only
    # after the holes move to the end. Their duals are zero (unslot).
    prev_sorted, prev_order = torch.sort(prev_codes)
    posn = torch.clamp(torch.searchsorted(prev_sorted, codes), max=e_cap - 1)
    match = (prev_sorted[posn] == codes) & edge_mask
    src = prev_order[posn]
    return [torch.where(match, q[src], torch.zeros_like(q)) for q in prev_qs]


def _no_incidence(v_cap, e_cap, degree, dev):
    """Zero tables and every src_slot at the V * D sentinel."""
    return (torch.zeros((v_cap, degree), dtype=torch.int64, device=dev),
            torch.zeros((v_cap, degree), device=dev),
            torch.full((e_cap,), v_cap * degree, dtype=torch.int64,
                       device=dev))


def rank_within(keys: np.ndarray, tie=None) -> np.ndarray:
    """Rank of each element among equal keys; with `tie`, ranked by
    ascending tie value within a key group."""
    n = keys.shape[0]
    order = (np.argsort(keys, kind="stable") if tie is None
             else np.lexsort((tie, keys)))
    ks = keys[order]
    first = np.searchsorted(ks, ks, side="left")
    r = np.empty(n, np.int64)
    r[order] = np.arange(n) - first
    return r


def build_edge_ranks(edges_sorted: np.ndarray, n_vertices: int,
                     e_cap: int, tie=None) -> np.ndarray:
    """(e_cap, 2) uint8 [src_rank, dst_slot_rank] (255-saturated): the
    src rank among the lo vertex's outgoing edges and n_src(hi) + the
    rank among hi's incoming edges, so the two ranges never overlap."""
    n_e = edges_sorted.shape[0]
    ranks = np.zeros((e_cap, 2), np.uint8)
    if n_e == 0:
        return ranks
    lo = edges_sorted[:, 0].astype(np.int64)
    hi = edges_sorted[:, 1].astype(np.int64)
    src_rank = rank_within(lo, tie)
    n_src = np.bincount(lo, minlength=n_vertices)
    dst_slot_rank = n_src[hi] + rank_within(hi, tie)
    ranks[:n_e, 0] = np.minimum(src_rank, 255)
    ranks[:n_e, 1] = np.minimum(dst_slot_rank, 255)
    return ranks


def from_edges(edges_in: torch.Tensor, n_edges: int, pos: torch.Tensor,
               prev_edges: torch.Tensor, prev_edge_mask: torch.Tensor,
               prev_q1: torch.Tensor, prev_q2: torch.Tensor,
               prev_q3: torch.Tensor, e_cap: int, v_cap: int, degree: int,
               ranks: Optional[torch.Tensor]) -> Topology:
    """Topology from the host edge list (padded to e_cap); n_edges a
    Python int, or a (1,) device scalar (a CUDA graph's), kept as given.
    Duals carry over by binary search of the new codes in the previous
    sorted codes.
    ranks None skips the incidence tables (zero tables, every src_slot
    V * D): the banded smoothers build their own layout from RCM ranks,
    which are not incidence ranks."""
    dev = pos.device
    edges = edges_in.long()
    edge_mask = torch.arange(e_cap, device=dev) < n_edges
    zero = torch.zeros_like(edges[:, 0])
    lo_e = torch.where(edge_mask, edges[:, 0], zero)
    hi_e = torch.where(edge_mask, edges[:, 1], zero)
    codes = torch.where(edge_mask, lo_e * v_cap + hi_e, v_cap * v_cap)
    q1, q2, q3 = _carry(codes, edge_mask, prev_edges, prev_edge_mask,
                        (prev_q1, prev_q2, prev_q3), v_cap, e_cap)
    if ranks is None:
        inc = _no_incidence(v_cap, e_cap, degree, dev)
    else:
        inc = _build_incidence_from_ranks(lo_e, hi_e, edge_mask, ranks,
                                          e_cap, v_cap, degree)
    return Topology(edges=torch.stack([lo_e, hi_e], dim=1),
                    alpha=_alpha(pos, lo_e, hi_e, edge_mask),
                    edge_mask=edge_mask, q1=q1, q2=q2, q3=q3,
                    inc_edge=inc[0], inc_sign=inc[1],
                    n_edges=(n_edges if isinstance(n_edges, torch.Tensor)
                             else int(n_edges)),
                    src_slot=inc[2])


def from_triangles(tris: torch.Tensor, n_tris: int, pos: torch.Tensor,
                   prev_edges: torch.Tensor, prev_edge_mask: torch.Tensor,
                   prev_q1: torch.Tensor, prev_q2: torch.Tensor,
                   prev_q3: torch.Tensor, e_cap: int, v_cap: int,
                   degree: int, build_incidence: bool = True) -> Topology:
    """Topology from a padded (T, 3) triangle array of vertex slots, the
    first n_tris real: the unique undirected edges in lo*V+hi order
    (overflow past e_cap dropped), alpha, carried duals and, with
    build_incidence, the incidence tables ranked on the device. n_edges
    is read back to the host."""
    dev = pos.device
    T = tris.shape[0]
    tris = tris.long()
    big = v_cap * v_cap
    a = torch.cat([tris[:, 0], tris[:, 1], tris[:, 2]])
    b = torch.cat([tris[:, 1], tris[:, 2], tris[:, 0]])
    m3 = (torch.arange(T, device=dev) < n_tris).repeat(3)
    code = torch.where(m3, torch.minimum(a, b) * v_cap + torch.maximum(a, b),
                       big)
    scode, _ = torch.sort(code)
    first = torch.cat([torch.ones(1, dtype=torch.bool, device=dev),
                       scode[1:] != scode[:-1]]) & (scode < big)
    rank = torch.cumsum(first.long(), dim=0) - 1
    slot = torch.where(first & (rank < e_cap), rank, e_cap)
    codes = torch.full((e_cap + 1,), big, dtype=torch.int64, device=dev)
    codes[slot] = scode  # non-first and overflow rows land in row e_cap
    codes = codes[:e_cap]
    edge_mask = codes < big
    zero = torch.zeros_like(codes)
    lo_e = torch.where(edge_mask, codes // v_cap, zero)
    hi_e = torch.where(edge_mask, codes % v_cap, zero)
    q1, q2, q3 = _carry(codes, edge_mask, prev_edges, prev_edge_mask,
                        (prev_q1, prev_q2, prev_q3), v_cap, e_cap)
    inc = (_build_incidence_device(lo_e, hi_e, edge_mask, e_cap, v_cap,
                                   degree)
           if build_incidence else _no_incidence(v_cap, e_cap, degree, dev))
    return Topology(edges=torch.stack([lo_e, hi_e], dim=1),
                    alpha=_alpha(pos, lo_e, hi_e, edge_mask),
                    edge_mask=edge_mask, q1=q1, q2=q2, q3=q3,
                    inc_edge=inc[0], inc_sign=inc[1],
                    n_edges=min(int(first.sum()), e_cap), src_slot=inc[2])
