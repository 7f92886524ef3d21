"""Graph topology from the host's edge list: dual carry-over, edge
weights and the [V, D] incidence tables.

Port of flame_tpu/optimize/topology.py (from_edges with host slot ranks,
or without the incidence tables; build_edge_ranks and rank_within are the
same numpy host code). The host supplies the unique edges, canonical
(lo, hi) and sorted by lo*V+hi; the device carries duals over for vertex
pairs that survive the retriangulation (reference flame.cc:2094-2104),
computes alpha = 1/length and scatters the incidence tables from the
ranks.
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
    """Topology from the host edge list (padded to e_cap). Duals carry
    over by binary search of the new codes in the previous sorted codes.
    ranks None skips the incidence tables (zero tables, every src_slot
    V * D): the banded smoothers build their own layout from RCM ranks,
    which are not incidence ranks."""
    dev = pos.device
    edges = edges_in.long()
    edge_mask = torch.arange(e_cap, device=dev) < n_edges
    zero = torch.zeros_like(edges[:, 0])
    lo_e = torch.where(edge_mask, edges[:, 0], zero)
    hi_e = torch.where(edge_mask, edges[:, 1], zero)

    d = pos[lo_e] - pos[hi_e]
    length = torch.sqrt(torch.sum(d * d, dim=1))
    alpha = torch.where(edge_mask & (length > 1e-6),
                        1.0 / torch.clamp(length, min=MIN_EDGE_LENGTH),
                        torch.zeros_like(length))

    big = v_cap * v_cap
    codes = torch.where(edge_mask, lo_e * v_cap + hi_e, big)
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

    def carry(q):
        return torch.where(match, q[src], torch.zeros_like(q))

    if ranks is None:
        inc_edge = torch.zeros((v_cap, degree), dtype=torch.int64, device=dev)
        inc_sign = torch.zeros((v_cap, degree), device=dev)
        src_slot = torch.full((e_cap,), v_cap * degree, dtype=torch.int64,
                              device=dev)
    else:
        inc_edge, inc_sign, src_slot = _build_incidence_from_ranks(
            lo_e, hi_e, edge_mask, ranks, e_cap, v_cap, degree)
    return Topology(edges=torch.stack([lo_e, hi_e], dim=1), alpha=alpha,
                    edge_mask=edge_mask, q1=carry(prev_q1),
                    q2=carry(prev_q2), q3=carry(prev_q3),
                    inc_edge=inc_edge, inc_sign=inc_sign,
                    n_edges=int(n_edges), src_slot=src_slot)
