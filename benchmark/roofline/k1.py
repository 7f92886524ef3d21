"""K1, the NLTGV2-L1 smoother (flame_tpu_torch/csrc/nltgv2_smoother.cu,
called through optimize/smoother_kernel.smooth): bytes and operations
of one call, from the call's graph and iteration count alone.

Bytes: each input read once and each output written once, for the
graph's member vertices (position 2, primal and extragradient state 6,
data term and weight 2 words, the mask byte; 6 words out) and its live
edges (2 endpoint words and 3 duals in, 3 duals out), 4-byte words.
Operations per iteration: per live edge the dual step once (the
difference term 5, three ascents with their unit-ball projection
5 + 6 + 6) and its primal contributions to both ends (2 x 15); per
member vertex the proximal step, the clamp and the three extragradients
(21); per edge once per call the weight 1 / length (5).
"""

HOOK = ("flame_tpu_torch.optimize.smoother_kernel", "smooth")
KERNEL = "nltgv2_smoother_kernel"
EDGE_OPS = 22 + 2 * 15
VERTEX_OPS = 21
WEIGHT_OPS = 5
VERTEX_BYTES = 4 * (2 + 6 + 2) + 1 + 4 * 6
EDGE_BYTES = 4 * (2 + 3) + 4 * 3


def record(args, kwargs, out):
    g = args[1]
    return dict(vtx=g.vtx_mask, edges=g.edge_mask, n_iters=int(args[2]))


def counts(members: int, edges: int, n_iters: int):
    """(bytes, operations) of one call."""
    nbytes = VERTEX_BYTES * members + EDGE_BYTES * edges
    ops = n_iters * (EDGE_OPS * edges + VERTEX_OPS * members) \
        + WEIGHT_OPS * edges
    return nbytes, ops


def cost(rec):
    return counts(int(rec["vtx"].sum()), int(rec["edges"].sum()),
                  rec["n_iters"])
