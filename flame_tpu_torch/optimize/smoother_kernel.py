"""The NLTGV2-L1 smoother with its CUDA iteration kernel.

Counterpart of flame_tpu/optimize/pallas_smoother.py. The loop-invariant
slot prologue and the dual write-back are plain torch
(nltgv2.slot_prologue / nltgv2.unslot), as they are XLA outside the
Pallas call in the JAX package; each iteration is one launch of
csrc/nltgv2_smoother.cu.

For tensors on the CPU the iterations run the plain version
(nltgv2.iterate_plain). For CUDA tensors the kernel runs or the call
raises; there is no fallback.
"""

import torch

from flame_tpu_torch import _kernels
from flame_tpu_torch.optimize import nltgv2
from flame_tpu_torch.params import RegularizerParams

KERNEL = "nltgv2_smoother"


def _check(name, t, shape, dtype, device):
    if t.device != device or t.dtype != dtype or tuple(t.shape) != shape \
            or not t.is_contiguous():
        raise ValueError(f"{KERNEL}: {name} must be a contiguous {dtype} "
                         f"tensor of shape {shape} on {device}, got "
                         f"{t.dtype} {tuple(t.shape)} on {t.device}")


def iterate(p: RegularizerParams, tables: nltgv2.SlotTables,
            data: torch.Tensor, weight: torch.Tensor, vmask: torch.Tensor,
            state: nltgv2.SmoothState, n_iters: int) -> nltgv2.SmoothState:
    """n_iters iterations; same contract as nltgv2.iterate_plain."""
    dev = data.device
    if dev.type == "cpu":
        return nltgv2.iterate_plain(p, tables, data, weight, vmask, state,
                                    n_iters)
    if dev.type != "cuda":
        raise ValueError(f"{KERNEL}: unsupported device {dev}")
    V, D = tables.nbr.shape
    f32 = torch.float32
    # Kernel layout: slot tables transposed to (D, V) for coalesced reads.
    nbr = tables.nbr.t().contiguous().int()
    slot_f = [t.t().contiguous() for t in tables[1:]]
    q = [t.t().contiguous() for t in state[6:]]
    x, w1, w2 = (t.contiguous().clone() for t in state[:3])
    cur = torch.stack(state[3:6]).contiguous()  # (3, V) x_bar w1_bar w2_bar
    nxt = torch.empty_like(cur)
    vm = vmask.float().contiguous()
    for name, t, shape in [("nbr", nbr, (D, V))] + [
            (n, t, (D, V)) for n, t in zip(
                ("sdx", "sdy", "sal", "sbe", "sgn", "srcf", "q1", "q2", "q3"),
                slot_f + q)] + [
            (n, t, (V,)) for n, t in zip(
                ("x", "w1", "w2", "data", "weight", "vmask"),
                (x, w1, w2, data, weight, vm))]:
        _check(name, t, shape, torch.int32 if name == "nbr" else f32, dev)
    _check("x_bar", cur, (3, V), f32, dev)

    lib = _kernels.load()
    stream = torch.cuda.current_stream(dev).cuda_stream
    for _ in range(n_iters):
        err = lib.nltgv2_iterate(
            cur[0].data_ptr(), cur[1].data_ptr(), cur[2].data_ptr(),
            nxt[0].data_ptr(), nxt[1].data_ptr(), nxt[2].data_ptr(),
            x.data_ptr(), w1.data_ptr(), w2.data_ptr(),
            *(t.data_ptr() for t in q), nbr.data_ptr(),
            *(t.data_ptr() for t in slot_f),
            data.data_ptr(), weight.data_ptr(), vm.data_ptr(),
            V, D, p.step_x, p.step_q, p.theta, p.x_min, p.x_max, stream)
        _kernels.check_cuda_error(err, KERNEL)
        _kernels.LAUNCHES[KERNEL] += 1
        cur, nxt = nxt, cur
    return nltgv2.SmoothState(x, w1, w2, cur[0], cur[1], cur[2],
                              q[0].t(), q[1].t(), q[2].t())


def smooth(p: RegularizerParams, g: nltgv2.GraphState,
           n_iters: int) -> nltgv2.GraphState:
    """Prologue, n_iters iterations (kernel on CUDA), write-back."""
    tables, state = nltgv2.slot_prologue(g)
    state = iterate(p, tables, g.data_term.contiguous(),
                    (p.data_factor * g.data_weight).contiguous(),
                    g.vtx_mask, state, n_iters)
    return nltgv2.unslot(g, state)
