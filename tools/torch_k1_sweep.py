#!/usr/bin/env python3
"""Time the NLTGV2 smoother kernel (K1) on one CUDA GPU for each layout of
vertices per warp that the card holds, and for other builds of its source.

    python3 tools/torch_k1_sweep.py [VARIANT.cu ...]

Builds flame_tpu_torch/csrc/nltgv2_smoother.cu and each VARIANT (a source
with the same C interface) with the package's nvcc flags. On the graphs of
chip_smoke.py (4096 seeded points over 640x480 at D=20, 8192 over 1024x768
at D=16) it prints, per source and vertices per warp, the card's time per
call at 40 iterations and at 1 (chip_smoke._device_ms: CUDA events while
the card works through calls queued behind a sleep), the time of one
iteration from their difference, and the largest difference from the
plain version after 40 iterations with chip_smoke.K1_TOL's verdict.
"""

import ctypes
import os
import subprocess
import sys
import types

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import chip_smoke  # noqa: E402
from flame_tpu_torch import RegularizerParams, _kernels  # noqa: E402
from flame_tpu_torch.optimize import nltgv2, smoother_kernel  # noqa: E402

GRAPHS = (dict(V=4096, E=12288, D=20, W=640, H=480),
          dict(V=8192, E=3 * 8192, D=16, W=1024, H=768))


def build(source: str):
    """The source's nltgv2_smoother and its occupancy query, bound with the
    package's argtypes."""
    stem = os.path.splitext(os.path.basename(source))[0]
    out = os.path.join(_kernels.BUILD_DIR, f"sweep_{stem}.so")
    subprocess.run([_kernels._nvcc(), *_kernels.NVCC_FLAGS, "-o", out,
                    source], check=True, capture_output=True)
    lib = ctypes.CDLL(out)
    ref = _kernels.load()
    for name in ("nltgv2_smoother", "nltgv2_smoother_occupancy"):
        fn = getattr(lib, name)
        fn.argtypes = getattr(ref, name).argtypes
        fn.restype = getattr(ref, name).restype
    return lib


def sweep(label: str, lib, g, n_sms: int):
    p = RegularizerParams()
    tables, state = nltgv2.slot_prologue(g)
    weight = (p.data_factor * g.data_weight).contiguous()
    args = (p, tables, g.data_term, weight, g.vtx_mask)
    V, D = tables.nbr.shape
    spl = -(-D // 32)
    ref = nltgv2.iterate_plain(*args, state, 40)
    orig_lib, orig_plan = _kernels._lib, smoother_kernel._plan
    try:
        _kernels._lib = types.SimpleNamespace(**vars(orig_lib))
        _kernels._lib.nltgv2_smoother = lib.nltgv2_smoother
        for vpw in smoother_kernel.VERTICES_PER_WARP:
            if spl * vpw > smoother_kernel.MAX_GROUPS:
                break
            n = ctypes.c_int()
            _kernels.check_cuda_error(lib.nltgv2_smoother_occupancy(
                spl, vpw, ctypes.byref(n)), "occupancy")
            grid = -(-(-(-V // vpw)) // smoother_kernel.WARPS_PER_CTA)
            if grid > n.value * n_sms:
                continue
            smoother_kernel._plan = (
                lambda *_, vpw=vpw, grid=grid:
                smoother_kernel.LaunchPlan(spl, vpw, grid))
            out = smoother_kernel.iterate(*args, state, 40)
            torch.cuda.synchronize()
            err = max((a - b).abs().max().item() for a, b in zip(out, ref))
            ok = all(torch.allclose(a, b, **chip_smoke.K1_TOL)
                     for a, b in zip(out, ref))
            t40 = chip_smoke._device_ms(
                lambda: smoother_kernel.iterate(*args, state, 40), 20)
            t1 = chip_smoke._device_ms(
                lambda: smoother_kernel.iterate(*args, state, 1), 20)
            print(f"{label} V={V} D={D} vertices/warp {vpw} ({grid} CTAs, "
                  f"{n.value} per SM): {t40:.4f} ms per call of 40 "
                  f"iterations, {t1:.4f} ms of 1, "
                  f"{1000 * (t40 - t1) / 39:.3f} us per iteration; "
                  f"max|kernel-plain| {err:.3g} "
                  f"({'within' if ok else 'OUTSIDE'} K1_TOL)", flush=True)
    finally:
        _kernels._lib, smoother_kernel._plan = orig_lib, orig_plan


def main():
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device: the sweep runs on a GPU only")
    dev = torch.device("cuda")
    print(chip_smoke.environment())
    sources = [os.path.join(_kernels.CSRC, "nltgv2_smoother.cu")] \
        + sys.argv[1:]
    libs = [(os.path.relpath(s), build(s)) for s in sources]
    n_sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for spec in GRAPHS:
        g = chip_smoke.make_graph(dev, **spec)[0]
        for label, lib in libs:
            sweep(label, lib, g, n_sms)


if __name__ == "__main__":
    main()
