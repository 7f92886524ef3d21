#!/usr/bin/env python3
"""Time K3 (the halo smoother), K2 (the rasterizer) and K2b (the batched
rasterizer) of one checkout of flame_tpu_torch on the card, so that two
checkouts can be compared in one call.

    python3 tools/torch_halo_raster_times.py [ROOT] [--union-given]

ROOT is the checkout whose flame_tpu_torch is timed (default: this one);
the inputs and the timers are this checkout's chip_smoke.py's, so an older
tree (unpacked with `git archive` into a directory .gitignore lists) is
timed on the same inputs. Run the trees in turns in one command (parent,
change, change, parent): two calls may land on different cards.

K3: chip_smoke's graph (4096 seeded points over 640x480, D=20) in the
banded layout, reach 3, 40 iterations, at 1, 2, 4 and 8 partitions with
the tree's own launch plan, and, where the tree has
halo_kernel.fitting_plans, at every vertices per warp that fits with its
fewest clusters ("plans"). K2: raster_mesh on that mesh. K2b: 8 views of
it, as chip_smoke's bench batch. For each, the card's time per call
(chip_smoke._device_ms, wrapper included) and the back-to-back time
(_cuda_ms). K2b's rows: "launch" is the launch a tree's
pipeline.batch_step makes for the binned maps (a tree from before
raster_mesh_batch bins in torch: that binning is timed with its launch
as "binning+launch"), "whole" the whole raster_kernel.rasterize_batch
call. Prints one JSON line.

--union-given (a tree with raster_mesh_batch): also builds
tools/torch_raster_union_given.cu (K2b taking the union bboxes as an
input) into flame_tpu_torch/_build/ and times it with the union formed
in torch before it ("union in torch": rasterize.union_boxes + that
launch) beside the tree's launch that forms the union in its scan,
checking that both give the same maps and count.
"""

import argparse
import ctypes
import importlib.util
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def build_union_given():
    """The raster_union_given entry of tools/torch_raster_union_given.cu,
    built with _kernels' nvcc flags."""
    from flame_tpu_torch import _kernels
    source = os.path.join(HERE, "tools", "torch_raster_union_given.cu")
    os.makedirs(_kernels.BUILD_DIR, exist_ok=True)
    lib_path = os.path.join(_kernels.BUILD_DIR, "libraster_union_given.so")
    subprocess.run([_kernels._nvcc(), *_kernels.NVCC_FLAGS, "-o", lib_path,
                    source], check=True, capture_output=True)
    fn = ctypes.CDLL(lib_path).raster_union_given
    P, I = ctypes.c_void_p, ctypes.c_int
    fn.restype = I
    fn.argtypes = [P, P, P, I, I, P, P, I, I, I, I, P]
    return fn


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("root", nargs="?", default=HERE)
    ap.add_argument("--union-given", action="store_true")
    args = ap.parse_args()
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        raise RuntimeError("needs a CUDA device")
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_timers", os.path.join(HERE, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    import flame_tpu_torch
    from flame_tpu_torch import RegularizerParams, _kernels
    from flame_tpu_torch.ops import raster_kernel, rasterize
    from flame_tpu_torch.parallel import halo_kernel
    if os.path.dirname(os.path.dirname(flame_tpu_torch.__file__)) != root:
        raise RuntimeError(f"flame_tpu_torch imported from "
                           f"{flame_tpu_torch.__file__}, not from {root}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    _kernels.load()
    dev = torch.device("cuda")
    g, tris_np, _ = cs.make_graph(dev)
    out = {"root": os.path.relpath(root, HERE), "card": smi}

    p = RegularizerParams()
    D, reach, n_iters = g.inc_edge.shape[1], cs.K3_REACH, 40
    lay, _, _ = cs.banded_layout(g, D, reach)
    k3 = {}
    for n in cs.K3_PARTS:
        def halo():
            return halo_kernel.iterate(p, n_iters, D, reach, n, lay.vtx,
                                       lay.slots)
        k3[n] = {"device_ms": cs._device_ms(halo, 20),
                 "back_to_back_ms": cs._cuda_ms(halo, 20)}
        if not hasattr(halo_kernel, "fitting_plans"):
            continue
        k3[n]["plan"] = halo_kernel._plan(0, g.x.shape[0], D, n,
                                          reach)._asdict()
        plans, seen = [], set()
        for q in halo_kernel.fitting_plans(
                g.x.shape[0], D, n, *halo_kernel.card_occupancy(0, reach),
                reach):
            if q.vertices_per_warp in seen:
                continue
            seen.add(q.vertices_per_warp)
            saved = halo_kernel._plan
            halo_kernel._plan = lambda *_, q=q: q
            try:
                plans.append(dict(q._asdict(),
                                  device_ms=cs._device_ms(halo, 20)))
            finally:
                halo_kernel._plan = saved
        k3[n]["plans"] = plans
    out["k3"] = k3

    H, W, B = 480, 640, 8
    rng = np.random.default_rng(cs.SEED + 2)
    tris = torch.as_tensor(tris_np, device=dev)
    T = tris.shape[0]
    verts = torch.stack([g.pos * (1.0 + 0.01 * b) + torch.tensor(
        [3.0 * b, -2.0 * b], device=dev) for b in range(B)])
    vals = torch.as_tensor(rng.uniform(0.5, 2.0, (B, g.pos.shape[0])),
                           dtype=torch.float32, device=dev)
    valid_np = np.ones((B, T), bool)
    valid_np[3, rng.integers(0, T, T // 10)] = False
    valid = torch.as_tensor(valid_np, device=dev)
    p1, b1 = raster_kernel.mesh_inputs(verts[0], tris, vals[0],
                                       torch.ones_like(valid[0]))
    out["k2"] = {"device_ms": cs._device_ms(
        lambda: raster_kernel.raster_mesh(p1, b1, H, W), 50)}
    cap = raster_kernel.MAX_PER_TILE_BATCH
    k2b = {}
    if hasattr(raster_kernel, "raster_mesh_batch"):
        packed, bbox = raster_kernel.mesh_inputs(verts, tris, vals, valid)
        rows = {"launch": lambda: raster_kernel.raster_mesh_batch(
            packed, bbox, H, W)}
    else:  # a tree from before raster_mesh_batch: torch binning + launch
        cd = rasterize.tile_candidates_batch(
            verts, tris, vals, valid, H, W, max_per_tile=cap).cdata \
            .contiguous()
        rows = {
            "launch": lambda: raster_kernel.rasterize_tiles_batch(cd),
            "binning+launch": lambda: raster_kernel.rasterize_tiles_batch(
                rasterize.tile_candidates_batch(
                    verts, tris, vals, valid, H, W,
                    max_per_tile=cap).cdata.contiguous())}
    rows["whole"] = lambda: raster_kernel.rasterize_batch(
        verts, tris, vals, valid, H, W)
    for name, fn in rows.items():
        k2b[name] = {"device_ms": cs._device_ms(fn, 20),
                     "back_to_back_ms": cs._cuda_ms(fn, 20)}
    if args.union_given:
        given = build_union_given()
        nty, ntx = -(-H // 32), -(-W // 128)
        k1 = min(cap, T)
        stream = torch.cuda.current_stream().cuda_stream
        grid = torch.empty((B, nty * 32, ntx * 128), device=dev)
        count = torch.empty(1, dtype=torch.int32, device=dev)

        def union_in_torch():
            ubox = torch.stack(rasterize.union_boxes(
                packed[..., 13] > 0, bbox.unbind(-1)), -1).contiguous()
            _kernels.check_cuda_error(given(
                packed.data_ptr(), bbox.data_ptr(), ubox.data_ptr(), B, T,
                grid.data_ptr(), count.data_ptr(), nty, ntx, k1, 32,
                stream), "raster_union_given")
            return grid, count
        k2b["union in torch"] = {
            "device_ms": cs._device_ms(union_in_torch, 20),
            "back_to_back_ms": cs._cuda_ms(union_in_torch, 20)}
        ga, ca = rows["launch"]()
        gb, cb = union_in_torch()
        torch.cuda.synchronize()
        out["union_given_equal"] = bool(torch.equal(ga, gb)
                                        and torch.equal(ca, cb))
    out["k2b"] = k2b
    print(json.dumps(out))


if __name__ == "__main__":
    main()
