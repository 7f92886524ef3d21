#!/usr/bin/env python3
"""Drive flame_tpu_torch on one CUDA GPU and check it.

    python3 chip_smoke.py

Phases (any failure raises and the script exits non-zero):
  1. environment: versions, nvcc, the card's name and power limit; TF32
     is switched off for matmuls and cuDNN (the geometry needs full fp32);
  2. build the CUDA kernels from flame_tpu_torch/csrc, one nvcc per
     source, all started together;
  3. the NLTGV2 smoother kernel (K1, all iterations in one launch)
     against its plain torch version on a Delaunay graph of 4096 seeded
     points over 640x480 (D=20) and of 8192 over 1024x768 (D=16), 40
     iterations each, including bit-equal dual copies at both edge ends
     and one launch per call;
  4. the single-view rasterizer kernel (K2, binning and tile pass in one
     launch) through raster_kernel.rasterize against the plain
     rasterize.rasterize on the 640x480 mesh and on a mesh with a tile of
     more than 160 overlapping triangles: equal NaN masks, values, and
     largest per-tile count;
  5. the batched rasterizer kernel (K2b, raster_mesh_batch: one union
     binning per tile for all views and the tile passes in one launch,
     the views of a tile in a cluster of the largest divisor of B up to 8
     CTAs) through raster_kernel.rasterize_batch_with_count against the
     plain union binning + eval_tiles_batch on B = 8, 1, 2, 3 and 4 views
     of that mesh (shifted and scaled per view, per-view values, one view
     with invalidated triangles) and of a mesh whose densest tile's union
     count passes 192: equal NaN masks, values and largest union count;
     the launch timed at each B;
  5b. the halo smoother kernel (K3, a thread-block cluster per partition)
     on that graph in the RCM-banded layout (reach 3, 40 iterations) at
     1, 2, 4 and 8 partitions of the card, with each launch plan (CTAs per
     cluster, vertices per warp, clusters the card holds): against its
     plain version, bit-equal across the partition counts (the strips
     arrive right) and with bit-equal dual copies;
  5c. the BA window solve (ba.window._solve_packed at L=1024, M=4096)
     captured as one CUDA graph against its eager run, on well-posed
     windows of 3 and 8 poses (rtol 1e-4), with both times;
  6. the synchronous path: flame_tpu_torch.Flame at 640x480 with 4096
     features on a synthetic textured plane at 5 m, 30 frames, every
     second one a poseframe; K1 and K2 must run on every frame that
     makes a mesh (K1 and K2 once each), and the dense map must cover
     >= 50% of the image within 1% median relative error of the true
     inverse depth;
  7. the throughput path: bench.py's configuration (async topology,
     frame_batch=8, photo_error_num_pfs=30, 16 poseframe slots) for 96
     frames of the same scene, once with frames already on the card
     ("resident") and once with numpy frames ("host"); K2b must run once
     per batched step, K1 and K2 once per post-Delaunay step, at least one
     poseframe must be evicted, and the final map must meet the bounds
     of phase 6;
  8. the partitioned smoother path: ShardedFlame with
     smoother="pallas_halo" on make_mesh(4) (4 partitions of the card),
     on phase 6's frames (its dense map within a median 1e-4 of phase
     6's) and on phase 7's configuration with resident frames; K3 and K2
     once and K1 never per post-Delaunay step, with the bounds of phase 6;
  9. the dataset path: mini-TUM (flame_tpu_torch.io.synthetic) generated
     into a temporary directory with 15 mm / 0.3 deg pose noise and run
     through io.datasets.load_tum + run_sequence (poseframe every 2
     frames), on the true poses and on the noisy poses without and with
     bundle adjustment: at 256x192 in DATASETS.md's configuration
     (tests/test_dataset_accuracy.py), and at 640x480 with run_dataset's
     Params (async topology; BA on the true poses too). Nothing waits for
     the card inside a run. Gates: the true-pose final map covers > 0.35
     with median relative error < 0.04 (at 640x480 coverage only: the JAX
     package misses 0.04 there too, and the error is printed beside its
     value), BA cuts the ATE below 0.8x and applied a solve, and K1 and K2
     launch once per post-Delaunay step;
 10. the API residue at 640x480 with 4096 features: automatic poseframes
     (auto_poseframe, is_poseframe=None) on phase 6's synchronous path (30
     frames) and on phase 7's throughput path with host frames (32
     frames), each declaring a number of poseframes within the range the
     disparity test allows and meeting phase 6's map bounds, with the
     host cost of each decision; the filtered map
     (get_filtered_inverse_depth_map, K2) against the plain rasterizer on
     the same state (same pixels, values within 1e-6); checkpoint.save
     after frame 12 of a deterministic throughput run with BA on
     mini-TUM 256x192 and load into a fresh Flame (bit-equal at once),
     both continued for 12 frames under
     torch.use_deterministic_algorithms (bit-equal maps, features and
     poses), with the save and load times; the card's memory through
     utils.load_tracker; run_synthetic for 10 frames into
     chiprun_out/run_synthetic (median error within phase 6's bound).
 11. the multi-chip layer on one card: (a) parallel.sharding.sharded_smooth
     on phase 3's VGA graph, 40 iterations, at 1, 2, 4 and 8 partitions
     against nltgv2.smooth(mode="stacked") and K1's result (max |dx| <=
     1e-5), with card ms and the psum traffic model; (b)
     sharded_update_step on make_mesh(4) at bench_params() for "edge",
     "halo" and "pallas_halo" on a Flame's state after 8 frames of phase
     6's scene: tracking bit-equal to the unsharded track_project_sync,
     K3 launched once in "pallas_halo" only, "pallas_halo" against
     "halo" within phase 5b's tolerance and "edge" against the stacked
     smoother within 1e-5; (c) distributed_ba.solve_window_sharded on
     make_mesh(4) at phase 5c's windows against the single solve as a
     CUDA graph (rtol 1e-4), eager and graphed ms; (d) ShardedFlame with
     BA on make_mesh(4) on phase 9's 640x480 noisy sequence (48 frames,
     run inside phase 9's directory), smoother "vertex" and
     "pallas_halo": ATE below 0.8x phase 9's noisy run without BA,
     coverage > 0.35, every solve sharded, K1 or K3 and K2 once per
     post-Delaunay step; (e) multihost.initialize with one process over
     NCCL: sharded_smooth and solve_window_sharded on global_mesh()
     bit-equal to their one-partition results under
     torch.use_deterministic_algorithms.
 12. the multi-card transport on the one card (a host with two cards
     would time the transport between them; this one has one): the
     script starts itself twice as the ranks of a gloo group whose mesh
     lies on the card (multihost.global_mesh(device="cuda")), each rank
     computing on the card with its collectives and strips through host
     tensors and K3's strips through CUDA IPC peer buffers. (a) K3 over
     the group on phase 3's graph (reach 3, 40 iterations): the gathered
     smooth_sharded result bit-equal to K3 on make_mesh(2) and
     make_mesh(1) of one process, one launch per rank and call, and five
     launches queued back to back (epoch-counted flags, never reset)
     each bit-equal to the rank's block of make_mesh(2)'s result; ms per
     call, the two processes' contexts time-slicing on the one card. (b)
     ShardedFlame over the group at bench_params() (640x480, 4096
     features) on phase 6's scene: "pallas_halo" for 30 frames (2048
     feature rows per rank; the map within a median 1e-4 of ShardedFlame
     on make_mesh(2) in one process, phase 6's gates, K3 and K2 once and
     K1 never per post-Delaunay step), "vertex" and "halo" for 12 frames
     against make_mesh(2) the same way; then mini-TUM 256x192 on noisy
     poses with BA over the group: ATE below 0.8x of the run without BA
     (phase 9's gate), every solve sharded. (d) The batched step over
     the group: ShardedFlame "pallas_halo" on phase 7's configuration
     (throughput_params(): frame_batch=8, eviction) with resident frames
     and deterministic=True, 38 frames (four batched steps): the map
     within a median 1e-4 of make_mesh(2)'s in one process, phase 7's
     gates, K2b once per batched step and K3 and K2 once per
     post-Delaunay step on each rank, ms per batched step. A rank that
     fails makes the script fail. (c) one NCCL rank in this process:
     ShardedFlame over global_mesh() with "pallas_halo" bit-equal to
     make_mesh(1) under torch.use_deterministic_algorithms, on the
     synchronous path and (e) on (d)'s throughput configuration (22
     frames, two batched steps).
 13. the bench: python -m flame_tpu_torch.bench in a subprocess at its
     defaults (640x480, 4096 features, the modes resident, host_upload
     and resident_ba), as the XGA row (BENCH_RES=1024x768
     BENCH_FEATS=8192, resident, 6 windows) and with
     BENCH_SMOOTHER=pallas (resident, 4 windows; K3 on one partition).
     Each run must exit 0 and end in its JSON line with every mode asked
     for above 0 fps, coverage >= 0.5, median relative error <= 0.01 and
     a solver rate above 0; each mode's run launches K2b, K2 and the
     resolved smoother's kernel (K1, or K3 under "pallas") and never the
     other, and the solver rate launches that kernel twice (warm-up and
     timed call). The line is printed beside the card's name and power
     limit.
 14. pair-mode batching and the structured scene at full width
     (bench_params(): 640x480, 4096 features, E 12288, T 8192, degree
     20, 40 iterations). (a) phase 6's plane for 32 frames under async
     topology with coalesce_uploads at frame_batch 1, 2, 4 and 8 on
     resident frames and 2 on host frames: K2b once in every update that
     ran a batched step and in no other, K1 and K2 once per post-Delaunay
     step, at least 5 / 3 / 2 batched steps at B=2 / 4 / 8, phase 6's map
     bounds, and
     tests/test_pair_mode.py's parity bounds (B=2 against B=1: coverage
     > 0.9x, error < max(2x, 0.01); B=4 against B=2: > 0.85x, < 0.02;
     host against resident B=2: > 0.9x, < 0.02). (b) the two-plane scene
     of tests/test_structured_scene.py at FX 400 (its angles at 160x120
     and FX 100; the texture scaled with FX, see two_planes) for 14
     frames on the synchronous path with its idepth_init,
     idepth_var_init and height limits: K1 and K2 once per post-Delaunay
     step, and its bounds (coverage > 0.3, median relative error < 0.08,
     contrast across the split > 0.12 with the slab within 15% of 1/2.2,
     slope ratio in (0.3, 3)), its pixel margins scaled with the width.
     One line per run: median frame ms, coverage, median error, contrast
     and slope ratio.
 15. the Params branches that no other phase switches on, at full width
     (bench_params(), phase 6's plane): on the synchronous path one run
     of 16 frames each with the defaults, detection.do_letterbox,
     detection.continuous=False, do_meas_fusion=False,
     fparams.sparams.do_subpixel=False, do_grad_check_after_projection
     (min_grad_mag 11.5), adaptive_data_weights and the three triangle
     filters off; K1 and K2 once per post-Delaunay step, each map held
     to the JAX package's reading of the same run (BRANCH_JAX, from
     tests/torch_branches_witness.py on the CPU; coverage > 0.9x, median
     error < max(2x, 0.01)), letterbox's live features in the middle
     third of the rows and its map's coverage outside them <= 0.02, no
     detection after the first meshed update with continuous off, the
     filters off covering at least the default run's pixels within 0.01
     error. solver.fetch_stride=2 on phase 7's resident throughput path
     beside a stride-1 run: phase 7's gates, half the staged transfers
     within one. ba.do_rematch=False and ba.aniso_weights=True on phase
     9's 256x192 and 640x480 noisy runs with BA (run inside phase 9's
     directories): ATE below 0.8x the cell's run without BA, without
     re-match below 1.0x at 256x192 and below the JAX package's ratio +
     0.05 at 640x480 (BA_BRANCH_GATES: the JAX package misses 0.8 there
     too), the JAX package's ratio printed beside; aniso_weights' window
     solve as a CUDA graph against its eager run (phase 5c's check, rtol
     1e-4); and the share of float32 roots torch.sqrt rounds otherwise
     than numpy on the card.
 16. the tracking step and the post-Delaunay section from CUDA graphs
     (flame_tpu_torch/step_graph.py): 40 frames of the synchronous posture
     (bench_params() with photo_error_num_pfs=30) and of the batched one
     (throughput_params() with deterministic=True; frame_batch 8),
     poseframes every 2nd frame, each run twice on phase 6's scene:
     replaying the graphs, and with step_graph.steps_for patched to None
     (the eager path). The feature state, the current features, the
     stats, the graph state, normals, triangle validity and every map
     read after a frame or a batch must be bit-equal between the two;
     the graphed run must count one capture per graph, a replay for
     every call of pipeline.track_project_sync, _detect_and_insert and
     _post_delaunay_inner (wrapped by name, as the benchmark wraps them;
     the post-Delaunay section's four graphs each replay once a call),
     no eager call, and one K1 and one K2 launch per post-Delaunay call.
     Prints update_idepths' host ms per frame and sync_graph's host ms
     per call (their spans, the first 4 calls left out), eager against
     graphed, and update_idepths' CUDA-event ms.
Each path runs with the launch counts set to 0 just before it and read
just after (in the bench's process for phase 13). The last lines are
the kernels' JSON summary (with each kernel's bound: the larger of its
bytes over 3.35 TB/s and its operations over 67 TFLOP/s fp32, from this
run's inputs), the nvidia-smi line, and {"ok": true, "device": {...}}.
"""

import json
import math
import os
import shutil
import subprocess
import sys
import tempfile
import time
import warnings

import numpy as np
import torch

SEED = 0
K1_TOL = dict(rtol=2e-4, atol=5e-5)
K2_ATOL = 1e-5
K3_REACH = 3  # bench.py's pallas_reach
K3_PARTS = (1, 2, 4, 8)
MESH_PARTS = 4  # partitions of the sharded path

# Published H100 SXM peaks (NVIDIA data sheet, at 700 W).
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_OPS_PER_S = 67e12  # fp32 outside the tensor cores
# Operations of one smoother iteration, counted from the kernels' code:
# per live slot the dual step (K1 5, three ascents with projection 5 + 6
# + 6) and the primal contributions with their sums (3 + 6 + 6); per
# member vertex the sums, proxL1, clip and the three extragradients.
SLOT_OPS = 37
VERTEX_OPS = 21
# Raster: per (valid candidate, tile pixel) three edge functions and the
# inside test; per covered pixel the value and the max; per (tile,
# triangle) of the binning four bbox compares and the valid test.
RASTER_PAIR_OPS = 15
RASTER_PIXEL_OPS = 6
RASTER_BIN_OPS = 5
# Cycles of torch.cuda._sleep that keep the card busy while the host
# queues the timed calls (about 25 ms at H100 clocks), so that their CUDA
# events measure the card's time and not the host's.
QUEUE_SLEEP_CYCLES = 50_000_000


def bound(nbytes, ops):
    """The least time the card could take: bytes over the memory rate or
    operations over the fp32 rate, whichever is larger."""
    t_bytes = 1e3 * nbytes / PEAK_BYTES_PER_S
    t_ops = 1e3 * ops / PEAK_F32_OPS_PER_S
    return dict(bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations",
                library_ms=None)


def smoother_bound(V, D, live_slots, members, n_iters, slot_words):
    """slot_words (R * D or V * D tables read or written once) and 15
    vertex words (9 in, 6 out) of 4 bytes; the operations of this run's
    live slots and member vertices."""
    nbytes = 4 * (slot_words * V * D + 15 * V)
    ops = n_iters * (SLOT_OPS * live_slots + VERTEX_OPS * members)
    return bound(nbytes, ops)


def _tile_pairs(kvals, bbox, ok, nty, ntx, tile_h):
    """Candidate-pixel pairs: each kept candidate (kvals >= 0) that is
    valid (ok) over the pixels of its (T, 4) bbox within its tile."""
    from flame_tpu_torch.ops import rasterize
    t = kvals.clamp(min=0)
    tid = torch.arange(nty * ntx, device=kvals.device)[:, None]
    tx = (tid % ntx * rasterize.TILE_W).float()
    ty = (tid // ntx * tile_h).float()
    nx = torch.minimum(torch.floor(bbox[t, 1]), tx + rasterize.TILE_W - 1) \
        - torch.maximum(torch.ceil(bbox[t, 0]), tx) + 1
    ny = torch.minimum(torch.floor(bbox[t, 3]), ty + tile_h - 1) \
        - torch.maximum(torch.ceil(bbox[t, 2]), ty) + 1
    keep = (kvals >= 0) & ok[t]
    return int((nx.clamp(min=0) * ny.clamp(min=0) * keep).sum())


def mesh_bound(packed, bbox, grid, H, W, tile_h=32, max_per_tile=160):
    """K2: triangle rows and bboxes read once, the map written once; the
    binning of every (tile, triangle), the operations of each kept
    candidate over the pixels of its bbox within its tile, and of the
    covered pixels."""
    from flame_tpu_torch.ops import rasterize
    T = packed.shape[0]
    nty, ntx = grid.shape[0] // tile_h, grid.shape[1] // rasterize.TILE_W
    ok = packed[:, 13] > 0
    kvals, _ = rasterize._bin_tiles(bbox.unbind(1), ok, H, W, tile_h,
                                    min(max_per_tile, T))
    pairs = _tile_pairs(kvals, bbox, ok, nty, ntx, tile_h)
    covered = int((grid > -1e38).sum())
    return bound(4 * (packed.numel() + bbox.numel() + grid.numel()),
                 RASTER_BIN_OPS * T * nty * ntx + RASTER_PAIR_OPS * pairs
                 + RASTER_PIXEL_OPS * covered)


def batch_bound(packed, bbox, grids, H, W, tile_h=32, max_per_tile=192):
    """K2b, as mesh_bound per view and summed over the B views: the
    per-view rows and bboxes read once, the B maps written once; the one
    union binning of every (tile, triangle), and per view the operations
    of each kept candidate valid in that view over the pixels of its bbox
    in that view within its tile, and of the covered pixels."""
    from flame_tpu_torch.ops import rasterize
    B, T = packed.shape[:2]
    nty, ntx = grids.shape[1] // tile_h, grids.shape[2] // rasterize.TILE_W
    ok = packed[..., 13] > 0
    kvals, _ = rasterize._bin_tiles(
        rasterize.union_boxes(ok, bbox.unbind(-1)), ok.any(0), H, W, tile_h,
        min(max_per_tile, T))
    pairs = sum(_tile_pairs(kvals, bbox[b], ok[b], nty, ntx, tile_h)
                for b in range(B))
    covered = int((grids > -1e38).sum())
    return bound(4 * (packed.numel() + bbox.numel() + grids.numel()),
                 RASTER_BIN_OPS * T * nty * ntx + RASTER_PAIR_OPS * pairs
                 + RASTER_PIXEL_OPS * covered)


def _device_ms(fn, reps):
    """Mean milliseconds of the card's time for fn() over reps runs: the
    card sleeps while the host queues them, then runs them back to back
    between two CUDA events."""
    fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(QUEUE_SLEEP_CYCLES)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def _cuda_ms(fn, reps):
    """Mean milliseconds of fn() over reps runs, from CUDA events."""
    fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def environment():
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: chip_smoke.py runs on a GPU only")
    import importlib.util
    spec = importlib.util.find_spec("triton")
    triton_v = "absent"
    if spec is not None:
        import triton
        triton_v = triton.__version__
    print(f"python {sys.version.split()[0]} torch {torch.__version__} "
          f"cuda {torch.version.cuda} triton {triton_v}")
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    out = subprocess.run([nvcc, "--version"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print("nvcc:", out.splitlines()[-1])
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"device: {torch.cuda.get_device_name(0)} | {smi} | "
          f"count {torch.cuda.device_count()}")
    print(f"tf32: matmul {torch.backends.cuda.matmul.allow_tf32} "
          f"cudnn {torch.backends.cudnn.allow_tf32}")
    return smi


def build():
    from flame_tpu_torch import _kernels
    t0 = time.perf_counter()
    _kernels.load()
    libs = ", ".join(os.path.relpath(x)
                     for x in _kernels.BUILD_INFO["libraries"])
    print(f"build: {time.perf_counter() - t0:.2f} s "
          f"(parallel nvcc {_kernels.BUILD_INFO['seconds']:.2f} s) -> {libs}")
    for line in _kernels.BUILD_INFO["ptxas"].splitlines():
        if any(w in line for w in ("registers", "Compiling entry", "spill")):
            print("  ptxas:", line.strip())


def make_graph(dev, V=4096, E=12288, D=20, W=640, H=480):
    """Delaunay of V seeded points over W x H as a GraphState, with seeded
    primal/dual state; also returns the mesh (tris, n_tris)."""
    from flame_tpu_torch.mesh import delaunay
    from flame_tpu_torch.optimize import nltgv2, topology
    rng = np.random.default_rng(SEED)
    pts = rng.uniform([2, 2], [W - 2, H - 2], (V, 2)).astype(np.float32)
    tri = delaunay.triangulate(pts)
    edges = tri.edges.astype(np.int64)  # sorted (lo, hi) == code order
    n_e = edges.shape[0]
    d = pts[edges[:, 0]] - pts[edges[:, 1]]
    ranks = topology.build_edge_ranks(edges, V, E,
                                      tie=np.sqrt((d * d).sum(1)))
    edges_full = np.zeros((E, 2), np.int64)
    edges_full[:n_e] = edges
    t = lambda a, **kw: torch.as_tensor(a, device=dev, **kw)
    g = nltgv2.empty(V, E, D, dev)
    pos = t(pts)
    topo = topology.from_edges(t(edges_full), n_e, pos, g.edges, g.edge_mask,
                               g.q1, g.q2, g.q3, E, V, D, ranks=t(ranks))
    f32 = lambda a: t(a.astype(np.float32))
    em = np.arange(E) < n_e
    x = f32(rng.uniform(0.1, 0.3, V))
    g = g.replace(
        pos=pos, x=x, x_bar=x.clone(), w1=f32(rng.normal(0, 1e-3, V)),
        w2=f32(rng.normal(0, 1e-3, V)),
        data_term=f32(rng.uniform(0.1, 0.3, V)),
        data_weight=torch.ones(V, device=dev),
        vtx_mask=torch.ones(V, dtype=torch.bool, device=dev),
        edges=topo.edges, alpha=topo.alpha, beta=topo.edge_mask.float(),
        q1=f32(np.where(em, rng.uniform(-0.5, 0.5, E), 0)),
        q2=f32(np.where(em, rng.uniform(-0.5, 0.5, E), 0)),
        q3=f32(np.where(em, rng.uniform(-0.5, 0.5, E), 0)),
        edge_mask=topo.edge_mask, inc_edge=topo.inc_edge,
        inc_sign=topo.inc_sign, src_slot=topo.src_slot)
    g = g.replace(w1_bar=g.w1.clone(), w2_bar=g.w2.clone())
    return g, tri.triangles.astype(np.int64), pts


def check_smoother(g, n_iters=40):
    from flame_tpu_torch import _kernels
    from flame_tpu_torch.optimize import nltgv2, smoother_kernel
    p = __import__("flame_tpu_torch").RegularizerParams()
    tables, state = nltgv2.slot_prologue(g)
    weight = (p.data_factor * g.data_weight).contiguous()
    args = (p, tables, g.data_term, weight, g.vtx_mask)
    before = _kernels.LAUNCHES["nltgv2_smoother"]
    out_k = smoother_kernel.iterate(*args, state, n_iters)
    per_call = _kernels.LAUNCHES["nltgv2_smoother"] - before
    if per_call != 1:
        raise AssertionError(f"smoother: {per_call} launches for one call")
    out_p = nltgv2.iterate_plain(*args, state, n_iters)
    torch.cuda.synchronize()
    err = 0.0
    for name, a, b in zip(nltgv2.SmoothState._fields, out_k, out_p):
        torch.testing.assert_close(a, b, **K1_TOL, msg=f"smoother {name}")
        err = max(err, (a - b).abs().max().item())
    # Both copies of every live edge's duals must be bit-equal.
    V, D = g.inc_edge.shape
    E = g.q1.shape[0]
    dst = torch.full((E + 1,), V * D, dtype=torch.int64, device=g.x.device)
    flat = torch.arange(V * D, device=g.x.device)
    is_dst = g.inc_sign.reshape(-1) < 0
    dst[torch.where(is_dst, g.inc_edge.reshape(-1), E)] = flat
    dst = dst[:E]
    both = (g.src_slot < V * D) & (dst < V * D) & (g.inc_sign.reshape(-1)[
        torch.clamp(g.src_slot, max=V * D - 1)] > 0)
    n_pairs = int(both.sum())
    for q in out_k[6:]:
        qf = q.reshape(-1)
        s = qf[g.src_slot[both]]
        d = qf[dst[both]]
        if not torch.equal(s, d):
            raise AssertionError("smoother dual copies differ: "
                                 f"{int((s != d).sum())} of {n_pairs}")
    def kernel():
        return smoother_kernel.iterate(*args, state, n_iters)
    k_ms = _device_ms(kernel, 20)
    k_back_ms = _cuda_ms(kernel, 20)
    p_ms = _cuda_ms(lambda: nltgv2.iterate_plain(*args, state, n_iters), 5)
    plan = smoother_kernel._plan(g.x.device.index, V, D)
    print(f"K1 nltgv2_smoother V={V} D={D} E={int(g.edge_mask.sum())} "
          f"iters={n_iters}: max|kernel-plain| {err:.3g} "
          f"(rtol {K1_TOL['rtol']}, atol {K1_TOL['atol']}); "
          f"{n_pairs} dual pairs bit-equal; {per_call} launch per call "
          f"({plan.grid} CTAs of 1024 threads, {plan.vertices_per_warp} "
          f"vertices per warp)")
    print(f"K1 time V={V}: kernel {k_ms:.4f} ms per call on the card "
          f"({1000 * k_ms / n_iters:.2f} us/iter; {k_back_ms:.4f} ms per "
          f"call back to back, wrapper included), plain torch {p_ms:.4f} ms "
          f"({1000 * p_ms / n_iters:.2f} us/iter)")
    b = smoother_bound(V, D, int((tables.sgn != 0).sum()),
                       int(g.vtx_mask.sum()), n_iters, 13)
    print(f"K1 bound V={V}: {b['bound_ms']:.6f} ms per call, "
          f"{1000 * b['bound_ms'] / n_iters:.4f} us per iteration "
          f"({b['bound_by']})")
    return dict(max_abs_err=err, ms=k_ms, plain_ms=p_ms, **b)


def overflow_mesh(dev, W=640, H=480, V=4096, cluster=600):
    """A Delaunay mesh of V seeded points over W x H plus `cluster` points
    inside one 32x128 tile, whose overlap count passes 160."""
    from flame_tpu_torch.mesh import delaunay
    rng = np.random.default_rng(SEED + 3)
    pts = np.concatenate([
        rng.uniform([2, 2], [W - 2, H - 2], (V, 2)),
        rng.uniform([262, 194], [378, 222], (cluster, 2))]).astype(np.float32)
    tri = delaunay.triangulate(pts)
    return (torch.as_tensor(pts, device=dev),
            torch.as_tensor(tri.triangles.astype(np.int64), device=dev))


def check_raster(g, tris_np, W=640, H=480):
    """K2 through raster_kernel.rasterize_with_count against the plain
    rasterize.rasterize on the bench mesh and an overflowing one; times
    of the one launch and of the whole call on the bench mesh."""
    from flame_tpu_torch import _kernels
    from flame_tpu_torch.ops import raster_kernel, rasterize
    dev = g.x.device
    rng = np.random.default_rng(SEED + 1)
    cap = raster_kernel.MAX_PER_TILE
    bench = (g.pos, torch.as_tensor(tris_np, device=dev))
    err = 0.0
    for label, (pos, tris) in (("bench mesh", bench),
                               ("overflow mesh", overflow_mesh(dev, W, H))):
        T = tris.shape[0]
        vals = torch.as_tensor(rng.uniform(0.5, 2.0, pos.shape[0]),
                               dtype=torch.float32, device=dev)
        valid = torch.as_tensor(rng.uniform(size=T) > 0.02, device=dev)
        before = _kernels.LAUNCHES["raster_mesh"]
        out_k, count_k = raster_kernel.rasterize_with_count(
            pos, tris, vals, valid, H, W)
        launches = _kernels.LAUNCHES["raster_mesh"] - before
        out_p = rasterize.rasterize(pos, tris, vals, valid, H, W,
                                    max_per_tile=cap)
        count_p = int(rasterize.tile_candidates(
            pos, tris, vals, valid, H, W, max_per_tile=cap).max_count)
        torch.cuda.synchronize()
        nan_k, nan_p = torch.isnan(out_k), torch.isnan(out_p)
        if not torch.equal(nan_k, nan_p):
            raise AssertionError(f"raster {label}: NaN masks differ at "
                                 f"{int((nan_k != nan_p).sum())} pixels")
        m = ~nan_k
        e = (out_k[m] - out_p[m]).abs().max().item()
        if e > K2_ATOL or int(count_k) != count_p or launches != 1:
            raise AssertionError(
                f"raster {label}: max|kernel-plain| {e} (atol {K2_ATOL}), "
                f"max count {int(count_k)} vs plain {count_p}, {launches} "
                f"launches")
        if label == "overflow mesh" and count_p <= cap:
            raise AssertionError(f"raster {label}: no tile overflows")
        err = max(err, e)
        print(f"K2 raster_mesh {label} {W}x{H} T={T}: max|kernel-plain| "
              f"{e:.3g} (atol {K2_ATOL}), NaN masks equal, coverage "
              f"{m.float().mean().item():.4f}; max overlapping triangles "
              f"per tile {int(count_k)} = plain's (max_per_tile {cap}); "
              f"{launches} launch")
    pos, tris = bench
    vals = torch.as_tensor(rng.uniform(0.5, 2.0, pos.shape[0]),
                           dtype=torch.float32, device=dev)
    valid = torch.ones(tris.shape[0], dtype=torch.bool, device=dev)
    packed, bbox = raster_kernel.mesh_inputs(pos, tris, vals, valid)
    k_ms = _device_ms(lambda: raster_kernel.raster_mesh(packed, bbox, H, W),
                      50)
    k_back_ms = _cuda_ms(lambda: raster_kernel.raster_mesh(packed, bbox, H,
                                                           W), 50)
    ok = packed[:, 13] > 0
    p_ms = _cuda_ms(lambda: rasterize.eval_tiles(rasterize.bin_rows(
        packed, ok, bbox.unbind(1), H, W, 32, min(cap, tris.shape[0]))
        .cdata), 10)
    e2e_ms = _cuda_ms(lambda: raster_kernel.rasterize(
        pos, tris, vals, valid, H, W), 20)
    print(f"K2 time: the launch {k_ms:.4f} ms on the card ({k_back_ms:.4f} "
          f"ms back to back, wrapper included); plain bin_rows + eval_tiles "
          f"{p_ms:.4f} ms; the whole rasterize call (setup, launch, finish) "
          f"{e2e_ms:.4f} ms")
    b = mesh_bound(packed, bbox, raster_kernel.raster_mesh(packed, bbox, H,
                                                           W)[0], H, W)
    print(f"K2 bound: {b['bound_ms']:.6f} ms ({b['bound_by']})")
    return dict(max_abs_err=err, ms=k_ms, plain_ms=p_ms, **b)


K2B_VIEWS = (8, 1, 2, 3, 4)  # K2b's cluster holds the largest divisor <= 8


def raster_batch_views(g, tris_np, B, W=640, H=480):
    """B views of the bench mesh and of an overflowing one: per-view
    positions translated and slightly scaled, as a camera moving through a
    batch sees the batch-start mesh; per-view values; one view (the 4th,
    or the last of fewer) with a tenth of its triangles invalid. The same
    seed for every B, so B=8's inputs are the ones it always had."""
    dev = g.x.device
    rng = np.random.default_rng(SEED + 2)
    batches = {}
    for label, (pos, tris) in (
            ("bench batch", (g.pos, torch.as_tensor(tris_np, device=dev))),
            ("overflow batch", overflow_mesh(dev, W, H))):
        T = tris.shape[0]
        verts = torch.stack([pos * (1.0 + 0.01 * b) + torch.tensor(
            [3.0 * b, -2.0 * b], device=dev) for b in range(B)])
        vals = torch.as_tensor(rng.uniform(0.5, 2.0, (B, pos.shape[0])),
                               dtype=torch.float32, device=dev)
        valid_np = np.ones((B, T), bool)
        valid_np[min(3, B - 1), rng.integers(0, T, T // 10)] = False
        batches[label] = (verts, tris, vals,
                          torch.as_tensor(valid_np, device=dev))
    return batches


def check_raster_batch(g, tris_np, W=640, H=480):
    """K2b through raster_kernel.rasterize_batch_with_count against the
    plain union binning + eval_tiles_batch at every B of K2B_VIEWS (a
    cluster of that many CTAs per tile) on B views of the bench mesh and
    of an overflowing one; the one launch timed at each B, the whole call
    at B=8. Returns B=8's times and bound, the largest error of all."""
    from flame_tpu_torch import _kernels
    from flame_tpu_torch.ops import raster_kernel, rasterize
    cap = raster_kernel.MAX_PER_TILE_BATCH
    err, per_b = 0.0, {}
    for B in K2B_VIEWS:
        batches = raster_batch_views(g, tris_np, B, W, H)
        for label, (verts, tris, vals, valid) in batches.items():
            T = tris.shape[0]
            before = _kernels.LAUNCHES["raster_mesh_batch"]
            out_k, count_k = raster_kernel.rasterize_batch_with_count(
                verts, tris, vals, valid, H, W)
            launches = _kernels.LAUNCHES["raster_mesh_batch"] - before
            cand = rasterize.tile_candidates_batch(
                verts, tris, vals, valid, H, W, max_per_tile=cap)
            out_p = rasterize.finish(rasterize.eval_tiles_batch(cand.cdata),
                                     H, W)
            count_p = int(cand.max_count)
            torch.cuda.synchronize()
            nan_k, nan_p = torch.isnan(out_k), torch.isnan(out_p)
            if not torch.equal(nan_k, nan_p):
                raise AssertionError(
                    f"batched raster {label} B={B}: NaN masks differ at "
                    f"{int((nan_k != nan_p).sum())} pixels")
            m = ~nan_k
            e = (out_k[m] - out_p[m]).abs().max().item()
            if e > K2_ATOL or int(count_k) != count_p or launches != 1:
                raise AssertionError(
                    f"batched raster {label} B={B}: max|kernel-plain| {e} "
                    f"(atol {K2_ATOL}), max union count {int(count_k)} vs "
                    f"plain {count_p}, {launches} launches")
            if label == "overflow batch" and count_p <= cap:
                raise AssertionError(f"batched raster {label} B={B}: no "
                                     f"tile overflows")
            err = max(err, e)
            print(f"K2b raster_mesh_batch {label} B={B} {W}x{H} T={T}: "
                  f"max|kernel-plain| {e:.3g} (atol {K2_ATOL}), NaN masks "
                  f"equal, coverage {m.float().mean().item():.4f}; max "
                  f"union candidates per tile {int(count_k)} = plain's "
                  f"(max_per_tile {cap}); {launches} launch")
        verts, tris, vals, valid = batches["bench batch"]
        packed, bbox = raster_kernel.mesh_inputs(verts, tris, vals, valid)

        def launch():
            return raster_kernel.raster_mesh_batch(packed, bbox, H, W)
        k_ms = _device_ms(launch, 50)
        p_ms = _cuda_ms(lambda: rasterize.rasterize_batch(
            verts, tris, vals, valid, H, W, max_per_tile=cap), 3)
        b = batch_bound(packed, bbox, launch()[0], H, W)
        per_b[B] = dict(ms=k_ms, plain_ms=p_ms, **b)
        print(f"K2b time B={B}: the launch {k_ms:.4f} ms on the card, union "
              f"binning included; plain rasterize_batch (setup, union "
              f"binning, eval_tiles_batch) {p_ms:.4f} ms; bound "
              f"{b['bound_ms']:.6f} ms ({b['bound_by']})")
        if B != 8:
            continue
        k_back_ms = _cuda_ms(launch, 50)

        def whole():
            return raster_kernel.rasterize_batch(verts, tris, vals, valid,
                                                 H, W)
        e2e_ms = _device_ms(whole, 20)
        e2e_back_ms = _cuda_ms(whole, 20)
        print(f"K2b time B=8: the launch {k_back_ms:.4f} ms back to back, "
              f"wrapper included; the whole rasterize_batch call (setup, "
              f"launch, finish) {e2e_ms:.4f} ms on the card, "
              f"{e2e_back_ms:.4f} ms back to back")
    print("K2b per call by views (the launch on the card, ms): "
          + ", ".join(f"B={B} {per_b[B]['ms']:.4f}" for B in sorted(per_b)))
    return dict(max_abs_err=err, **per_b[8])


def rcm_tables(g, D, reach):
    """The RCM order, its inverse and the RCM-order edge ranks of
    make_graph's graph (ordered by edge length, as Flame orders them), as
    tensors on the graph's device."""
    from flame_tpu_torch.optimize import smoother_kernel
    V, E = g.x.shape[0], g.q1.shape[0]
    n_e = int(g.edge_mask.sum())
    edges = g.edges[:n_e].cpu().numpy()
    pos = g.pos.cpu().numpy()
    d = pos[edges[:, 0]] - pos[edges[:, 1]]
    perm = smoother_kernel.rcm_order(edges, n_e, V,
                                     g.vtx_mask.cpu().numpy())
    inv = np.empty(V, np.int32)
    inv[perm] = np.arange(V, dtype=np.int32)
    ranks = smoother_kernel.perm_edge_ranks(edges, n_e, inv, E, D, reach,
                                            tie=np.sqrt((d * d).sum(1)))
    t = lambda a: torch.as_tensor(a, device=g.x.device)
    return t(perm).long(), t(inv).long(), t(ranks)


def banded_layout(g, D=20, reach=K3_REACH):
    """make_graph's graph in the RCM-banded layout (ranks ordered by edge
    length, as Flame orders them), and the flat slot of each edge's dst
    dual copy."""
    from flame_tpu_torch.optimize import smoother_kernel
    perm, inv, ranks = rcm_tables(g, D, reach)
    lay = smoother_kernel.build_layout(g, perm, inv, ranks, D, reach)
    hi_p = inv[g.edges[:, 1]]
    dst = ((hi_p // 128) * D + ranks[:, 1].long()) * 128 + hi_p % 128
    n_e = int(g.edge_mask.sum())
    return lay, dst, int((ranks[:n_e, 0] == 255).sum())


def check_halo(g, k1, n_iters=40, reach=K3_REACH):
    """K3 at each partition count against its plain version, bit-equal
    across the counts, bit-equal dual copies; times per iteration."""
    from flame_tpu_torch import RegularizerParams
    from flame_tpu_torch.parallel import halo_kernel
    p = RegularizerParams()
    D = g.inc_edge.shape[1]
    V = g.x.shape[0]
    lay, dst, n_dropped = banded_layout(g, D, reach)
    outs, errs = {}, {}
    for n in K3_PARTS:
        out_k = halo_kernel.iterate(p, n_iters, D, reach, n, lay.vtx,
                                    lay.slots)
        out_p = halo_kernel.iterate_plain(p, n_iters, D, reach, n, lay.vtx,
                                          lay.slots)
        torch.cuda.synchronize()
        err = 0.0
        for name, a, b in zip(("x", "w1", "w2", "x_bar", "w1_bar", "w2_bar",
                               "q1", "q2", "q3"), out_k, out_p):
            torch.testing.assert_close(a, b, **K1_TOL,
                                       msg=f"halo n={n} {name}")
            err = max(err, (a - b).abs().max().item())
        outs[n], errs[n] = out_k, err
    for n in K3_PARTS[1:]:
        for k, (a, b) in enumerate(zip(outs[n], outs[1])):
            if not torch.equal(a, b):
                raise AssertionError(
                    f"halo output {k} at n={n} differs from n=1 at "
                    f"{int((a != b).sum())} entries")
    alive = lay.alive
    for q in outs[1][6:]:
        qf = q.reshape(-1)
        s, d = qf[lay.src_slot[alive]], qf[dst[alive]]
        if not torch.equal(s, d):
            raise AssertionError(f"halo dual copies differ: "
                                 f"{int((s != d).sum())} of "
                                 f"{int(alive.sum())}")
    k_ms, k_back_ms, p_ms = {}, {}, {}
    for n in K3_PARTS:
        def kernel():
            return halo_kernel.iterate(p, n_iters, D, reach, n, lay.vtx,
                                       lay.slots)
        k_ms[n] = _device_ms(kernel, 20)
        k_back_ms[n] = _cuda_ms(kernel, 20)
        p_ms[n] = _cuda_ms(lambda: halo_kernel.iterate_plain(
            p, n_iters, D, reach, n, lay.vtx, lay.slots), 3)
    plans = {n: halo_kernel._plan(g.x.device.index or 0, V, D, n, reach)
             for n in K3_PARTS}
    R = V // 128
    print(f"K3 halo_smoother V={V} D={D} R={R} reach={reach} "
          f"iters={n_iters} live edges {int(alive.sum())} "
          f"(band/degree dropped {n_dropped}): max|kernel-plain| "
          + ", ".join(f"n={n} {errs[n]:.3g}" for n in K3_PARTS)
          + f" (rtol {K1_TOL['rtol']}, atol {K1_TOL['atol']}); outputs at "
          f"n={K3_PARTS[1:]} bit-equal to n=1; {int(alive.sum())} dual "
          f"pairs bit-equal")
    print("K3 launch plan (CTAs of 1024 threads): "
          + ", ".join(f"n={n} {q.clusters} clusters of {q.cluster} CTAs "
                      f"({q.splits} per partition), {q.vertices_per_warp} "
                      f"vertices per warp, the card holds "
                      f"{q.max_active_clusters} such clusters"
                      for n, q in plans.items()))
    print("K3 time per call (one launch for all iterations, wrapper "
          "included): "
          + ", ".join(f"n={n} kernel {k_ms[n]:.4f} ms on the card "
                      f"({1000 * k_ms[n] / n_iters:.2f} us/iter; "
                      f"{k_back_ms[n]:.4f} ms back to back), plain "
                      f"{p_ms[n]:.4f} ms" for n in K3_PARTS)
          + f"; K1 kernel {1000 * k1['ms'] / n_iters:.2f} us/iter, plain "
          f"{1000 * k1['plain_ms'] / n_iters:.2f}")
    b = smoother_bound(V, D, 2 * int(alive.sum()), int(g.vtx_mask.sum()),
                       n_iters, 14)
    print(f"K3 bound: {1000 * b['bound_ms']:.3f} us for {n_iters} "
          f"iterations ({b['bound_by']})")
    n = MESH_PARTS
    return dict(max_abs_err=max(errs.values()), ms=k_ms[n], plain_ms=p_ms[n],
                **b)


def bench_params():
    """bench.py's VGA x 4096 configuration with the synchronous overrides
    and photo_error_num_pfs=0."""
    from flame_tpu_torch import DetectionParams, Params, SolverParams
    return Params(
        feature_capacity=4096, edge_capacity=12288, triangle_capacity=8192,
        poseframe_capacity=16, min_height=-1e6, max_height=1e6,
        idepth_init=0.05, min_baseline=0.01, photo_error_num_pfs=0,
        detection=DetectionParams(win_size=16),
        solver=SolverParams(max_vertex_degree=20, n_iters_per_frame=40,
                            pallas_reach=K3_REACH, async_topology=False,
                            frame_batch=1),
        do_ba=False)


def throughput_params():
    """bench.py's VGA x 4096 configuration as bench.py runs it
    (bench.py:69-140): async topology, frame_batch=8, topology_lag=2,
    join_age=24, max_consecutive_sheds=8, photo_error_num_pfs=30."""
    from flame_tpu_torch import SolverParams
    p = bench_params()
    return p.replace(photo_error_num_pfs=30, solver=SolverParams(
        max_vertex_degree=20, n_iters_per_frame=40, pallas_reach=K3_REACH,
        async_topology=True, frame_batch=8, topology_lag=2, join_age=24,
        max_consecutive_sheds=8))


def with_smoother(params, smoother):
    import dataclasses
    return params.replace(solver=dataclasses.replace(params.solver,
                                                     smoother=smoother))


def make_flame(K, Kinv, params, sharded):
    """Flame, or with sharded ShardedFlame with smoother="pallas_halo" on
    MESH_PARTS partitions of the card."""
    import flame_tpu_torch
    from flame_tpu_torch.parallel import sharding
    from flame_tpu_torch.parallel.orchestrator import ShardedFlame
    if sharded:
        return ShardedFlame(W, H, K, Kinv,
                            with_smoother(params, "pallas_halo"),
                            mesh=sharding.make_mesh(MESH_PARTS))
    return flame_tpu_torch.Flame(W, H, K, Kinv, params)


def step_launches(sharded):
    """Launches per post-Delaunay step: {kernel: count}."""
    if sharded:
        return {"halo_smoother": 1, "nltgv2_smoother": 0, "raster_mesh": 1}
    return {"nltgv2_smoother": 1, "halo_smoother": 0, "raster_mesh": 1}


def drop_counts(fl):
    return ", ".join(f"{k} {int(fl.stats.stats(k))}" for k in (
        "edges_rank_dropped", "edges_band_dropped", "edges_degree_dropped"))


W, H = 640, 480
FX = 525.0
PLANE_Z = 5.0


def scene(n_frames):
    """K, Kinv and the bench's textured plane at 5 m as uint8 frames, the
    camera moving 8 cm per frame."""
    from flame_tpu_torch.bench import renderer
    K = np.array([[FX, 0, W / 2], [0, FX, H / 2], [0, 0, 1]], np.float32)
    Kinv = np.linalg.inv(K.astype(np.float64)).astype(np.float32)
    render = renderer(W, H)
    return K, Kinv, [render(0.08 * i) for i in range(n_frames)]


def resident_scene(n_frames):
    """scene(n_frames) with the frames already on the card."""
    K, Kinv, frames = scene(n_frames)
    frames = [torch.as_tensor(f, device="cuda") for f in frames]
    torch.cuda.synchronize()
    return K, Kinv, frames


def pose(i):
    return np.array([1.0, 0, 0, 0]), np.array([0.08 * i, 0.0, 0.0])


def check_map(fl, label):
    """Coverage and median relative error of the final dense map; gates
    phase 6's bounds and returns both."""
    idm = fl.get_inverse_depth_map()
    cov, err = map_errors(idm, 1.0 / PLANE_Z)
    print(f"{label}: coverage {cov:.4f} (>= 0.5), median relative idepth "
          f"error {err:.5f} (<= 0.01); features {fl._n_valid}, vertices "
          f"{fl._n_members}, triangles {fl._n_tris}, edges {fl._n_edges}")
    if not (cov >= 0.5 and err <= 0.01 and np.isfinite(idm[~np.isnan(idm)])
            .all()):
        raise AssertionError(f"{label}: output out of bounds")
    return cov, err


def map_errors(idm, truth):
    """Coverage and median relative idepth error of a map against the
    true idepth (a number or a per-pixel map)."""
    ok = ~np.isnan(idm)
    truth = np.broadcast_to(truth, idm.shape)
    return (float(ok.mean()),
            float(np.median(np.abs(idm[ok] - truth[ok]) / truth[ok])))


def stage_medians(fl, names, skip, last=None):
    """Median CUDA-event ms of each stage, less its first skip entries;
    last: of its last entries only (a run's batched steps, after the
    single frames of its bootstrap)."""
    dev_ms = fl.stats.device_times_ms()
    parts = []
    for name in names:
        v = dev_ms.get(name, [])
        v = v[-last:] if last else v
        v = v[skip:] if len(v) > skip else v
        parts.append(f"{name} {np.median(v):.3f}" if v else f"{name} -")
    return ", ".join(parts)


def main_path(smi, n_frames=30, sharded=False, ref_map=None):
    """The synchronous path; sharded: through ShardedFlame with K3, its
    final map held to ref_map (the vertex-smoother run's)."""
    from flame_tpu_torch import _kernels
    K, Kinv, frames = scene(n_frames)
    fl = make_flame(K, Kinv, bench_params(), sharded)
    per_step = step_launches(sharded)
    _kernels.reset_launches()
    frame_ms, meshed = [], 0
    for i in range(n_frames):
        before = dict(_kernels.LAUNCHES)
        t0 = time.perf_counter()
        ok = fl.update(i / 30.0, i, pose(i), frames[i], i % 2 == 0)
        torch.cuda.synchronize()
        dt = 1000 * (time.perf_counter() - t0)
        if ok:
            meshed += 1
            frame_ms.append(dt)
            ds = {k: _kernels.LAUNCHES[k] - before[k] for k in per_step}
            if ds != per_step:
                raise AssertionError(f"frame {i}: launches {ds} (want "
                                     f"{per_step})")
    launches = dict(_kernels.LAUNCHES)
    if meshed < n_frames // 2:
        raise AssertionError(f"only {meshed} of {n_frames} frames meshed")
    for name in [k for k, v in per_step.items() if v]:
        if launches[name] < 1:
            raise AssertionError(f"{name} never ran on the synchronous path")

    label = (f"sharded main path (pallas_halo, {MESH_PARTS} partitions)"
             if sharded else "main path")
    check_map(fl, f"{label} 640x480, 4096 features, {n_frames} frames "
                  f"({meshed} meshed)")
    idm = fl.get_inverse_depth_map()
    if ref_map is not None:
        both = ~np.isnan(idm) & ~np.isnan(ref_map)
        diff = float(np.median(np.abs(idm[both] - ref_map[both])))
        print(f"{label}: median |idepth - vertex-smoother idepth| {diff:.3g}"
              f" (< 1e-4) over {both.mean():.4f} of the pixels; "
              f"{drop_counts(fl)}")
        if not (diff < 1e-4 and both.mean() > 0.5):
            raise AssertionError(f"{label}: map departs from the vertex "
                                 f"smoother's run")
    from flame_tpu_torch.ops import raster_kernel, rasterize
    g, tris = fl._graph, fl._tris
    tri_mask = (torch.arange(tris.shape[0], device=tris.device)
                < fl._n_tris) & g.vtx_mask[tris].all(1)
    cand = rasterize.tile_candidates(g.pos, tris, fl._vtx_idepths, tri_mask,
                                     H, W)
    print(f"main path final mesh: max candidates per tile "
          f"{int(cand.max_count)} of max_per_tile "
          f"{raster_kernel.MAX_PER_TILE}")
    skip = 4  # the first meshed frames include one-time allocations
    print(f"{label} median ms per stage (CUDA events) on {smi}: "
          + stage_medians(fl, ("frame_creation", "update_idepths",
                               "triangulate", "sync_graph", "smoother",
                               "raster"), skip))
    print(f"{label} median frame {np.median(frame_ms[skip:]):.3f} ms "
          f"(host wall incl. synchronize, frames {skip + 1}-{meshed} of "
          f"the meshed) on {smi}; launches {launches}")
    return launches, idm


def batch_overflow(fl, first_frame):
    """The next batch's 8 views (frames first_frame.. with the scene's
    poses) of the final mesh, projected as pipeline.batch_step projects
    it: the largest union-bbox candidate count per tile, and the share of
    the pixels that per-view binning without a cap covers which the
    shared binning at MAX_PER_TILE_BATCH leaves empty."""
    from flame_tpu_torch.core import pipeline
    from flame_tpu_torch.ops import raster_kernel, rasterize
    dev = fl.device
    B = fl.params.solver.frame_batch
    qt = [[torch.as_tensor(x, dtype=torch.float32, device=dev)
           for x in pose(first_frame + b)] for b in range(B)]
    tris = fl._tris
    pos, idp, tri_ok = pipeline.project_views(
        fl.K, fl.Kinv, fl._graph, fl._graph_scale, *fl._last_sync_pose,
        torch.stack([q for q, _ in qt]), torch.stack([t for _, t in qt]),
        tris, fl._n_tris)
    cand = rasterize.tile_candidates_batch(
        pos, tris, idp, tri_ok, H, W,
        max_per_tile=raster_kernel.MAX_PER_TILE_BATCH)
    shared = rasterize.finish(rasterize.eval_tiles_batch(cand.cdata), H, W)
    full = torch.stack([rasterize.rasterize(pos[b], tris, idp[b], tri_ok[b],
                                            H, W, max_per_tile=1024)
                        for b in range(B)])
    covered = ~torch.isnan(full)
    lost = (covered & torch.isnan(shared)).sum().item() \
        / max(covered.sum().item(), 1)
    return int(cand.max_count), lost


def throughput_path(smi, mode, n_frames=96, sharded=False, params=None,
                    label=None):
    """The batched async path over n_frames with 'resident' (uint8 on the
    card, staged before the run) or 'host' (numpy uint8) frames;
    sharded: through ShardedFlame with K3; params: instead of
    throughput_params(); label: a prefix of the printed lines."""
    from flame_tpu_torch import _kernels
    K, Kinv, frames = (resident_scene if mode == "resident"
                       else scene)(n_frames)
    fl = make_flame(K, Kinv, params or throughput_params(), sharded)
    p = fl.params
    B = p.solver.frame_batch
    _kernels.reset_launches()
    batch_ms, t_group = [], None
    t_run = time.perf_counter()
    for i in range(n_frames):
        if t_group is None:
            t_group = time.perf_counter()
        d0 = fl._dispatches
        fl.update(i / 30.0, i, pose(i), frames[i], i % 2 == 0)
        if fl._dispatches != d0:
            torch.cuda.synchronize()
            batch_ms.append(1000 * (time.perf_counter() - t_group) / B)
            t_group = None
        elif not fl._batch_pending:  # a frame of the single path
            t_group = None
    label = ((f"{label} " if label else "")
             + f"{'sharded ' if sharded else ''}throughput path ({mode} "
             "frames"
             + (f", pallas_halo, {MESH_PARTS} partitions" if sharded else "")
             + f") 640x480, 4096 features, {n_frames} frames")
    check_map(fl, label)  # flushes the frames still buffered
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t_run
    launches = dict(_kernels.LAUNCHES)

    n_post = len(fl.stats.device_times_ms().get("sync_graph", []))
    evictions = int(fl.stats.stats("pf_evictions"))
    if not (fl._dispatches >= 1
            and launches["raster_mesh_batch"] == fl._dispatches):
        raise AssertionError(f"{mode}: raster_mesh_batch launches "
                             f"{launches['raster_mesh_batch']} vs "
                             f"{fl._dispatches} batched steps")
    per_step = step_launches(sharded)
    if any(launches[k] != v * n_post for k, v in per_step.items()) \
            or n_post < 1:
        raise AssertionError(f"{mode}: launches "
                             f"{ {k: launches[k] for k in per_step} } for "
                             f"{n_post} post-Delaunay steps")
    if evictions < 1:
        raise AssertionError(f"{mode}: no poseframe was evicted")
    skip = 2  # the first batches include one-time allocations
    lat = fl.latency_percentiles()
    from flame_tpu_torch.ops import raster_kernel
    print(f"{label}: {fl._dispatches} batched steps, {n_post} post-Delaunay "
          f"steps, {evictions} poseframe evictions, "
          f"{int(fl.stats.stats('packed_sheds'))} shed snapshots; "
          f"launches {launches}; run {run_s:.2f} s; {drop_counts(fl)}")
    run_max = fl.failure_stats()["raster_max_union_candidates"]
    nxt_max, lost = batch_overflow(fl, n_frames)
    steps = [int(c) for c in fl._raster_union]
    print(f"{label}: batched raster union candidates per tile, per step "
          f"{steps}, max {run_max} of {raster_kernel.MAX_PER_TILE_BATCH}; "
          f"final mesh "
          f"in the next batch's views {nxt_max}, leaving {100 * lost:.3f}% "
          f"of the covered pixels empty")
    print(f"{label}: median ms per frame {np.median(batch_ms[skip:]):.3f} "
          f"(batch wall incl. synchronize / {B}, batches {skip + 1}-"
          f"{len(batch_ms)}); update->map latency p50/p95 "
          + (f"{lat[0]:.3f}/{lat[1]:.3f} ms" if lat else "none")
          + f" on {smi}")
    print(f"{label}: median ms per batched step (CUDA events) on {smi}: "
          + stage_medians(fl, ("raster_batch", "update_idepths",
                               "sync_graph", "smoother", "raster",
                               "topo_upload"), skip))
    return launches


# Phase 9: the dataset path (mini-TUM -> io.datasets.load_tum ->
# run_sequence -> Flame), with and without bundle adjustment.
DS_NOISE = dict(pose_noise_t=0.015, pose_noise_deg=0.3, noise_seed=1)
VGA_FX = 517.3  # TUM fr1's focal length (px), at 640x480
# The JAX package's final-map median relative error on the 640x480
# true-pose run (run_dataset's Params and BA, async topology, the input of
# dataset_path's 640x480 cell), from tests/torch_dataset_witness.py on the
# CPU. DATASETS.md's 0.04 holds for neither package there: the maps of the
# frames between poseframes read up to 12% under async topology in both
# (ROADMAP section 3), and the final frame is one of those. So that cell
# gates coverage only and prints the error beside this value.
VGA_JAX_MAP_ERR = 0.22313


def mini_tum_params(do_ba):
    """tests/test_dataset_accuracy.py's configuration (:21-30), the one
    DATASETS.md measures."""
    from flame_tpu_torch import (BAParams, DetectionParams, Params,
                                 SolverParams)
    return Params(
        feature_capacity=1024, edge_capacity=4096, triangle_capacity=2048,
        poseframe_capacity=8, min_height=-100.0, max_height=100.0,
        idepth_init=0.2, idepth_var_init=0.25,
        detection=DetectionParams(win_size=12),
        solver=SolverParams(n_iters_per_frame=40, max_vertex_degree=16),
        do_ba=do_ba, ba=BAParams(window_size=6), debug_quiet=True)


def vga_params(do_ba):
    """run_dataset's Params at TUM's focal length (the re-match radius
    scaled to 8 px)."""
    from flame_tpu_torch import run_dataset
    return run_dataset.make_params(do_ba, VGA_FX)


def dataset_run(root, n_frames, params, K, poses, poseframe_every,
                mesh=None):
    """load_tum + run_sequence on the card, substituting poses (the noisy
    track) when given; through ShardedFlame on mesh when given. Records
    each update's host wall time and each BA solve's time between CUDA
    events (read after the run) and host time; nothing waits for the card
    inside the run apart from the sharded solves, which apply at once, so
    the async topology and BA keep the schedule they have without the
    script."""
    import flame_tpu_torch
    from flame_tpu_torch.geometry import camera
    from flame_tpu_torch.io import datasets
    frames = datasets.load_tum(root, max_frames=n_frames)
    if len(frames) != n_frames:
        raise AssertionError(f"load_tum: {len(frames)} of {n_frames} frames")
    if poses is not None:
        for fr, (q, t) in zip(frames, poses):
            fr.q = np.asarray(q, np.float32)
            fr.t = np.asarray(t, np.float32)
    H_, W_ = frames[0].load_image().shape
    Kt = torch.as_tensor(K, dtype=torch.float32)
    if mesh is None:
        fl = flame_tpu_torch.Flame(W_, H_, Kt, camera.inv_k(Kt), params)
    else:
        from flame_tpu_torch.parallel.orchestrator import ShardedFlame
        fl = ShardedFlame(W_, H_, Kt, camera.inv_k(Kt), params, mesh=mesh)
    frame_ms, staged = [], []
    update = fl.update

    def timed_update(*args):
        t0 = time.perf_counter()
        ok = update(*args)
        frame_ms.append(1000 * (time.perf_counter() - t0))
        return ok
    fl.update = timed_update
    if fl._ba is not None:
        stage = fl._ba._stage_solve

        def solves(flame):
            return flame.stats.stats("ba_single_solves") \
                + flame.stats.stats("ba_sharded_solves")

        def timed_stage(flame):
            n0 = solves(flame)
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            t0 = time.perf_counter()
            ev[0].record()
            stage(flame)
            ev[1].record()
            if solves(flame) > n0:
                staged.append((ev, 1000 * (time.perf_counter() - t0)))
        fl._ba._stage_solve = timed_stage
    out = datasets.run_sequence(fl, frames, poseframe_every=poseframe_every)
    torch.cuda.synchronize()
    solve_ms = [(ev[0].elapsed_time(ev[1]), host) for ev, host in staged]
    del fl.update  # the wrappers refer to fl: no cycle is left behind
    if fl._ba is not None:
        del fl._ba._stage_solve
    return fl, out, frame_ms, solve_ms


def pf_ate(fl, gt):
    """ATE (m, Umeyama-aligned) of the poseframes' final positions."""
    from flame_tpu_torch.utils import evaluation
    ids = sorted(fl._pf_slot_by_id)
    t = fl._stack.t[[fl._pf_slot_by_id[i] for i in ids]].cpu().numpy()
    return evaluation.ate_rmse(t, np.asarray([gt[i][1] for i in ids]))


def check_ba_graph(smi, p=None, label=""):
    """The BA window solve (ba.window._solve_packed at BAParams' default
    L=1024, M=4096; p: other BAParams) replayed from the graph runner
    (window._solve_graphed, kind "ba") against its eager run on
    well-posed windows of 3 and 8 poses: the flat result within 1e-4
    relative (the sums use atomics; two eager runs are compared the same
    way), one capture per window size, times of both; label: a prefix of
    the printed lines."""
    from flame_tpu_torch import BAParams, step_graph
    from flame_tpu_torch.ba import window
    dev = torch.device("cuda")
    p = BAParams() if p is None else p
    L, M = p.max_landmarks, p.max_obs
    Kn = np.array([[FX, 0, W / 2], [0, FX, H / 2], [0, 0, 1]])
    K = torch.tensor(Kn, dtype=torch.float32, device=dev)
    Kinv = torch.linalg.inv(K)
    img = torch.as_tensor(np.random.default_rng(SEED).uniform(
        0, 255, (8, H + 10, W + 10)), dtype=torch.float32, device=dev)
    steps = step_graph.Steps(step_graph.cuda_capture)
    for P in (3, 8):
        buf = torch.as_tensor(window.well_posed_window(P, L, M, Kn, P,
                                                       (40, 440)), device=dev)

        def solve(b):
            return window._solve_packed(p, K, Kinv, b, img, 5, 2, P, L, M)

        def graphed(b):
            return window._solve_graphed(steps, p, K, Kinv, b, img, 5, 2, P,
                                         L, M)
        ref = solve(buf)
        t0 = time.perf_counter()
        out = graphed(buf)
        torch.cuda.synchronize()
        capture_ms = 1000 * (time.perf_counter() - t0)
        torch.testing.assert_close(out, ref, rtol=1e-4, atol=1e-5,
                                   msg=f"graphed BA solve, {P} poses")
        err = (out - ref).abs().max().item()
        eager_ms = _cuda_ms(lambda: solve(buf), 3)
        replay_ms = _cuda_ms(lambda: graphed(buf), 10)
        card_ms = _device_ms(lambda: graphed(buf), 10)
        print(f"{label}BA window solve, {P} poses, L={L}, M={M}: "
              f"max|graph-eager| "
              f"{err:.3g} (rtol 1e-4); eager {eager_ms:.3f} ms, graph replay "
              f"{replay_ms:.3f} ms back to back, {card_ms:.3f} ms on the "
              f"card; first call (warm-up, capture, replay) "
              f"{capture_ms:.1f} ms; on {smi}")
    if steps.counts.get("ba_graph_captures") != 2 \
            or "ba_graph_eager" in steps.counts:
        raise AssertionError(f"{label}BA graph counters {steps.counts}")


def dataset_path(smi, label, n_frames, width, height, fx, poseframe_every,
                 specs, gate_err=True, extra=None):
    """mini-TUM generated with 15 mm / 0.3 deg pose noise, run once per
    spec (name, noisy, params) on the true or the noisy poses; the specs
    are "true", "noisy" and "noisy_ba", the last with BA. Gates: the final
    map of the "true" run covers > 0.35 of the pixels with median relative
    error < 0.04 (tests/test_dataset_accuracy.py; the error only with
    gate_err, else printed beside the JAX package's VGA_JAX_MAP_ERR);
    "noisy_ba" cuts the ATE of "noisy" below 0.8x and applied at least one
    solve; K1 and K2 launch once per post-Delaunay step in every run.
    extra(root, meta, runs), when given, runs inside the same temporary
    directory after the specs; its result is returned beside the launch
    counts."""
    from flame_tpu_torch import _kernels
    from flame_tpu_torch.io import synthetic
    from flame_tpu_torch.utils import evaluation
    with tempfile.TemporaryDirectory() as root:
        t0 = time.perf_counter()
        meta = synthetic.generate_mini_tum(root, n_frames=n_frames,
                                           width=width, height=height, fx=fx,
                                           **DS_NOISE)
        gen_s = time.perf_counter() - t0
        K = meta["K"]
        _, gt_idm = synthetic.render_frame(
            K, *synthetic.trajectory(n_frames - 1), width, height)
        runs, launches = {}, {k: 0 for k in _kernels.LAUNCHES}
        for name, noisy, params in specs:
            _kernels.reset_launches()
            fl, out, frame_ms, solve_ms = dataset_run(
                root, n_frames, params, K, meta["noisy"] if noisy else None,
                poseframe_every)
            got = dict(_kernels.LAUNCHES)
            n_post = len(fl.stats.device_times_ms().get("sync_graph", []))
            if n_post < 1 or got["nltgv2_smoother"] != n_post \
                    or got["raster_mesh"] != n_post:
                raise AssertionError(f"{label} {name}: launches {got} for "
                                     f"{n_post} post-Delaunay steps")
            for k in launches:
                launches[k] += got[k]
            runs[name] = dict(
                fl=fl, out=out, frame_ms=frame_ms, solve_ms=solve_ms,
                n_post=n_post, ate=pf_ate(fl, meta["gt"]),
                err=evaluation.depth_error_stats(fl.get_inverse_depth_map(),
                                                 gt_idm))
        more = extra(root, meta, runs) if extra is not None else None
    print(f"{label}: generated in {gen_s:.2f} s")
    skip = 4  # the first updates include one-time allocations
    for name, r in runs.items():
        st = r["fl"].stats
        print(f"{label} {name}: coverage {r['err']['coverage']:.4f}, median "
              f"relative error {r['err']['median_rel']:.5f}, ATE "
              f"{1000 * r['ate']:.3f} mm; BA solves staged "
              f"{int(st.stats('ba_single_solves'))}, applied "
              f"{int(st.stats('ba_solves_applied'))}, write-back skips "
              f"{int(st.stats('ba_writeback_skips'))}, observations dropped "
              f"for {int(st.stats('ba_obs_dropped_pfs'))} poseframes")
        print(f"{label} {name}: median update "
              f"{np.median(r['frame_ms'][skip:]):.3f} ms (host wall, updates "
              f"{skip + 1}-{len(r['frame_ms'])}), {r['n_post']} post-Delaunay "
              f"steps, run_sequence {r['out']['fps']:.2f} fps, on {smi}")
        print(f"{label} {name}: median ms per stage (CUDA events) on {smi}: "
              + stage_medians(r["fl"], ("update_idepths", "sync_graph",
                                        "smoother", "raster", "ba"), skip))
        if r["solve_ms"]:
            dev_ms, host_ms = np.median(np.asarray(r["solve_ms"]), axis=0)
            print(f"{label} {name}: median staged BA solve {dev_ms:.3f} ms "
                  f"between CUDA events, {host_ms:.3f} ms host staging "
                  f"({len(r['solve_ms'])} solves) on {smi}")
    err, nz, ba = runs["true"]["err"], runs["noisy"], runs["noisy_ba"]
    ratio = ba["ate"] / nz["ate"]
    print(f"{label}: gates: true final map coverage {err['coverage']:.4f} "
          f"(> 0.35), median relative error {err['median_rel']:.5f} "
          + ("(< 0.04)" if gate_err else
             f"(not gated: the JAX package's on this input "
             f"{VGA_JAX_MAP_ERR}, tests/torch_dataset_witness.py)")
          + f"; ATE noisy_ba / noisy {ratio:.4f} (< 0.8)")
    if not (err["coverage"] > 0.35
            and (err["median_rel"] < 0.04 or not gate_err)
            and nz["ate"] > 0.005
            and ratio < 0.8
            and ba["fl"].stats.stats("ba_solves_applied") >= 1):
        raise AssertionError(f"{label}: dataset gates failed")
    return launches if extra is None else (launches, more)


# Phase 10: the API residue.
AUTO_PF_MAX_DISPARITY = 16.0  # Params' default (px at auto_pf_depth)
CKPT_SAVE_AFTER = 12  # frame id after which the checkpoint phase saves
CKPT_MORE = 12  # frames both runs continue for


def auto_pf_range(n_frames):
    """The poseframe counts the disparity test allows over n_frames of
    scene(): the probe at the plane's depth moves FX * 0.08 / PLANE_Z px
    per frame, so a poseframe follows every k = ceil(max / step) frames
    after the first (one more frame either way at bootstrap and across a
    batch)."""
    k = math.ceil(AUTO_PF_MAX_DISPARITY / (FX * 0.08 / PLANE_Z))
    return n_frames // (k + 1), -(-n_frames // k) + 1


def auto_poseframe_path(smi, mode, n_frames):
    """scene()'s plane with auto_poseframe: the synchronous path ("sync",
    phase 6's Params) or the throughput path with host frames ("host",
    phase 7's). Gates: the count of declared poseframes within
    auto_pf_range, phase 6's map bounds, K1 and K2 once per post-Delaunay
    step and K2b once per batched step."""
    import flame_tpu_torch
    from flame_tpu_torch import _kernels
    K, Kinv, frames = scene(n_frames)
    base = bench_params() if mode == "sync" else throughput_params()
    fl = flame_tpu_torch.Flame(W, H, K, Kinv, base.replace(
        auto_poseframe=True, auto_pf_max_disparity=AUTO_PF_MAX_DISPARITY,
        auto_pf_depth=PLANE_Z))
    want_ms = []
    want = fl._want_poseframe

    def timed_want(q, t):
        t0 = time.perf_counter()
        out = want(q, t)
        want_ms.append(1000 * (time.perf_counter() - t0))
        return out
    fl._want_poseframe = timed_want
    declared, seen = [], set()

    def note_new():
        new = set(fl._pf_slot_by_id) - seen
        declared.extend(sorted(new))
        seen.update(new)
    _kernels.reset_launches()
    t_run = time.perf_counter()
    for i in range(n_frames):
        fl.update(i / 30.0, i, pose(i), frames[i], None)
        note_new()
    path = "synchronous" if mode == "sync" else "throughput (host frames)"
    label = (f"auto-poseframe {path} path 640x480, 4096 features, "
             f"{n_frames} frames")
    check_map(fl, label)  # flushes the frames still buffered
    note_new()
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t_run
    launches = dict(_kernels.LAUNCHES)
    del fl._want_poseframe  # the wrapper refers to fl
    n_post = len(fl.stats.device_times_ms().get("sync_graph", []))
    per_step = step_launches(False)
    lo, hi = auto_pf_range(n_frames)
    print(f"{label}: poseframes declared at frames {declared} ({len(declared)}"
          f", allowed {lo}-{hi}); {fl._dispatches} batched steps, {n_post} "
          f"post-Delaunay steps, {int(fl.stats.stats('pf_evictions'))} "
          f"evictions; launches {launches}; run {run_s:.2f} s; "
          f"_want_poseframe median {np.median(want_ms):.4f} ms host "
          f"({len(want_ms)} calls) on {smi}")
    if not lo <= len(declared) <= hi:
        raise AssertionError(f"{label}: {len(declared)} poseframes")
    if n_post < 1 or any(launches[k] != v * n_post
                         for k, v in per_step.items()):
        raise AssertionError(f"{label}: launches {launches} for {n_post} "
                             f"post-Delaunay steps")
    if launches["raster_mesh_batch"] != fl._dispatches \
            or (mode == "host") != (fl._dispatches > 0):
        raise AssertionError(f"{label}: raster_mesh_batch launches "
                             f"{launches['raster_mesh_batch']} for "
                             f"{fl._dispatches} batched steps")
    return fl, launches


def check_filtered_map(fl):
    """get_filtered_inverse_depth_map (K2) against the plain tiled
    rasterizer (rasterize.rasterize, torch ops on the card) over the
    same triangles: the first n_tris that pass the triangle filters."""
    from flame_tpu_torch import _kernels
    from flame_tpu_torch.ops import rasterize
    tri_ok = (torch.arange(fl._tris.shape[0], device=fl.device)
              < fl._n_tris) & fl._tri_validity
    plain = rasterize.rasterize(fl._graph.pos, fl._tris, fl._vtx_idepths,
                                tri_ok, H, W).cpu().numpy()
    n0 = _kernels.LAUNCHES["raster_mesh"]
    got = fl.get_filtered_inverse_depth_map()
    if _kernels.LAUNCHES["raster_mesh"] != n0 + 1:
        raise AssertionError("filtered map: raster_mesh did not launch once")
    same_mask = bool((np.isnan(got) == np.isnan(plain)).all())
    ok = ~np.isnan(plain)
    err = float(np.abs(got[ok] - plain[ok]).max()) if ok.any() else 0.0
    full = float(np.mean(~np.isnan(fl.get_inverse_depth_map())))
    print(f"filtered map (K2) vs plain rasterizer: masks equal {same_mask}, "
          f"max |diff| {err:.3g} (<= 1e-6); filtered coverage "
          f"{ok.mean():.4f} of the dense map's {full:.4f}; "
          f"{int(tri_ok.sum())} of {fl._n_tris} triangles pass the filters")
    if not (same_mask and err <= 1e-6 and ok.mean() > 0.3):
        raise AssertionError("filtered map departs from the plain version")


def _ckpt_state(fl):
    """The arrays a continued run computes from, on the host."""
    g, f, st = fl._graph, fl._feats, fl._stack
    return {k: v.detach().cpu().numpy() for k, v in dict(
        idepthmap=fl._idepthmap, idepth_mu=f.idepth_mu,
        idepth_var=f.idepth_var, xy=f.xy, valid=f.valid, x=g.x, q1=g.q1,
        w1=g.w1, pf_q=st.q, pf_t=st.t, img_pad=st.img_pad).items()}


def _ckpt_diff(a, b):
    """Largest |difference| per array (NaN positions must agree)."""
    out = {}
    for k in a:
        x, y = a[k].astype(np.float64), b[k].astype(np.float64)
        if not (np.isnan(x) == np.isnan(y)).all():
            out[k] = float("inf")
            continue
        m = ~np.isnan(x)
        out[k] = float(np.abs(x[m] - y[m]).max()) if m.any() else 0.0
    return out


def checkpoint_path(smi):
    """A deterministic throughput run with BA (mini-TUM 256x192, phase 9's
    configuration with async topology, frame_batch=4, solver.deterministic)
    under torch.use_deterministic_algorithms: checkpoint.save after frame
    CKPT_SAVE_AFTER, load into a fresh Flame on the card, then both
    continue for CKPT_MORE frames. Gates: bit-equal right after load and
    after continuing; a BA solve staged after the save."""
    import dataclasses
    import flame_tpu_torch
    from flame_tpu_torch import _kernels
    from flame_tpu_torch.geometry import camera
    from flame_tpu_torch.io import datasets, synthetic
    from flame_tpu_torch.utils import checkpoint
    n = CKPT_SAVE_AFTER + 1 + CKPT_MORE
    p = mini_tum_params(True)
    params = p.replace(solver=dataclasses.replace(
        p.solver, async_topology=True, frame_batch=4, deterministic=True))
    with tempfile.TemporaryDirectory() as root:
        meta = synthetic.generate_mini_tum(root, n_frames=n, width=256,
                                           height=192, fx=210.0)
        frames = datasets.load_tum(root, max_frames=n)
        imgs = [fr.load_image() for fr in frames]
        path = os.path.join(root, "flame.ckpt.npz")
        Kt = torch.as_tensor(meta["K"], dtype=torch.float32)
        Kinv = camera.inv_k(Kt)

        def run(fl, lo, hi):
            for i in range(lo, hi):
                fr = frames[i]
                fl.update(fr.time, fr.frame_id, (fr.q, fr.t), imgs[i],
                          i % 2 == 0)
        was = torch.are_deterministic_algorithms_enabled()
        torch.use_deterministic_algorithms(True, warn_only=True)
        try:
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                _kernels.reset_launches()
                fl = flame_tpu_torch.Flame(256, 192, Kt, Kinv, params)
                run(fl, 0, CKPT_SAVE_AFTER + 1)
                pending = len(fl._batch_pending)
                torch.cuda.synchronize()
                # save() quiesces first; timed apart: the buffered frames,
                # the rest of the quiesce (the BA solve joined), the write.
                t0 = time.perf_counter()
                fl._flush_batch()
                torch.cuda.synchronize()
                t1 = time.perf_counter()
                checkpoint._quiesce(fl)
                torch.cuda.synchronize()
                t2 = time.perf_counter()
                checkpoint.save(path, fl)
                flush_ms = 1000 * (t1 - t0)
                quiesce_ms = 1000 * (t2 - t1)
                save_ms = 1000 * (time.perf_counter() - t2)
                fl2 = flame_tpu_torch.Flame(256, 192, Kt, Kinv, params)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                checkpoint.load(path, fl2)
                torch.cuda.synchronize()
                load_ms = 1000 * (time.perf_counter() - t0)
                size_mb = os.path.getsize(path) / 1e6
                at_load = _ckpt_diff(_ckpt_state(fl), _ckpt_state(fl2))
                solves = fl.stats.stats("ba_single_solves")
                run(fl, CKPT_SAVE_AFTER + 1, n)
                run(fl2, CKPT_SAVE_AFTER + 1, n)
                after = _ckpt_diff(_ckpt_state(fl), _ckpt_state(fl2))
                torch.cuda.synchronize()
                launches = dict(_kernels.LAUNCHES)
        finally:
            torch.use_deterministic_algorithms(was)
    notes = sorted({str(w.message).split("\n")[0][:160] for w in caught})
    label = "checkpoint, mini-TUM 256x192 deterministic throughput run + BA"
    print(f"{label}: after frame {CKPT_SAVE_AFTER}: quiesce = {pending} "
          f"buffered frames run {flush_ms:.2f} ms + the rest (the BA solve "
          f"joined) {quiesce_ms:.2f} ms; save {save_ms:.2f} ms, load "
          f"{load_ms:.2f} ms, {size_mb:.2f} MB, on {smi}")
    print(f"{label}: largest |diff| right after load {max(at_load.values())};"
          f" after {CKPT_MORE} more frames each {after}; BA solves staged "
          f"{int(solves)} before the save, "
          f"{int(fl.stats.stats('ba_single_solves'))} / "
          f"{int(fl2.stats.stats('ba_single_solves'))} at the end "
          f"(continued / loaded); launches {launches}")
    for w in notes:
        print(f"{label}: deterministic-mode warning: {w}")
    if max(at_load.values()) != 0.0 or max(after.values()) != 0.0 \
            or fl.stats.stats("ba_single_solves") <= solves \
            or fl2.stats.stats("ba_single_solves") \
            != fl.stats.stats("ba_single_solves"):
        raise AssertionError(f"{label}: the resumed run departs")
    return launches


def support_path(smi):
    """utils.load_tracker on the card, and run_synthetic for 10 frames
    into chiprun_out/run_synthetic (median error within phase 6's 0.01)."""
    from flame_tpu_torch import _kernels, run_synthetic
    from flame_tpu_torch.utils import load_tracker
    m = load_tracker.LoadTracker().mem()
    print(f"load tracker: card memory free {m.device_free_bytes / 2**30:.3f}"
          f" GiB of {m.device_total_bytes / 2**30:.3f} GiB "
          f"(torch.cuda.mem_get_info), this process's allocator "
          f"{m.device_allocated_bytes / 2**30:.3f} GiB; host RSS "
          f"{m.process_rss_kb / 2**20:.3f} GiB; on {smi}")
    _kernels.reset_launches()
    err = run_synthetic.main(["--frames", "10", "--out",
                              os.path.join("chiprun_out", "run_synthetic")])
    torch.cuda.synchronize()
    launches = dict(_kernels.LAUNCHES)
    print(f"run_synthetic 320x240, 10 frames: median relative error "
          f"{err:.5f} (<= 0.01); launches {launches}")
    if not err <= 0.01 or launches["raster_mesh"] < 1:
        raise AssertionError("run_synthetic out of bounds")
    return launches


def api_residue(smi):
    """Phase 10; returns the launch counts of its runs."""
    fl, sync = auto_poseframe_path(smi, "sync", 30)
    check_filtered_map(fl)
    del fl
    _, host = auto_poseframe_path(smi, "host", 32)
    return [sync, host, checkpoint_path(smi), support_path(smi)]


# Phase 11: the multi-chip layer on one card.
SHARD_PARTS = (1, 2, 4, 8)
SHARD_ATOL = 1e-5  # tests/test_sharding.py's tolerance for the edge smoother
SHARD_FIELDS = ("x", "w1", "w2", "x_bar", "w1_bar", "w2_bar", "q1", "q2",
                "q3")
SHARDED_BA_FRAMES = 48  # phase 9's 640x480 sequence, uncut


def _max_diff(a, b, fields=SHARD_FIELDS):
    """{field: max |a - b|} over the graph fields."""
    return {k: (getattr(a, k) - getattr(b, k)).abs().max().item()
            for k in fields}


def check_sharded_smooth(smi, g, n_iters=40):
    """11a: sharded_smooth on phase 3's graph at SHARD_PARTS partitions
    against nltgv2.smooth(mode="stacked") and K1's result; card ms per
    call; the psum traffic model. Returns the one-partition result."""
    from flame_tpu_torch import RegularizerParams
    from flame_tpu_torch.optimize import nltgv2, smoother_kernel
    from flame_tpu_torch.parallel import sharding
    p = RegularizerParams()
    V, E = g.x.shape[0], g.q1.shape[0]
    stacked = nltgv2.smooth(p, g, n_iters, mode="stacked")
    k1 = smoother_kernel.smooth(p, g, n_iters)
    outs, ms = {}, {}
    for n in SHARD_PARTS:
        mesh = sharding.make_mesh(n, g.x.device)
        outs[n] = sharding.sharded_smooth(p, g, n_iters, mesh)
        ms[n] = _device_ms(lambda: sharding.sharded_smooth(p, g, n_iters,
                                                           mesh), 5)
    stacked_ms = _device_ms(lambda: nltgv2.smooth(p, g, n_iters,
                                                  mode="stacked"), 5)
    d_stacked = {n: _max_diff(o, stacked) for n, o in outs.items()}
    d_k1 = {n: _max_diff(o, k1, ("x",))["x"] for n, o in outs.items()}
    print(f"sharded_smooth V={V} E={E} iters={n_iters}: max|dx| against "
          "nltgv2.smooth(stacked) "
          + ", ".join(f"n={n} {d['x']:.3g}" for n, d in d_stacked.items())
          + f" (gate {SHARD_ATOL}); all fields "
          + ", ".join(f"n={n} {max(d.values()):.3g}"
                      for n, d in d_stacked.items())
          + "; max|dx| against K1 "
          + ", ".join(f"n={n} {d:.3g}" for n, d in d_k1.items())
          + f" (gate {SHARD_ATOL})")
    print(f"sharded_smooth ms per call on the card ({smi}): "
          + ", ".join(f"n={n} {ms[n]:.3f}" for n in SHARD_PARTS)
          + f"; nltgv2.smooth(stacked) {stacked_ms:.3f}; psum traffic "
          + ", ".join(
              f"n={n} {sharding.psum_traffic_model(V, n, n_iters)['bytes_per_device_total']} B"
              for n in SHARD_PARTS)
          + " per partition (a sum over partitions of one card moves none "
          "between cards)")
    bad = [n for n in SHARD_PARTS
           if d_stacked[n]["x"] > SHARD_ATOL or d_k1[n] > SHARD_ATOL]
    if bad:
        raise AssertionError(f"sharded_smooth departs at n={bad}")
    return outs[1]


def tracked_state(dev, n_frames=8):
    """A Flame (bench_params) after n_frames of phase 6's scene, the next
    frame, and the RCM order and ranks of its graph."""
    import flame_tpu_torch
    from flame_tpu_torch.core import frame as frame_mod
    from flame_tpu_torch.optimize import smoother_kernel
    params = bench_params()
    K, Kinv, frames = scene(n_frames + 1)
    fl = flame_tpu_torch.Flame(W, H, K, Kinv, params, device=dev)
    for i in range(n_frames):
        fl.update(i / 30.0, i, pose(i), frames[i], i % 2 == 0)
    q, t = (torch.as_tensor(a, dtype=torch.float32, device=dev)
            for a in pose(n_frames))
    fnew = frame_mod.create(n_frames, q, t,
                            torch.as_tensor(frames[n_frames], device=dev),
                            params.pad)
    g = fl._graph
    V, E = g.x.shape[0], g.q1.shape[0]
    n_e = int(g.edge_mask.sum())
    edges = g.edges[:n_e].cpu().numpy()
    pos = g.pos.cpu().numpy()
    d = pos[edges[:, 0]] - pos[edges[:, 1]]
    perm = smoother_kernel.rcm_order(edges, n_e, V, g.vtx_mask.cpu().numpy())
    inv = np.empty(V, np.int32)
    inv[perm] = np.arange(V, dtype=np.int32)
    ranks = smoother_kernel.perm_edge_ranks(
        edges, n_e, inv, E, params.solver.max_vertex_degree,
        params.solver.pallas_reach, tie=np.sqrt((d * d).sum(1)))
    rcm = tuple(torch.as_tensor(a.astype(np.int64), device=dev)
                for a in (perm, inv, ranks))
    args = (fl.K, fl.Kinv, fl._stack, fl._feats, fnew, fl._curr_pf_slot, g)
    return params, args, rcm


def check_sharded_step(smi, dev):
    """11b: sharded_update_step on make_mesh(MESH_PARTS) for the three
    smoothers against the unsharded tracking (bit for bit) and each
    other; K3 once in "pallas_halo" only. Returns the launch counts."""
    import dataclasses
    from flame_tpu_torch import _kernels
    from flame_tpu_torch.core import pipeline
    from flame_tpu_torch.optimize import nltgv2
    from flame_tpu_torch.parallel import sharding
    params, args, rcm = tracked_state(dev)
    mesh = sharding.make_mesh(MESH_PARTS, dev)
    ufe, ucu, umem, ust, _ = pipeline.track_project_sync(params, *args[:6])
    want = ([getattr(ufe, f.name) for f in dataclasses.fields(ufe)]
            + [getattr(ucu, f.name) for f in dataclasses.fields(ucu)]
            + [umem, ust])
    n_iters = params.solver.n_iters_per_frame
    stacked = nltgv2.smooth(params.rparams, args[6], n_iters,
                            mode="stacked")
    graphs, ms, runs = {}, {}, []
    for sm in ("edge", "halo", "pallas_halo"):
        step = sharding.sharded_update_step(params, mesh, sm)
        extra = rcm if sm != "edge" else ()
        _kernels.reset_launches()
        fe, cu, mem, g2, st = step(*args, *extra)
        torch.cuda.synchronize()
        launches = dict(_kernels.LAUNCHES)
        runs.append(launches)
        got = ([getattr(fe, f.name) for f in dataclasses.fields(fe)]
               + [getattr(cu, f.name) for f in dataclasses.fields(cu)]
               + [mem, st])
        diff = [i for i, (a, b) in enumerate(zip(got, want))
                if a.dtype != b.dtype or not torch.equal(a, b)]
        if diff:
            raise AssertionError(f"sharded step {sm}: tracking outputs "
                                 f"{diff} differ from the unsharded step")
        k3 = 1 if sm == "pallas_halo" else 0
        if launches["halo_smoother"] != k3 or launches["nltgv2_smoother"]:
            raise AssertionError(f"sharded step {sm}: launches {launches}")
        graphs[sm] = g2
        ms[sm] = _cuda_ms(lambda: step(*args, *extra), 3)
    d_edge = _max_diff(graphs["edge"], stacked)
    d_halo = _max_diff(graphs["pallas_halo"], graphs["halo"])
    print(f"sharded_update_step ({MESH_PARTS} partitions, 640x480, "
          f"{params.feature_capacity} features, {int(umem.sum())} members, "
          f"{int(args[6].edge_mask.sum())} edges): tracking bit-equal to the "
          f"unsharded step for edge/halo/pallas_halo; K3 launches "
          f"{[r['halo_smoother'] for r in runs]}; edge vs "
          f"nltgv2.smooth(stacked) max|dx| {d_edge['x']:.3g} (gate "
          f"{SHARD_ATOL}; all fields {max(d_edge.values()):.3g}); "
          f"pallas_halo vs halo max|d| {max(d_halo.values()):.3g} (rtol "
          f"{K1_TOL['rtol']}, atol {K1_TOL['atol']})")
    print(f"sharded_update_step ms per step (host wall, CUDA events back "
          f"to back) on {smi}: "
          + ", ".join(f"{k} {v:.3f}" for k, v in ms.items()))
    if d_edge["x"] > SHARD_ATOL:
        raise AssertionError("sharded step edge departs from the stacked "
                             "smoother")
    for k in SHARD_FIELDS:
        torch.testing.assert_close(getattr(graphs["pallas_halo"], k),
                                   getattr(graphs["halo"], k), **K1_TOL,
                                   msg=f"sharded step pallas_halo vs halo {k}")
    return runs


def ba_windows(dev, P):
    """check_ba_graph's well-posed window of P poses (L=1024, M=4096) as a
    BAProblem on dev, with K and Kinv."""
    from flame_tpu_torch import BAParams
    from flame_tpu_torch.ba import window
    p = BAParams()
    L, M = p.max_landmarks, p.max_obs
    Kn = np.array([[FX, 0, W / 2], [0, FX, H / 2], [0, 0, 1]])
    buf = torch.as_tensor(window.well_posed_window(P, L, M, Kn, P, (40, 440)),
                          device=dev)
    problem, _ = window._decode_packed(buf, P, L, M)
    K = torch.tensor(Kn, dtype=torch.float32, device=dev)
    return p, K, torch.linalg.inv(K), problem


def check_sharded_ba(smi, dev):
    """11c: solve_window_sharded on make_mesh(MESH_PARTS), replayed from
    the graph runner (kind "ba_sharded", one capture per window size),
    against the single eager solve, rtol 1e-4 (phase 5c's); eager and
    graphed times."""
    from flame_tpu_torch import step_graph
    from flame_tpu_torch.ba import schur, window
    from flame_tpu_torch.parallel import distributed_ba, sharding
    mesh = sharding.make_mesh(MESH_PARTS, dev)
    steps = step_graph.Steps(step_graph.cuda_capture)
    for P in (3, 8):
        p, K, Kinv, problem = ba_windows(dev, P)

        def single():
            return window._flat_result(*schur.solve_window(
                p, K, Kinv, problem, n_fixed=2))
        ref = single()

        def sharded():
            with step_graph.active(steps):
                return distributed_ba.solve_window_sharded(p, K, Kinv,
                                                           problem, mesh)
        t0 = time.perf_counter()
        out = window._flat_result(*sharded())
        torch.cuda.synchronize()
        first_ms = 1000 * (time.perf_counter() - t0)
        torch.testing.assert_close(out, ref, rtol=1e-4, atol=1e-5,
                                   msg=f"sharded BA solve, {P} poses")
        err = (out - ref).abs().max().item()
        mprob, sw = distributed_ba._materialize(problem, mesh.size, None)
        eager_ms = _cuda_ms(lambda: distributed_ba._solve(
            p, 2, mesh, K, Kinv, mprob, sw), 3)
        graph_ms = _cuda_ms(sharded, 10)
        card_ms = _device_ms(sharded, 10)
        single_ms = _device_ms(single, 10)
        print(f"solve_window_sharded, {P} poses, L={problem.lm_idepth.shape[0]}"
              f", M={problem.obs.u_ref.shape[0]}, {MESH_PARTS} partitions: "
              f"max|sharded - single| {err:.3g} (rtol 1e-4); eager "
              f"{eager_ms:.3f} ms, graphed {graph_ms:.3f} ms back to back, "
              f"{card_ms:.3f} ms on the card (the single eager solve "
              f"{single_ms:.3f}); first call with capture {first_ms:.1f} ms; "
              f"on {smi}")
    if steps.counts.get("ba_sharded_graph_captures") != 2 \
            or "ba_sharded_graph_eager" in steps.counts:
        raise AssertionError(f"11c: graph counters {steps.counts}")


def sharded_ba_runs(root, meta, noisy_ate):
    """11d's runs inside phase 9's 640x480 directory: ShardedFlame with
    BA on make_mesh(MESH_PARTS), noisy poses, smoother "vertex" and
    "pallas_halo". Gated and printed by check_sharded_flame_ba."""
    from flame_tpu_torch import _kernels
    from flame_tpu_torch.io import synthetic
    from flame_tpu_torch.parallel import sharding
    from flame_tpu_torch.utils import evaluation
    out = {"noisy_ate": noisy_ate}
    _, gt_idm = synthetic.render_frame(
        meta["K"], *synthetic.trajectory(SHARDED_BA_FRAMES - 1), 640, 480)
    for sm in ("vertex", "pallas_halo"):
        _kernels.reset_launches()
        fl, _, frame_ms, solve_ms = dataset_run(
            root, SHARDED_BA_FRAMES, with_smoother(vga_params(True), sm),
            meta["K"], meta["noisy"], 2,
            mesh=sharding.make_mesh(MESH_PARTS))
        torch.cuda.synchronize()
        out[sm] = dict(
            fl=fl, frame_ms=frame_ms, solve_ms=solve_ms,
            launches=dict(_kernels.LAUNCHES),
            n_post=len(fl.stats.device_times_ms().get("sync_graph", [])),
            ate=pf_ate(fl, meta["gt"]),
            err=evaluation.depth_error_stats(fl.get_inverse_depth_map(),
                                             gt_idm))
    return out


def check_sharded_flame_ba(smi, res):
    """11d: the gates and numbers of sharded_ba_runs. Returns the runs'
    launch counts."""
    skip = 4
    launches = []
    for sm in ("vertex", "pallas_halo"):
        r = res[sm]
        st = r["fl"].stats
        got, n_post = r["launches"], r["n_post"]
        k = "nltgv2_smoother" if sm == "vertex" else "halo_smoother"
        other = "halo_smoother" if sm == "vertex" else "nltgv2_smoother"
        ratio = r["ate"] / res["noisy_ate"]
        solve = (np.median(np.asarray(r["solve_ms"]), axis=0)
                 if r["solve_ms"] else (float("nan"),) * 2)
        print(f"sharded BA ({sm}, {MESH_PARTS} partitions) mini-TUM 640x480 "
              f"noisy, {SHARDED_BA_FRAMES} frames: coverage "
              f"{r['err']['coverage']:.4f} (> 0.35), median relative error "
              f"{r['err']['median_rel']:.5f}, ATE {1000 * r['ate']:.3f} mm, "
              f"{ratio:.4f} of phase 9's noisy run without BA (< 0.8); "
              f"sharded solves {int(st.stats('ba_sharded_solves'))}, single "
              f"{int(st.stats('ba_single_solves'))}, applied "
              f"{int(st.stats('ba_solves_applied'))}, graphs captured "
              f"{int(st.stats('ba_sharded_graph_captures'))}, replayed "
              f"{int(st.stats('ba_sharded_graph_replays'))}; {n_post} "
              f"post-Delaunay steps, launches {got}")
        print(f"sharded BA ({sm}): median update "
              f"{np.median(r['frame_ms'][skip:]):.3f} ms (host wall, updates "
              f"{skip + 1}-{len(r['frame_ms'])}), median sharded solve "
              f"{solve[0]:.3f} ms between CUDA events, {solve[1]:.3f} ms host "
              f"(solve and apply, synchronous; {len(r['solve_ms'])} solves) "
              f"on {smi}")
        if not (r["err"]["coverage"] > 0.35 and ratio < 0.8
                and st.stats("ba_sharded_solves") >= 1
                and st.stats("ba_single_solves") == 0 and n_post >= 1
                and st.stats("ba_sharded_graph_replays")
                == st.stats("ba_sharded_solves")
                and got[k] == n_post and got[other] == 0
                and got["raster_mesh"] == n_post):
            raise AssertionError(f"sharded BA ({sm}): gates failed")
        launches.append(got)
    return launches


def _free_port():
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def check_process_group(smi, g, n_iters=40):
    """11e: one process over NCCL: sharded_smooth and solve_window_sharded
    on global_mesh() against their one-partition results, bit for bit,
    both under torch.use_deterministic_algorithms (index_add_'s atomics
    round in another order from run to run otherwise)."""
    import torch.distributed as dist
    from flame_tpu_torch import RegularizerParams
    from flame_tpu_torch.parallel import distributed_ba, multihost, sharding
    p = RegularizerParams()
    one = sharding.make_mesh(1, g.x.device)
    bp, K, Kinv, problem = ba_windows(g.x.device, 8)
    t0 = time.perf_counter()
    multihost.initialize(f"127.0.0.1:{_free_port()}", 1, 0)
    init_s = time.perf_counter() - t0
    was = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        mesh = multihost.global_mesh()
        backend = "nccl" if g.x.is_cuda else "gloo"
        if not (mesh.size == 1 and dist.get_backend() == backend
                and multihost.is_coordinator()):
            raise AssertionError(f"global mesh {mesh}")
        a = sharding.sharded_smooth(p, g, n_iters, one)
        b = sharding.sharded_smooth(p, g, n_iters, mesh)
        ma, sa = distributed_ba._materialize(problem, 1, None)
        ba_one = distributed_ba._solve(bp, 2, one, K, Kinv, ma, sa)
        ba_group = distributed_ba.solve_window_sharded(bp, K, Kinv, problem,
                                                       mesh)
        torch.cuda.synchronize()
        smooth_eq = all(torch.equal(getattr(a, k), getattr(b, k))
                        for k in SHARD_FIELDS)
        ba_eq = all(torch.equal(x, y) for x, y in zip(ba_one, ba_group))
        group_ms = _cuda_ms(lambda: sharding.sharded_smooth(p, g, n_iters,
                                                            mesh), 3)
        ba_ms = _cuda_ms(lambda: distributed_ba.solve_window_sharded(
            bp, K, Kinv, problem, mesh), 3)
    finally:
        torch.use_deterministic_algorithms(was)
        dist.destroy_process_group()
    print(f"process group ({backend}, 1 process, init {init_s:.2f} s): "
          f"sharded_smooth bit-equal to one partition {smooth_eq}, "
          f"solve_window_sharded (8 poses) bit-equal {ba_eq}; eager under "
          f"deterministic algorithms {group_ms:.3f} ms and {ba_ms:.3f} ms "
          f"per call on {smi}")
    if not (smooth_eq and ba_eq):
        raise AssertionError("the process-group mesh departs from one "
                             "partition")


# Phase 12: the multi-card transport on the one card.
GROUP_RANKS = 2
GROUP_TIMEOUT_S = 420  # both ranks together, builds loaded from _build/
GROUP_FRAMES = 30  # phase 6's
GROUP_SHORT_FRAMES = 12  # "vertex" and "halo"
GROUP_BACK_TO_BACK = 5
# Phase 7's configuration over the group: the bootstrap's single frames
# (0-5), then four batched steps of 8 frames; three evictions.
GROUP_BATCH_FRAMES = 38
ONE_RANK_BATCH_FRAMES = 22  # 12e: two batched steps


def group_k3(smi, mesh, rank, n_iters=40, reach=K3_REACH):
    """12a on this rank: K3 over the group against make_mesh(2) and
    make_mesh(1) of this process, bit for bit."""
    import torch.distributed as dist
    from flame_tpu_torch import RegularizerParams, _kernels
    from flame_tpu_torch.optimize import smoother_kernel
    from flame_tpu_torch.parallel import halo_kernel, sharding
    p = RegularizerParams()
    dev = torch.device("cuda")
    g, _, _ = make_graph(dev)
    D = g.inc_edge.shape[1]
    perm, inv, ranks = rcm_tables(g, D, reach)
    args = (p, g, perm, inv, ranks, n_iters, D)
    refs = {m: halo_kernel.smooth_sharded(*args, sharding.make_mesh(m),
                                          reach=reach) for m in (1, 2)}
    for k in SHARD_FIELDS:
        if not torch.equal(getattr(refs[1], k), getattr(refs[2], k)):
            raise AssertionError(f"12a: make_mesh(2) departs from "
                                 f"make_mesh(1) in {k}")
    calls_ms = []
    for _ in range(2):
        dist.barrier()
        before = _kernels.LAUNCHES["halo_smoother"]
        t0 = time.perf_counter()
        out = halo_kernel.smooth_sharded(*args, mesh, reach=reach)
        torch.cuda.synchronize()
        calls_ms.append(1000 * (time.perf_counter() - t0))
        if _kernels.LAUNCHES["halo_smoother"] - before != 1:
            raise AssertionError("12a: not one K3 launch per rank and call")
        for k in SHARD_FIELDS:
            if not torch.equal(getattr(out, k), getattr(refs[2], k)):
                raise AssertionError(f"12a: the group's {k} departs from "
                                     f"make_mesh(2)'s")
    # Five launches queued back to back on the rank's block: the flags
    # are never reset, each call's epoch lies above the last one's.
    lay = smoother_kernel.build_layout(g, perm, inv, ranks, D, reach)
    R = lay.vtx[0].shape[0]
    Rb = R // GROUP_RANKS
    r0 = rank * Rb
    vtx = [a[r0:r0 + Rb] for a in lay.vtx]
    slots = [a[r0 * D:(r0 + Rb) * D] for a in lay.slots]
    whole = halo_kernel.iterate(p, n_iters, D, reach, 2, lay.vtx, lay.slots)
    want = [a[r0:r0 + Rb] if k < 6 else a[r0 * D:(r0 + Rb) * D]
            for k, a in enumerate(whole)]
    dist.barrier()
    torch.cuda.synchronize()
    a_ev = torch.cuda.Event(enable_timing=True)
    b_ev = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    a_ev.record()
    outs = [halo_kernel.iterate(p, n_iters, D, reach, 1, vtx, slots, mesh)
            for _ in range(GROUP_BACK_TO_BACK)]
    b_ev.record()
    torch.cuda.synchronize()
    host_ms = 1000 * (time.perf_counter() - t0) / GROUP_BACK_TO_BACK
    card_ms = a_ev.elapsed_time(b_ev) / GROUP_BACK_TO_BACK
    for c, o in enumerate(outs):
        for k, (a, b) in enumerate(zip(o, want)):
            if not torch.equal(a, b):
                raise AssertionError(f"12a: back-to-back call {c}, output "
                                     f"{k} departs from make_mesh(2)'s")
    plan = halo_kernel._plan(0, Rb * 128, D, 1, reach)
    print(f"12a K3 over {GROUP_RANKS} ranks (gloo, one card, CUDA IPC "
          f"strips) V={g.x.shape[0]} D={D} reach={reach} iters={n_iters}: "
          f"smooth_sharded bit-equal to make_mesh(2) and make_mesh(1), one "
          f"launch per rank and call; {GROUP_BACK_TO_BACK} launches back to "
          f"back bit-equal (epoch flags); rank plan {plan.clusters} "
          f"clusters of {plan.cluster} CTAs, {plan.vertices_per_warp} "
          f"vertices per warp; per call {card_ms:.3f} ms between CUDA "
          f"events ({host_ms:.3f} ms host) and smooth_sharded with layout "
          f"and gather {calls_ms[-1]:.3f} ms, the two processes' contexts "
          f"time-slicing on the one card (not a time between two cards); "
          f"{smi}")
    return card_ms


def group_flame(smi, mesh, smoother, n_frames):
    """12b on this rank: ShardedFlame over the group at bench_params()
    against ShardedFlame on make_mesh(2) of this process; returns the
    group run's launch counts."""
    from flame_tpu_torch import _kernels
    from flame_tpu_torch.parallel import sharding
    from flame_tpu_torch.parallel.orchestrator import ShardedFlame
    K, Kinv, frames = scene(n_frames)
    params = with_smoother(bench_params(), smoother)
    per_step = ({"halo_smoother": 1, "nltgv2_smoother": 0, "raster_mesh": 1}
                if smoother == "pallas_halo" else
                {"halo_smoother": 0, "nltgv2_smoother":
                 int(smoother == "vertex"), "raster_mesh": 1})
    fl = ShardedFlame(W, H, K, Kinv, params, mesh=mesh)
    _kernels.reset_launches()
    frame_ms, meshed = [], 0
    for i in range(n_frames):
        before = dict(_kernels.LAUNCHES)
        t0 = time.perf_counter()
        ok = fl.update(i / 30.0, i, pose(i), frames[i], i % 2 == 0)
        torch.cuda.synchronize()
        if ok:
            meshed += 1
            frame_ms.append(1000 * (time.perf_counter() - t0))
            ds = {k: _kernels.LAUNCHES[k] - before[k] for k in per_step}
            if ds != per_step:
                raise AssertionError(f"12b {smoother} frame {i}: launches "
                                     f"{ds} (want {per_step})")
    launches = dict(_kernels.LAUNCHES)
    N = params.feature_capacity // GROUP_RANKS
    if not (fl._feats.idepth_mu.shape[0] == N and fl._curr.xy.shape[0] == N
            and fl._graph.x.shape[0] == N
            and fl._graph.q1.shape[0] == params.edge_capacity // GROUP_RANKS
            and tuple(fl._idepthmap.shape) == (H, W)
            and fl._stack.img_pad.shape[0] == params.poseframe_capacity):
        raise AssertionError(f"12b {smoother}: state not placed in blocks")
    idm = fl.get_inverse_depth_map()
    ref = ShardedFlame(W, H, K, Kinv, params, mesh=sharding.make_mesh(2))
    for i in range(n_frames):
        ref.update(i / 30.0, i, pose(i), frames[i], i % 2 == 0)
    ref_map = ref.get_inverse_depth_map()
    both = ~np.isnan(idm) & ~np.isnan(ref_map)
    diff = float(np.median(np.abs(idm[both] - ref_map[both])))
    label = (f"12b ShardedFlame {smoother} over {GROUP_RANKS} ranks, "
             f"640x480, 4096 features ({N} rows per rank), {n_frames} "
             f"frames ({meshed} meshed)")
    print(f"{label}: median |idepth - make_mesh(2) idepth| {diff:.3g} "
          f"(< 1e-4) over {both.mean():.4f} of the pixels; median frame "
          f"{np.median(frame_ms[4:]):.3f} ms host wall; launches {launches}; "
          f"{smi}")
    if not (diff < 1e-4 and both.mean() > 0.5 and meshed >= n_frames // 2):
        raise AssertionError(f"{label}: departs from make_mesh(2)")
    if n_frames == GROUP_FRAMES:
        check_map(fl, label)
    return launches


def deterministic_throughput_params():
    """throughput_params() with "pallas_halo" and solver.deterministic:
    every snapshot and triangulation joined at once, so that the group
    and the one-process mesh it is held to run one schedule."""
    import dataclasses
    p = with_smoother(throughput_params(), "pallas_halo")
    return p.replace(solver=dataclasses.replace(p.solver,
                                                deterministic=True))


def group_batch(smi, mesh):
    """12d on this rank: ShardedFlame over the group on phase 7's
    throughput configuration (frame_batch=8, eviction) with resident
    frames, "pallas_halo" and deterministic=True, against ShardedFlame on
    make_mesh(2) of this process: K2b once per batched step, K3 and K2
    once per post-Delaunay step, phase 7's map gates. Returns the group
    run's launch counts."""
    from flame_tpu_torch import _kernels
    from flame_tpu_torch.parallel import sharding
    from flame_tpu_torch.parallel.orchestrator import ShardedFlame
    n_frames = GROUP_BATCH_FRAMES
    K, Kinv, frames = resident_scene(n_frames)
    params = deterministic_throughput_params()
    fl = ShardedFlame(W, H, K, Kinv, params, mesh=mesh)
    _kernels.reset_launches()
    step_ms, t_group = [], None
    for i in range(n_frames):
        if t_group is None:
            t_group = time.perf_counter()
        d0 = fl._dispatches
        fl.update(i / 30.0, i, pose(i), frames[i], i % 2 == 0)
        if fl._dispatches != d0:
            torch.cuda.synchronize()
            step_ms.append(1000 * (time.perf_counter() - t_group))
            t_group = None
        elif not fl._batch_pending:  # a frame of the single path
            t_group = None
    N = params.feature_capacity // GROUP_RANKS
    if not (fl._feats.idepth_mu.shape[0] == N and fl._curr.xy.shape[0] == N
            and fl._graph.x.shape[0] == N and fl._vtx_idepths.shape[0] == N):
        raise AssertionError("12d: state not placed in blocks")
    label = (f"12d ShardedFlame pallas_halo over {GROUP_RANKS} ranks, "
             f"throughput path (resident frames, frame_batch=8, "
             f"deterministic) 640x480, 4096 features ({N} rows per rank), "
             f"{n_frames} frames")
    check_map(fl, label)  # flushes the frames still buffered
    launches = dict(_kernels.LAUNCHES)
    n_post = len(fl.stats.device_times_ms().get("sync_graph", []))
    evictions = int(fl.stats.stats("pf_evictions"))
    idm = fl.get_inverse_depth_map()
    ref = ShardedFlame(W, H, K, Kinv, params, mesh=sharding.make_mesh(2))
    for i in range(n_frames):
        ref.update(i / 30.0, i, pose(i), frames[i], i % 2 == 0)
    ref_map = ref.get_inverse_depth_map()
    both = ~np.isnan(idm) & ~np.isnan(ref_map)
    diff = float(np.median(np.abs(idm[both] - ref_map[both])))
    print(f"{label}: {fl._dispatches} batched steps ({ref._dispatches} on "
          f"make_mesh(2)), {n_post} post-Delaunay steps, {evictions} "
          f"poseframe evictions; median |idepth - make_mesh(2) idepth| "
          f"{diff:.3g} (< 1e-4) over {both.mean():.4f} of the pixels; "
          f"launches {launches}; {smi}")
    print(f"{label}: ms per batched step over the group (host wall incl. "
          f"synchronize, from the batch's first frame) "
          + ", ".join(f"{v:.1f}" for v in step_ms)
          + f", median of steps 2-{len(step_ms)} "
          f"{np.median(step_ms[1:]):.1f}; median ms per stage (CUDA "
          f"events, steps 2-): "
          + stage_medians(fl, ("raster_batch", "update_idepths",
                               "sync_graph", "smoother", "raster"), 1)
          + f"; the two processes' contexts time-slicing on the one card "
          f"(not a time between two cards); {smi}")
    if not (fl._dispatches >= 4 and fl._dispatches == ref._dispatches
            and launches["raster_mesh_batch"] == fl._dispatches):
        raise AssertionError(f"12d: raster_mesh_batch launches "
                             f"{launches['raster_mesh_batch']} vs "
                             f"{fl._dispatches} batched steps")
    per_step = {"halo_smoother": 1, "nltgv2_smoother": 0, "raster_mesh": 1}
    if any(launches[k] != v * n_post for k, v in per_step.items()):
        raise AssertionError(f"12d: launches {launches} for {n_post} "
                             f"post-Delaunay steps")
    if not (diff < 1e-4 and both.mean() > 0.5 and evictions >= 1):
        raise AssertionError(f"{label}: departs from make_mesh(2)")
    return launches


def group_ba(smi, mesh, rank):
    """12b's BA run on this rank: mini-TUM 256x192 on noisy poses with BA
    over the group against the run without BA (the coordinator's, in one
    process); gated on the coordinator."""
    import torch.distributed as dist
    from flame_tpu_torch import _kernels
    from flame_tpu_torch.io import synthetic
    root = [tempfile.mkdtemp() if rank == 0 else None]
    meta = [None]
    if rank == 0:
        meta[0] = synthetic.generate_mini_tum(root[0], n_frames=24,
                                              width=256, height=192,
                                              fx=210.0, **DS_NOISE)
    dist.broadcast_object_list(root, src=0)
    dist.broadcast_object_list(meta, src=0)
    root, meta = root[0], meta[0]
    try:
        _kernels.reset_launches()
        fl, _, frame_ms, solve_ms = dataset_run(
            root, 24, mini_tum_params(True), meta["K"], meta["noisy"], 2,
            mesh=mesh)
        torch.cuda.synchronize()
        launches = dict(_kernels.LAUNCHES)
        ate = pf_ate(fl, meta["gt"])
        st = fl.stats
        if rank == 0:
            nz, _, _, _ = dataset_run(root, 24, mini_tum_params(False),
                                      meta["K"], meta["noisy"], 2)
            ratio = ate / pf_ate(nz, meta["gt"])
            print(f"12b BA over {GROUP_RANKS} ranks, mini-TUM 256x192 noisy: "
                  f"ATE {1000 * ate:.3f} mm, {ratio:.4f} of the run without "
                  f"BA (< 0.8); sharded solves "
                  f"{int(st.stats('ba_sharded_solves'))}, single "
                  f"{int(st.stats('ba_single_solves'))}, applied "
                  f"{int(st.stats('ba_solves_applied'))}; median update "
                  f"{np.median(frame_ms[4:]):.3f} ms host wall; launches "
                  f"{launches}; {smi}")
            if not (ratio < 0.8 and st.stats("ba_sharded_solves") >= 1
                    and st.stats("ba_single_solves") == 0
                    and st.stats("ba_solves_applied") >= 1):
                raise AssertionError("12b BA over the group: gates failed")
        dist.barrier()
    finally:
        if rank == 0:
            shutil.rmtree(root, ignore_errors=True)
    return launches


def group_rank_main(rank, coord, out_path):
    """One rank of phase 12a, 12b and 12d (chip_smoke.py --group-rank R
    --coord HOST:PORT --out FILE): joins the gloo group, runs its checks,
    and the coordinator writes the main-path launch counts to FILE."""
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    from flame_tpu_torch import _kernels
    from flame_tpu_torch.parallel import multihost
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    _kernels.load()
    multihost.initialize(coord, GROUP_RANKS, rank, backend="gloo")
    try:
        mesh = multihost.global_mesh(device="cuda")
        if not (mesh.staged and mesh.size == GROUP_RANKS
                and mesh.first_block == rank):
            raise AssertionError(f"12: global mesh {mesh}")
        k3_ms = group_k3(smi, mesh, rank)
        runs = [group_flame(smi, mesh, "pallas_halo", GROUP_FRAMES)]
        runs += [group_flame(smi, mesh, sm, GROUP_SHORT_FRAMES)
                 for sm in ("vertex", "halo")]
        runs.append(group_ba(smi, mesh, rank))
        runs.append(group_batch(smi, mesh))
    finally:
        multihost.shutdown()
    if rank == 0:
        with open(out_path, "w") as f:
            json.dump({"launches": runs, "k3_ms": k3_ms}, f)
    print(f"rank {rank} OK", flush=True)


def group_one_nccl_rank(smi, n_frames=16):
    """12c and 12e: ShardedFlame over a one-rank NCCL group with
    "pallas_halo" against make_mesh(1), bit for bit under
    torch.use_deterministic_algorithms: (c) on the synchronous path
    (bench_params(), n_frames frames), (e) on the throughput path
    (deterministic_throughput_params(), resident frames, two batched
    steps). Returns the group runs' launch counts."""
    from flame_tpu_torch import _kernels
    from flame_tpu_torch.parallel import multihost, sharding
    from flame_tpu_torch.parallel.orchestrator import ShardedFlame
    cases = (("12c", "synchronous path", bench_params(), scene(n_frames)),
             ("12e", "throughput path (resident frames, frame_batch=8)",
              deterministic_throughput_params(),
              resident_scene(ONE_RANK_BATCH_FRAMES)))
    multihost.initialize(f"127.0.0.1:{_free_port()}", 1, 0)
    was = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    out = []
    try:
        for tag, path, params, (K, Kinv, frames) in cases:
            params = with_smoother(params, "pallas_halo")
            maps, steps, launches = {}, {}, None
            for name in ("group", "one"):
                mesh = (multihost.global_mesh() if name == "group"
                        else sharding.make_mesh(1))
                fl = ShardedFlame(W, H, K, Kinv, params, mesh=mesh)
                _kernels.reset_launches()
                for i, img in enumerate(frames):
                    fl.update(i / 30.0, i, pose(i), img, i % 2 == 0)
                torch.cuda.synchronize()
                if name == "group":
                    launches = dict(_kernels.LAUNCHES)
                steps[name] = fl._dispatches
                maps[name] = fl.get_inverse_depth_map()
            same = np.array_equal(maps["group"], maps["one"], equal_nan=True)
            print(f"{tag} ShardedFlame pallas_halo over one NCCL rank, "
                  f"{path}, {len(frames)} frames, {steps['group']} batched "
                  f"steps: map bit-equal to make_mesh(1) {same}; launches "
                  f"{launches}; {smi}")
            batched = params.solver.frame_batch > 1
            if not (same and launches["halo_smoother"] >= 1
                    and steps["group"] == steps["one"]
                    and launches["raster_mesh_batch"] == steps["group"]
                    and (steps["group"] >= 2 or not batched)):
                raise AssertionError(f"{tag}: the one-rank group departs "
                                     f"from make_mesh(1)")
            out.append(launches)
    finally:
        torch.use_deterministic_algorithms(was)
        multihost.shutdown()
    return out


def transport_phase(smi):
    """Phase 12; returns the launch counts of its main-path runs (rank 0's
    12b and 12d runs, 12c's and 12e's)."""
    mode = subprocess.run(
        ["nvidia-smi", "--query-gpu=compute_mode", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(f"12: compute mode {mode}")
    coord = f"127.0.0.1:{_free_port()}"
    out_dir = tempfile.mkdtemp()
    out_path = os.path.join(out_dir, "rank0.json")
    here = os.path.dirname(os.path.abspath(__file__))
    t0 = time.perf_counter()
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--group-rank", str(r),
         "--coord", coord, "--out", out_path], cwd=here,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(GROUP_RANKS)]
    outs = []
    try:
        for p in procs:
            remaining = GROUP_TIMEOUT_S - (time.perf_counter() - t0)
            outs.append(p.communicate(timeout=max(remaining, 1))[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, out in enumerate(outs):
        for line in out.splitlines():
            print(f"[rank {r}] {line}")
    rcs = [p.returncode for p in procs]
    print(f"12a, 12b, 12d: {GROUP_RANKS} ranks in "
          f"{time.perf_counter() - t0:.1f} s, exit codes {rcs}")
    if any(rcs) or len(outs) != GROUP_RANKS:
        raise AssertionError(f"12: a rank failed ({rcs})")
    with open(out_path) as f:
        res = json.load(f)
    shutil.rmtree(out_dir, ignore_errors=True)
    return res["launches"] + group_one_nccl_rank(smi)


# Phase 13: the bench, python -m flame_tpu_torch.bench, on the card.
BENCH_TIMEOUT_S = 300  # per run, the kernels already built in _build/
BENCH_RUNS = (
    ("VGA x 4096", {}),
    ("XGA x 8192", {"BENCH_RES": "1024x768", "BENCH_FEATS": "8192",
                    "BENCH_MODES": "resident", "BENCH_WINDOWS": "6"}),
    ("VGA x 4096, BENCH_SMOOTHER=pallas",
     {"BENCH_MODES": "resident", "BENCH_SMOOTHER": "pallas",
      "BENCH_WINDOWS": "4"}),
)


def bench_run(smi, label, env):
    """One run of the bench in a subprocess with BENCH_VERBOSE=1. Gates:
    exit code 0; the last stdout line a JSON object with every mode asked
    for at value > 0, coverage >= 0.5, median_rel_depth_err <= 0.01 and
    solver_iters_per_sec > 0; each mode's run through K2b and K2 and
    through K1 or, under "pallas", K3 (never the other); the solver rate
    through two launches (warm-up, timed) of that same smoother kernel.
    Returns each mode's launch counts."""
    here = os.path.dirname(os.path.abspath(__file__))
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "flame_tpu_torch.bench"], cwd=here,
        env=dict(os.environ, BENCH_VERBOSE="1", **env), capture_output=True,
        text=True, timeout=BENCH_TIMEOUT_S)
    secs = time.perf_counter() - t0
    if proc.returncode != 0:
        raise AssertionError(f"13 {label}: exit code {proc.returncode}\n"
                             f"{proc.stdout[-2000:]}\n{proc.stderr[-4000:]}")
    lines = proc.stdout.strip().splitlines()
    line = json.loads(lines[-1]) if lines else None
    extra = [json.loads(x) for x in proc.stderr.splitlines()
             if x.startswith("{") and "solver_launches" in x]
    if not isinstance(line, dict) or len(extra) != 1:
        raise AssertionError(f"13 {label}: no result line\n"
                             f"{proc.stdout[-2000:]}")
    extra = extra[0]
    print(f"13 {label} ({' '.join(f'{k}={v}' for k, v in env.items())}) "
          f"in {secs:.1f} s on {smi}: {json.dumps(line)}")
    print(f"13 {label}: smoother {extra['smoother']}; per mode "
          + "; ".join(f"{m}: round trip {x['rtt_probe_ms_median']} ms, "
                      f"windows {x['win_fps']} fps, stages (CUDA events, "
                      f"median ms) {x['stage_ms_median']}, launches "
                      f"{x['launches']}" for m, x in extra["modes"].items())
          + f"; solver rate launches {extra['solver_launches']}")
    modes = (env.get("BENCH_MODES", "resident,host_upload,resident_ba")
             .split(","))
    err = line.get("median_rel_depth_err")
    if not (list(line["modes"]) == modes
            and all(line["modes"][m] > 0 for m in modes)
            and line["coverage"] >= 0.5 and err is not None and err <= 0.01
            and line["solver_iters_per_sec"] > 0):
        raise AssertionError(f"13 {label}: result out of bounds")
    smoother, other = (("halo_smoother", "nltgv2_smoother")
                       if extra["smoother"] == "pallas"
                       else ("nltgv2_smoother", "halo_smoother"))
    runs = [x["launches"] for x in extra["modes"].values()]
    for m, n in zip(extra["modes"], runs):
        if min(n[smoother], n["raster_mesh"], n["raster_mesh_batch"]) < 1 \
                or n[other]:
            raise AssertionError(f"13 {label} {m}: launches {n}")
    want = {k: 2 if k == smoother else 0 for k in extra["solver_launches"]}
    if extra["solver_launches"] != want:
        raise AssertionError(f"13 {label}: solver rate launches "
                             f"{extra['solver_launches']} (want {want})")
    return runs


def bench_phase(smi):
    """Phase 13; returns the launch counts of each run's modes."""
    runs = []
    for label, env in BENCH_RUNS:
        runs += bench_run(smi, label, env)
    return runs


# Phase 14: pair-mode batching and the structured scene at full width.
PAIR_FRAMES = 32
# B=8 on the same posture is the reference for the per-frame cost of a
# step's fixed work (phase 7's B=8 also scores comparison poseframes).
PAIR_RUNS = ((1, "resident"), (2, "resident"), (4, "resident"), (2, "host"),
             (8, "resident"))
STRUCT_FRAMES = 14
STRUCT_FX = 400.0  # tests/test_structured_scene.py's FX 100 at 160 px wide
STRUCT_STEP = 0.12  # metres per frame
# Plane A (world X <= X_SPLIT): Z = ZA0 + KA * X; the slab: Z = ZB.
ZA0, KA, ZB, X_SPLIT = 4.0, 0.35, 2.2, 0.8


def pair_params(frame_batch):
    """bench_params() with tests/test_pair_mode.py's solver posture: async
    topology, coalesce_uploads, frame_batch."""
    import dataclasses
    p = bench_params()
    return p.replace(solver=dataclasses.replace(
        p.solver, async_topology=True, coalesce_uploads=True,
        frame_batch=frame_batch))


def pair_run(smi, B, mode):
    """14a: phase 7's plane for PAIR_FRAMES frames at frame_batch B with
    'resident' or 'host' frames. Gates: K2b once in each update that ran
    a batched step and never in another, K1 and K2 once per
    post-Delaunay step, at least 5 (B=2), 3 (B=4) or 2 (B=8) batched
    steps, phase 6's map bounds. Returns the launches and the map's
    coverage and error."""
    import flame_tpu_torch
    from flame_tpu_torch import _kernels
    K, Kinv, frames = (resident_scene if mode == "resident"
                       else scene)(PAIR_FRAMES)
    fl = flame_tpu_torch.Flame(W, H, K, Kinv, pair_params(B))
    _kernels.reset_launches()
    frame_ms, t0 = [], None
    for i in range(PAIR_FRAMES):
        if t0 is None:
            t0 = time.perf_counter()
        k2b = _kernels.LAUNCHES["raster_mesh_batch"]
        d0 = fl._dispatches
        fl.update(i / 30.0, i, pose(i), frames[i], i % 2 == 0)
        stepped = fl._dispatches - d0
        if _kernels.LAUNCHES["raster_mesh_batch"] - k2b != stepped:
            raise AssertionError(f"14a B={B} {mode} frame {i}: K2b "
                                 f"launches for {stepped} batched steps")
        if stepped or not fl._batch_pending:
            torch.cuda.synchronize()
            if stepped or B == 1:
                frame_ms.append(1000 * (time.perf_counter() - t0) / B)
            t0 = None
    label = f"14a frame_batch={B} ({mode} frames)"
    # The first steps include one-time allocations; B=8 has three.
    skip = {1: 4, 2: 2, 4: 2, 8: 1}[B]
    # Read before check_map, whose flush would run single frames.
    stages = stage_medians(fl, ("raster_batch", "update_idepths",
                                "sync_graph", "smoother", "raster"), skip,
                           last=fl._dispatches if B > 1 else None)
    cov, err = check_map(fl, f"{label} {W}x{H}, "
                             f"{fl.params.feature_capacity} features, "
                             f"{PAIR_FRAMES} frames")
    launches = dict(_kernels.LAUNCHES)
    n_post = len(fl.stats.device_times_ms().get("sync_graph", []))
    want_steps = {1: 0, 2: 5, 4: 3, 8: 2}[B]
    if (fl._dispatches > 0) != (B > 1) or fl._dispatches < want_steps \
            or launches["raster_mesh_batch"] != fl._dispatches:
        raise AssertionError(f"{label}: {fl._dispatches} batched steps, "
                             f"K2b launches {launches['raster_mesh_batch']}")
    if n_post < 1 or any(launches[k] != n_post for k in (
            "nltgv2_smoother", "raster_mesh")) or launches["halo_smoother"]:
        raise AssertionError(f"{label}: launches {launches} for {n_post} "
                             f"post-Delaunay steps")
    wall = ("batched step wall incl. synchronize / B" if B > 1
            else "update wall incl. synchronize")
    print(f"{label}: median frame {np.median(frame_ms[skip:]):.3f} ms "
          f"({wall}, {len(frame_ms) - skip} of {len(frame_ms)}), coverage "
          f"{cov:.4f}, median error {err:.5f}, contrast -, slope ratio -; "
          f"{fl._dispatches} batched steps, {n_post} post-Delaunay steps, "
          f"launches {launches} on {smi}")
    print(f"{label}: median ms per {'batched step' if B > 1 else 'frame'}"
          f" (CUDA events): {stages}")
    return launches, cov, err


def pair_phase(smi):
    """14a: frame_batch 1, 2, 4 and 8 on resident frames and 2 on host
    frames, held to tests/test_pair_mode.py's parity bounds: B=2 against
    B=1 (coverage > 0.9x, error < max(2x, 0.01)), B=4 against B=2 (>
    0.85x, < 0.02), host B=2 against resident B=2 (> 0.9x, < 0.02)."""
    res = {run: pair_run(smi, *run) for run in PAIR_RUNS}
    (_, c1, e1), (_, c2, e2) = res[(1, "resident")], res[(2, "resident")]
    (_, c4, e4), (_, ch, eh) = res[(4, "resident")], res[(2, "host")]
    gates = [("B=2 vs B=1", c2 > 0.9 * c1 and e2 < max(2 * e1, 0.01)),
             ("B=4 vs B=2", c4 > 0.85 * c2 and e4 < 0.02),
             ("host B=2 vs resident B=2", ch > 0.9 * c2 and eh < 0.02)]
    print("14a parity: " + "; ".join(f"{n} {'ok' if g else 'FAILED'}"
                                     for n, g in gates))
    if not all(g for _, g in gates):
        raise AssertionError("14a: pair-mode parity out of bounds")
    return [r[0] for r in res.values()]


def two_planes(cam_x, width=W, height=H, fx=STRUCT_FX, tex_scale=None):
    """tests/test_structured_scene.py's ray-cast scene from camera
    (cam_x, 0, 0): a uint8 frame and the true idepth. The texture's
    frequencies scale with tex_scale, by default fx / 100, so that a pixel
    sees the test's texture, as bench.py's plane scales its own: at the
    test's world frequencies a pixel at 320x240 sees half the gradient,
    and both packages then detect ~115 features and lose the slab
    (python tests/torch_structured_witness.py)."""
    vv, uu = np.mgrid[0:height, 0:width].astype(np.float64)
    dx = (uu - width / 2) / fx
    dy = (vv - height / 2) / fx
    ta = (ZA0 + KA * cam_x) / (1.0 - KA * dx)
    xb = cam_x + dx * ZB
    use_b = xb > X_SPLIT  # the closer slab occludes where it exists
    t = np.where(use_b, ZB, ta)
    s = fx / 100.0 if tex_scale is None else tex_scale
    X = s * np.where(use_b, xb, cam_x + dx * ta)
    Y = s * dy * t
    tex = (128 + 60 * np.sin(4.1 * X + 0.9 * Y) + 35 * np.cos(1.73 * X)
           + 18 * np.sin(2.31 * Y) + 10 * np.sin(0.83 * X))
    return (np.clip(tex, 0, 255).astype(np.uint8),
            (1.0 / t).astype(np.float32))


def split_measures(idm, truth, width=W, fx=STRUCT_FX):
    """The JAX test's discontinuity and slant measures at the last camera
    position, its pixel margins scaled with width / 160 (the same
    angles): the medians left and right of the split, and the slope of
    the far plane's column medians against the truth's."""
    s = width / 160.0
    u_split = (X_SPLIT - STRUCT_STEP * (STRUCT_FRAMES - 1)) / ZB * fx \
        + width / 2
    lm = float(np.nanmedian(idm[:, :max(int(u_split - 12 * s), 1)]))
    rm = float(np.nanmedian(idm[:, min(int(u_split + 12 * s), width - 1):]))
    cols = np.arange(int(10 * s), int(u_split - 16 * s))
    col_med = np.array([np.nanmedian(idm[:, c]) for c in cols])
    t_cols = np.array([np.nanmedian(truth[:, c]) for c in cols])
    ok = ~np.isnan(col_med)
    slope = np.polyfit(cols[ok], col_med[ok], 1)[0] \
        / np.polyfit(cols[ok], t_cols[ok], 1)[0]
    return lm, rm, float(slope), int(ok.sum())


def structured_scene(smi):
    """14b: the two-plane scene at 640x480 (FX 400) for STRUCT_FRAMES
    frames, every second one a poseframe, with bench_params() and the
    test's idepth_init, idepth_var_init and height limits on the
    synchronous path. Gates: K1 and K2 once per post-Delaunay step; the
    JAX test's bounds: coverage > 0.3, median relative error < 0.08,
    contrast > 0.12 with the slab within 15% of 1 / ZB, the slope's sign
    and a slope ratio in (0.3, 3) over more than 10 columns."""
    import flame_tpu_torch
    from flame_tpu_torch import _kernels
    K = np.array([[STRUCT_FX, 0, W / 2], [0, STRUCT_FX, H / 2], [0, 0, 1]],
                 np.float32)
    Kinv = np.linalg.inv(K.astype(np.float64)).astype(np.float32)
    params = bench_params().replace(idepth_init=0.05, idepth_var_init=0.25,
                                    min_height=-100.0, max_height=100.0)
    fl = flame_tpu_torch.Flame(W, H, K, Kinv, params)
    frames = [two_planes(STRUCT_STEP * i)[0] for i in range(STRUCT_FRAMES)]
    per_step = step_launches(False)
    _kernels.reset_launches()
    frame_ms = []
    for i in range(STRUCT_FRAMES):
        before = dict(_kernels.LAUNCHES)
        t0 = time.perf_counter()
        ok = fl.update(i / 30.0, i, (np.array([1.0, 0, 0, 0]),
                                     np.array([STRUCT_STEP * i, 0, 0])),
                       frames[i], i % 2 == 0)
        torch.cuda.synchronize()
        if ok:
            frame_ms.append(1000 * (time.perf_counter() - t0))
            ds = {k: _kernels.LAUNCHES[k] - before[k] for k in per_step}
            if ds != per_step:
                raise AssertionError(f"14b frame {i}: launches {ds} (want "
                                     f"{per_step})")
    launches = dict(_kernels.LAUNCHES)
    idm = fl.get_inverse_depth_map()
    truth = two_planes(STRUCT_STEP * (STRUCT_FRAMES - 1))[1]
    cov, err = map_errors(idm, truth)
    lm, rm, slope, n_cols = split_measures(idm, truth)
    skip = 2
    print(f"14b structured scene {W}x{H} (FX {STRUCT_FX:g}), "
          f"{params.feature_capacity} features, "
          f"{STRUCT_FRAMES} frames ({len(frame_ms)} meshed): median frame "
          f"{np.median(frame_ms[skip:]):.3f} ms (update wall incl. "
          f"synchronize, meshed frames {skip + 1}-{len(frame_ms)}), coverage "
          f"{cov:.4f} (> 0.3), median error {err:.5f} (< 0.08), contrast "
          f"{rm - lm:.4f} (> 0.12; left {lm:.4f}, slab {rm:.4f} within 15% "
          f"of {1 / ZB:.4f}), slope ratio {slope:.3f} (0.3-3, {n_cols} "
          f"columns); features {fl._n_valid}, vertices {fl._n_members}; "
          f"launches {launches} on {smi}")
    print("14b median ms per stage (CUDA events): " + stage_medians(
        fl, ("update_idepths", "triangulate", "sync_graph", "smoother",
             "raster"), skip))
    if not (len(frame_ms) >= STRUCT_FRAMES // 2 and cov > 0.3
            and err < 0.08 and rm - lm > 0.12
            and abs(rm - 1 / ZB) <= 0.15 / ZB and n_cols > 10
            and 0.3 < slope < 3.0
            and np.isfinite(idm[~np.isnan(idm)]).all()):
        raise AssertionError("14b: structured scene out of bounds")
    return launches


def pair_and_structure(smi):
    """Phase 14; returns the launch counts of its runs."""
    return pair_phase(smi) + [structured_scene(smi)]


# Phase 15: the Params branches that no other phase switches on.
BRANCH_FRAMES = 16
BRANCH_SYNC = ("default", "letterbox", "continuous_off", "no_meas_fusion",
               "no_subpixel", "grad_check_after_projection",
               "adaptive_data_weights", "filters_off")
# The JAX package's final map (coverage, median relative idepth error) on
# each branch's synchronous run: bench_params() with the branch, phase 6's
# plane and poses, BRANCH_FRAMES frames, taken on the CPU by
#     python tests/torch_branches_witness.py
# (the same Params, frames and poses through flame_tpu.Flame). "default"
# is printed beside the default run; the filters-off run is held to the
# default run of the same call instead.
BRANCH_JAX = {
    "default": (0.95, 0.00057),
    "letterbox": (0.2998, 0.00059),
    "continuous_off": (0.78929, 0.00042),
    "no_meas_fusion": (0.95016, 0.00036),
    "no_subpixel": (0.94888, 0.00342),
    "grad_check_after_projection": (0.94631, 0.00053),
    "adaptive_data_weights": (0.95057, 0.00077),
}
BA_BRANCHES = ("no_rematch", "aniso_weights")
# Each BA branch's bound on ATE with BA / ATE without BA per phase 9 cell,
# beside the JAX package's ratio on the same sequence (noisy poses,
# deterministic schedule; python tests/torch_dataset_witness.py --only ate
# --ba-branch NAME, and --mini for 256x192). BA's gate is 0.8 (phase 9).
# Without re-match BA only has the tracker's 1-D matches, which lie on the
# epipolar lines of the noisy poses, and the JAX package misses 0.8 too
# (ROADMAP section 3): at 256x192 the bound is 1.0; at 640x480 the JAX
# package reads above 1.0 as well, so the bound there is its ratio + 0.05
# (the card's asynchronous schedule moved the default BA's ratio by 0.02
# from the deterministic CPU run).
BA_BRANCH_GATES = {
    ("no_rematch", "256x192"): (1.0, 0.9604),
    ("no_rematch", "640x480"): (1.0091 + 0.05, 1.0091),
    ("aniso_weights", "256x192"): (0.8, 0.7275),
    ("aniso_weights", "640x480"): (0.8, 0.6958),
}
# Params.min_grad_mag of the grad_check_after_projection run: on this
# plane every graph member sees a gradient of at least 7 (median 13), so
# the default 5 drops none; 11.5 drops about a quarter of them.
GRAD_CHECK_MIN = 11.5


def branch_params(name, params=None):
    """params (by default bench_params()) with one Params branch switched
    away from its default: detection.do_letterbox, detection.continuous,
    do_meas_fusion, fparams.sparams.do_subpixel,
    do_grad_check_after_projection (at min_grad_mag GRAD_CHECK_MIN),
    adaptive_data_weights, the three tri_filter filters,
    solver.fetch_stride=2, ba.do_rematch or ba.aniso_weights."""
    from dataclasses import replace
    p = bench_params() if params is None else params
    if name == "default":
        return p
    if name == "letterbox":
        return p.replace(detection=replace(p.detection, do_letterbox=True))
    if name == "continuous_off":
        return p.replace(detection=replace(p.detection, continuous=False))
    if name == "no_meas_fusion":
        return p.replace(do_meas_fusion=False)
    if name == "no_subpixel":
        return p.replace(fparams=replace(p.fparams, sparams=replace(
            p.fparams.sparams, do_subpixel=False)))
    if name == "grad_check_after_projection":
        return p.replace(do_grad_check_after_projection=True,
                         min_grad_mag=GRAD_CHECK_MIN)
    if name == "adaptive_data_weights":
        return p.replace(adaptive_data_weights=True)
    if name == "filters_off":
        return p.replace(tri_filter=replace(
            p.tri_filter, do_oblique_filter=False,
            do_edge_length_filter=False, do_idepth_filter=False))
    if name == "fetch_stride_2":
        return p.replace(solver=replace(p.solver, fetch_stride=2))
    if name == "no_rematch":
        return p.replace(ba=replace(p.ba, do_rematch=False))
    if name == "aniso_weights":
        return p.replace(ba=replace(p.ba, aniso_weights=True))
    raise ValueError(name)


def band_rows(height=H):
    """The rows detection.do_letterbox keeps: the middle third."""
    return height // 3, height - height // 3


def branch_sync_run(smi, name):
    """One branch on phase 6's synchronous path for BRANCH_FRAMES frames:
    K1 and K2 once per post-Delaunay step, and the branch's own reading:
    detection passes after the first meshed update, and under letterbox
    the live features' rows and the map's coverage outside the band.
    Returns (launches, reading)."""
    import flame_tpu_torch
    from flame_tpu_torch import _kernels
    K, Kinv, frames = scene(BRANCH_FRAMES)
    fl = flame_tpu_torch.Flame(W, H, K, Kinv, branch_params(name))
    per_step = step_launches(False)
    _kernels.reset_launches()
    frame_ms, meshed, late_detections = [], 0, 0
    for i in range(BRANCH_FRAMES):
        before = dict(_kernels.LAUNCHES)
        ids = fl._feat_id_counter
        t0 = time.perf_counter()
        ok = fl.update(i / 30.0, i, pose(i), frames[i], i % 2 == 0)
        torch.cuda.synchronize()
        if meshed:  # passes after the first update that meshed
            late_detections += (fl._feat_id_counter - ids) // fl._add_cap
        if ok:
            meshed += 1
            frame_ms.append(1000 * (time.perf_counter() - t0))
            ds = {k: _kernels.LAUNCHES[k] - before[k] for k in per_step}
            if ds != per_step:
                raise AssertionError(f"15 {name} frame {i}: launches {ds} "
                                     f"(want {per_step})")
    launches = dict(_kernels.LAUNCHES)
    if meshed < BRANCH_FRAMES // 2:
        raise AssertionError(f"15 {name}: {meshed} of {BRANCH_FRAMES} "
                             f"frames meshed")
    idm = fl.get_inverse_depth_map()
    if not np.isfinite(idm[~np.isnan(idm)]).all():
        raise AssertionError(f"15 {name}: non-finite map values")
    cov, err = map_errors(idm, 1.0 / PLANE_Z)
    lo, hi = band_rows()
    valid = fl._feats.valid
    rows = torch.cat([fl._feats.xy[valid, 1], fl._curr.xy[fl._curr.valid,
                                                          1]]).cpu().numpy()
    outside = np.ones(H, bool)
    outside[lo:hi] = False
    reading = dict(
        cov=cov, err=err, features=int(valid.sum()),
        late_detections=late_detections,
        rows=(float(rows.min()), float(rows.max())) if rows.size else None,
        cov_outside=float((~np.isnan(idm[outside])).mean()),
        frame_ms=float(np.median(frame_ms[2:])))
    return launches, reading


def branch_sync_phase(smi):
    """15, the synchronous branches, one run each (BRANCH_SYNC), held to
    the JAX package's readings (BRANCH_JAX; tests/test_pair_mode.py's
    factors: coverage > 0.9x, median error < max(2x, 0.01)); letterbox:
    every live feature in the middle third of the rows and the map's
    coverage outside it <= 0.02; continuous off: no detection after the
    first update that meshed; the filters off: coverage >= the default
    run's, error <= 0.01. Returns the launch counts."""
    runs, failed = {}, []
    for name in BRANCH_SYNC:
        runs[name] = branch_sync_run(smi, name)
    base = runs["default"][1]
    lo, hi = band_rows()
    for name in BRANCH_SYNC:
        r = runs[name][1]
        gates = []
        if name in BRANCH_JAX:
            jc, je = BRANCH_JAX[name]
            gates += [(f"coverage {r['cov']:.4f} > 0.9 x JAX {jc:.4f}",
                       r["cov"] > 0.9 * jc),
                      (f"error {r['err']:.5f} < max(2 x JAX {je:.5f}, 0.01)",
                       r["err"] < max(2 * je, 0.01))]
        if name == "letterbox":
            gates += [(f"live feature rows {r['rows']} in [{lo}, {hi})",
                       r["rows"] is not None and r["rows"][0] >= lo
                       and r["rows"][1] < hi),
                      (f"coverage outside the band {r['cov_outside']:.4f} "
                       f"<= 0.02", r["cov_outside"] <= 0.02)]
        if name == "continuous_off":
            gates.append((f"detection passes after the first meshed update "
                          f"{r['late_detections']} == 0",
                          r["late_detections"] == 0))
        if name == "filters_off":
            gates += [(f"coverage {r['cov']:.4f} >= default's "
                       f"{base['cov']:.4f}", r["cov"] >= base["cov"]),
                      (f"error {r['err']:.5f} <= 0.01", r["err"] <= 0.01)]
        if name == "default":
            gates.append((f"error {r['err']:.5f} <= 0.01 and coverage "
                          f"{r['cov']:.4f} >= 0.5",
                          r["err"] <= 0.01 and r["cov"] >= 0.5))
        print(f"15 {name} (synchronous, {W}x{H}, 4096 features, "
              f"{BRANCH_FRAMES} frames): features {r['features']}, median "
              f"frame {r['frame_ms']:.3f} ms on {smi}; "
              + "; ".join(f"{t} {'ok' if g else 'FAILED'}" for t, g in gates))
        failed += [f"{name}: {t}" for t, g in gates if not g]
    if failed:
        raise AssertionError("15: branch gates failed: " + "; ".join(failed))
    return [launches for launches, _ in runs.values()]


def fetch_stride_runs(smi):
    """15, solver.fetch_stride=2 on phase 7's throughput path (resident
    frames, throughput_params()), beside a run at stride 1: each run's
    staged packed transfers counted (constructions of core.flame's
    _AsyncFetch). Gates: phase 7's (map bounds, K2b once per batched step,
    K1 and K2 once per post-Delaunay step, an eviction) on both, and the
    stride-2 run staging half the stride-1 run's transfers, within one.
    Returns the launch counts."""
    from flame_tpu_torch.core import flame as flame_mod
    plain = flame_mod._AsyncFetch
    staged = {}

    class Counted(plain):
        def __init__(self, *a, **kw):
            staged[stride] += 1
            super().__init__(*a, **kw)
    runs = []
    flame_mod._AsyncFetch = Counted
    try:
        for stride in (1, 2):
            staged[stride] = 0
            params = throughput_params()
            if stride == 2:
                params = branch_params("fetch_stride_2", params)
            runs.append(throughput_path(smi, "resident", params=params,
                                        label=f"15 fetch_stride={stride}"))
    finally:
        flame_mod._AsyncFetch = plain
    ok = abs(staged[2] - staged[1] / 2) <= 1
    print(f"15 fetch_stride: staged packed transfers {staged[2]} at stride "
          f"2 against {staged[1]} at stride 1 (half within one: "
          f"{'ok' if ok else 'FAILED'}) on {smi}")
    if not ok:
        raise AssertionError("15: fetch_stride=2 staged transfers")
    return runs


def ba_branch_runs(root, meta, params):
    """15, ba.do_rematch=False and ba.aniso_weights=True on a phase 9
    noisy run with BA (params: the cell's Params with BA, and the
    branch), inside that cell's directory (meta: its generate_mini_tum's),
    each with K1 and K2 once per post-Delaunay step. Returns per branch
    the launch counts and the readings ba_branch_phase gates."""
    from flame_tpu_torch import _kernels
    n_frames = len(meta["gt"])
    out = {}
    for name in BA_BRANCHES:
        _kernels.reset_launches()
        fl, _, frame_ms, solve_ms = dataset_run(
            root, n_frames, branch_params(name, params), meta["K"],
            meta["noisy"], 2)
        launches = dict(_kernels.LAUNCHES)
        n_post = len(fl.stats.device_times_ms().get("sync_graph", []))
        if n_post < 1 or launches["nltgv2_smoother"] != n_post \
                or launches["raster_mesh"] != n_post:
            raise AssertionError(f"15 {name}: launches {launches} for "
                                 f"{n_post} post-Delaunay steps")
        out[name] = dict(
            launches=launches, ate=pf_ate(fl, meta["gt"]),
            applied=int(fl.stats.stats("ba_solves_applied")),
            staged=int(fl.stats.stats("ba_single_solves")),
            frame_ms=float(np.median(frame_ms[4:])),
            solve_ms=(float(np.median([d for d, _ in solve_ms]))
                      if solve_ms else None))
    return out


def ba_branch_phase(smi, cells):
    """15: the BA branches' gates on ba_branch_runs' readings, cells
    {size: (readings, ATE of the cell's noisy run without BA)}: the ATE
    with BA over the one without below BA_BRANCH_GATES' bound, printed
    beside the JAX package's ratio, and a solve applied; then
    aniso_weights' window solve captured as a CUDA graph against its eager
    run (check_ba_graph). Returns the launch counts."""
    failed, launches = [], []
    for size, (res, noisy_ate) in cells.items():
        for name, r in res.items():
            bound, jax_ratio = BA_BRANCH_GATES[name, size]
            ratio = r["ate"] / noisy_ate
            ok = ratio < bound and r["applied"] >= 1
            solve = (f"{r['solve_ms']:.3f} ms" if r["solve_ms"] is not None
                     else "-")
            print(f"15 ba.{name} (phase 9's {size} noisy run with BA): ATE "
                  f"{1000 * r['ate']:.3f} mm, / without BA "
                  f"{1000 * noisy_ate:.3f} mm = {ratio:.4f} (< {bound:.4f}; "
                  f"the JAX package {jax_ratio:.4f}), solves staged "
                  f"{r['staged']}, applied {r['applied']}; median update "
                  f"{r['frame_ms']:.3f} ms, staged solve {solve} on the "
                  f"card on {smi}: {'ok' if ok else 'FAILED'}")
            if not ok:
                failed.append(f"{name} {size}")
            launches.append(r["launches"])
    if failed:
        raise AssertionError(f"15: BA branch gates failed: {failed}")
    from flame_tpu_torch import BAParams
    check_ba_graph(smi, BAParams(aniso_weights=True), "15 aniso_weights: ")
    return launches


def sqrt_rounding(smi, n=1_000_000):
    """The share of n seeded uniform(0, 1) float32 values whose torch.sqrt
    on the card differs from the correctly rounded root (numpy's). XLA's
    root is correctly rounded; torch's CPU kernel is not for about 0.6%
    of such values (python tests/torch_batch_witness.py --sqrt-rn prints
    that share), which moves a search segment by one ulp on the CPU."""
    x = np.random.default_rng(SEED).uniform(0, 1, n).astype(np.float32)
    got = torch.sqrt(torch.as_tensor(x, device="cuda")).cpu().numpy()
    frac = float((got != np.sqrt(x)).mean())
    print(f"15 torch.sqrt on the card: {frac:.6f} of {n} float32 roots "
          f"differ from the correctly rounded ones, on {smi}")
    return frac


def branch_phase(smi, ba_cells):
    """Phase 15; ba_cells: ba_branch_phase's cells, from phase 9's runs.
    Returns the launch counts of its runs."""
    sqrt_rounding(smi)
    runs = (branch_sync_phase(smi) + fetch_stride_runs(smi)
            + ba_branch_phase(smi, ba_cells))
    print("15 launches of the phase's runs: "
          + str({k: sum(r[k] for r in runs) for k in runs[0]}))
    return runs


# The post-Delaunay section's graph kinds (step_graph.KINDS).
SECTION_KINDS = ("post", "smooth", "mesh", "raster")


def graph_run(smi, label, params, frames, K, Kinv, graphed):
    """One phase-16 run: the state after every map read, the host ms of
    update_idepths per frame and of sync_graph per call, the graph
    counters and the number of tracking, detection and post-Delaunay
    calls."""
    import contextlib
    from unittest import mock
    from flame_tpu_torch import _kernels
    from flame_tpu_torch import step_graph
    from flame_tpu_torch.core import pipeline
    fl = make_flame(K, Kinv, params, False)
    B = int(params.solver.frame_batch)
    calls = {"track_project_sync": 0, "_detect_and_insert": 0,
             "_post_delaunay_inner": 0}

    def counted(name):
        orig = getattr(pipeline, name)

        def wrapper(*a, **kw):
            calls[name] += 1
            return orig(*a, **kw)
        return mock.patch.object(pipeline, name, wrapper)
    reads = []
    _kernels.reset_launches()
    with contextlib.ExitStack() as ctx:
        for name in calls:
            ctx.enter_context(counted(name))
        if not graphed:
            ctx.enter_context(mock.patch.object(step_graph, "steps_for",
                                                lambda stack: None))
        for i in range(len(frames)):
            fl.update(i / 30.0, i, pose(i), frames[i], i % 2 == 0)
            if (i + 1) % B == 0:
                m = fl.get_inverse_depth_map()
                state = [m] + [t.cpu().numpy() for t in (
                    [getattr(fl._feats, f) for f in (
                        "xy", "pf_slot", "idepth_mu", "idepth_var", "valid",
                        "num_updates", "num_dropouts", "search_status",
                        "feat_id")]
                    + [fl._curr.xy, fl._curr.idepth, fl._curr.var,
                       fl._curr.valid, fl._last_stats_dev]
                    + [getattr(fl._graph, f) for f in (
                        "pos", "x", "w1", "w2", "q1", "q2", "q3",
                        "edge_mask")] + [fl._tri_validity])]
                reads.append(state)
    torch.cuda.synchronize()
    n_post = calls["_post_delaunay_inner"]
    if (_kernels.LAUNCHES["nltgv2_smoother"] != n_post
            or _kernels.LAUNCHES["raster_mesh"] != n_post):
        raise AssertionError(f"16 {label}: launches {_kernels.LAUNCHES} "
                             f"for {n_post} post-Delaunay calls")
    spans = fl.stats.spans.spans()
    host = [s.ms / B for s in spans if s.name == "update_idepths"][4:]
    sync = [s.ms for s in spans if s.name == "sync_graph"][4:]
    dev = fl.stats.device_times_ms().get("update_idepths", [])[4:]
    counts = {f"{k}_graph_{c}": int(fl.stats.stats(f"{k}_graph_{c}"))
              for k in ("track", "detect") + SECTION_KINDS
              for c in step_graph.COUNTERS}
    print(f"16 {label} {'graphed' if graphed else 'eager'}: update_idepths "
          f"host {np.median(host):.3f} ms a frame (median of {len(host)} "
          f"calls), CUDA events {np.median(dev) / B:.3f} ms a frame; "
          f"sync_graph host {np.median(sync):.3f} ms a call (median of "
          f"{len(sync)}); calls {calls}; counters {counts}; "
          f"{fl._n_valid} features live, coverage "
          f"{float(np.mean(~np.isnan(reads[-1][0]))):.4f} on {smi}")
    return (reads, calls, counts, float(np.median(host)),
            float(np.median(sync)))


def graph_phase(smi, n_frames=40):
    """Phase 16: each posture eager and replayed from CUDA graphs."""
    import dataclasses
    K, Kinv, frames = scene(n_frames)
    postures = (
        ("synchronous", bench_params().replace(photo_error_num_pfs=30)),
        ("batched", throughput_params().replace(solver=dataclasses.replace(
            throughput_params().solver, deterministic=True))))
    out = {}
    for label, params in postures:
        eager, _, _, ms_e, sync_e = graph_run(smi, label, params, frames, K,
                                              Kinv, False)
        graphed, calls, counts, ms_g, sync_g = graph_run(
            smi, label, params, frames, K, Kinv, True)
        if len(eager) != len(graphed) or not eager:
            raise AssertionError(f"16 {label}: {len(eager)} eager reads, "
                                 f"{len(graphed)} graphed")
        for k, (a, b) in enumerate(zip(eager, graphed)):
            for i, (x, y) in enumerate(zip(a, b)):
                if not np.array_equal(x, y, equal_nan=x.dtype.kind == "f"):
                    raise AssertionError(f"16 {label}: read {k} differs "
                                         f"between eager and graphed in "
                                         f"array {i}")
        want = dict(track_graph_captures=1,
                    track_graph_replays=calls["track_project_sync"],
                    track_graph_eager=0, detect_graph_captures=1,
                    detect_graph_replays=calls["_detect_and_insert"],
                    detect_graph_eager=0)
        want.update({f"{k}_graph_{c}": n for k in SECTION_KINDS
                     for c, n in (("captures", 1), ("eager", 0), (
                         "replays", calls["_post_delaunay_inner"]))})
        if counts != want or calls["_detect_and_insert"] < 1:
            raise AssertionError(f"16 {label}: counters {counts}, want "
                                 f"{want}")
        print(f"16 {label}: {len(graphed)} reads bit-equal, eager against "
              f"graphed; update_idepths host ms a frame {ms_e:.3f} eager, "
              f"{ms_g:.3f} graphed ({ms_e / ms_g:.1f}x); sync_graph host "
              f"ms a call {sync_e:.3f} eager, {sync_g:.3f} graphed "
              f"({sync_e / sync_g:.1f}x)")
        out[label] = (ms_e, ms_g, sync_e, sync_g)
    return out


def multichip_layer(smi, g, sharded_ba):
    """Phase 11; returns the launch counts of its main-path runs."""
    dev = g.x.device
    check_sharded_smooth(smi, g)
    runs = check_sharded_step(smi, dev)
    check_sharded_ba(smi, dev)
    runs += check_sharded_flame_ba(smi, sharded_ba)
    check_process_group(smi, g)
    return runs


def main():
    # cuBLAS picks its workspace per stream unless told; a fixed one keeps
    # its matmuls reproducible under torch.use_deterministic_algorithms
    # (phase 10). Read when the first cuBLAS handle is made.
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    smi = environment()
    build()
    dev = torch.device("cuda")
    g, tris, _ = make_graph(dev)
    k1 = check_smoother(g)
    # ROADMAP's XGA row: 8192 features over 1024x768, two vertices per warp.
    check_smoother(make_graph(dev, V=8192, E=3 * 8192, D=16, W=1024,
                              H=768)[0])
    k2 = check_raster(g, tris)
    k2b = check_raster_batch(g, tris)
    k3 = check_halo(g, k1)
    check_ba_graph(smi)
    sync_launches, vertex_map = main_path(smi)
    sharded_launches, _ = main_path(smi, sharded=True, ref_map=vertex_map)
    runs = [sync_launches, sharded_launches] + [
        throughput_path(smi, mode) for mode in ("resident", "host")] + [
        throughput_path(smi, "resident", sharded=True)]
    # Phase 15's BA branches run inside phase 9's directories.
    small, ba_small = dataset_path(
        smi, "dataset path mini-TUM 256x192", 24, 256, 192, 210.0, 2,
        [("true", False, mini_tum_params(False)),
         ("noisy", True, mini_tum_params(False)),
         ("noisy_ba", True, mini_tum_params(True))],
        extra=lambda root, meta, r: (
            ba_branch_runs(root, meta, mini_tum_params(True)),
            r["noisy"]["ate"]))
    vga, (sharded_ba, *ba_vga) = dataset_path(
        smi, "dataset path mini-TUM 640x480", 48, 640, 480, VGA_FX, 2,
        [("true", False, vga_params(True)),
         ("noisy", True, vga_params(False)),
         ("noisy_ba", True, vga_params(True))], gate_err=False,
        extra=lambda root, meta, r: (
            sharded_ba_runs(root, meta, r["noisy"]["ate"]),
            ba_branch_runs(root, meta, vga_params(True)), r["noisy"]["ate"]))
    runs += [small, vga] + api_residue(smi)
    runs += multichip_layer(smi, g, sharded_ba)
    runs += transport_phase(smi)
    runs += bench_phase(smi)
    runs += pair_and_structure(smi)
    runs += branch_phase(smi, {"256x192": ba_small, "640x480": ba_vga})
    graph_phase(smi)
    launches = {k: sum(r[k] for r in runs) for k in runs[0]}
    kernels = [
        dict(name="nltgv2_smoother", route="cuda",
             source="flame_tpu_torch/csrc/nltgv2_smoother.cu",
             replaces="flame_tpu/optimize/pallas_smoother.py:185",
             launches=launches["nltgv2_smoother"], **k1),
        dict(name="raster_mesh", route="cuda",
             source="flame_tpu_torch/csrc/raster.cu",
             replaces="flame_tpu/ops/pallas_raster.py:161",
             launches=launches["raster_mesh"], **k2),
        dict(name="raster_mesh_batch", route="cuda",
             source="flame_tpu_torch/csrc/raster.cu",
             replaces="flame_tpu/ops/pallas_raster.py:233",
             launches=launches["raster_mesh_batch"], **k2b),
        dict(name="halo_smoother", route="cuda",
             source="flame_tpu_torch/csrc/halo_smoother.cu",
             replaces="flame_tpu/parallel/pallas_halo.py:269",
             launches=launches["halo_smoother"], **k3),
    ]
    for k in kernels:
        if k["launches"] < 1:
            raise AssertionError(f"{k['name']} never ran on the main paths")
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    if "--group-rank" in sys.argv:
        a = sys.argv
        group_rank_main(int(a[a.index("--group-rank") + 1]),
                        a[a.index("--coord") + 1], a[a.index("--out") + 1])
    else:
        main()
