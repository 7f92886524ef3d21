"""Flame: the whole-pipeline orchestrator.

Port of flame_tpu/core/flame.py. update() takes one of three paths, as
the JAX package's does:

  * synchronous (solver.async_topology=False): per frame, creation (+
    poseframe insertion); one tracking step over all feature slots, with
    detection and on-device insertion on poseframes; the packed (N, 3)
    snapshot to the host; Delaunay over the 1/32-px quantized members,
    edges and slot ranks; then topology with dual carry-over, graph sync,
    n_iters_per_frame smoother iterations (CUDA kernel K1 on the GPU),
    mesh filters and the dense map (tile kernel K2).
  * asynchronous single frames (async_topology=True): the snapshot goes
    to a pinned host buffer behind a CUDA event, and Delaunay runs on a
    worker thread while the device works on later frames; each frame
    applies the newest topology that has landed. Flow control is the JAX
    package's: at most topology_lag snapshots in flight, a stale head
    shed after join_age frames (max_consecutive_sheds in a row).
  * batched (frame_batch >= 2 under async topology, uint8 frames):
    frame_batch frames buffer, then one pipeline.batch_step tracks them
    in order, draws each frame's own dense map with the batched tile
    kernel K2b and runs the post-Delaunay section once.

solver.deterministic joins every snapshot and triangulation at once,
giving the JAX package's schedule: on the single path the topology runs
one frame behind, one batch behind on the batched path, and with
coalesce_uploads and numpy frames a fresh topology waits for the next
dispatch. The JAX package makes it wait because its words ride the next
image upload; the port keeps the wait, so that both packages run the
same schedule, but uploads the topology as its own small tensors.

The smoother follows solver.smoother as in the JAX package: "auto" and
"vertex" run K1 on the incidence tables; "pallas" runs the RCM-banded
layout through the halo kernel K3 with one partition; "halo" and
"pallas_halo" need a partition mesh (parallel.orchestrator.ShardedFlame)
and raise without one. The banded modes take the host's RCM order and
RCM-order edge ranks with each topology.

When every poseframe slot is taken the oldest poseframe is evicted and
its features re-anchored on the newest survivor (prune_poseframes).

With auto_poseframe, update(is_poseframe=None) declares a poseframe when
the current one has become a poor stereo reference (_want_poseframe, on
float64 host copies of the poses: the probe disparity against
auto_pf_max_disparity, then the keyframe score's hard rejections). Only
that branch copies the caller's pose to the host.

With do_ba, windowed bundle adjustment (ba/window.py) runs beside every
path: the packed transfer is widened with the poseframes' matches and a
state snapshot, and after each single or batched update BundleAdjuster
.step applies a solve that has landed or stages a new one (under
ShardedFlame's mesh, _ba_mesh, it solves with the observation-sharded
assembly and applies at once).

utils/checkpoint.py saves and restores the whole state.

Every update() call is the root span "update" of the stats tracker
(utils/stats.py), tagged with its frame id and poseframe flag; the
stages run as spans inside it ("upload", "frame_creation",
"update_idepths", "triangulate" with "snapshot_wait" and "delaunay",
"topo_upload", "sync_graph" with "smoother" and "raster"; on the batched
path "batch_step", carrying the batch's frame ids, with "raster_batch";
"snapshot_wait" for the async join; "ba" with "ba_stage", which holds
the solve's "ba_solve", and "ba_apply"). A buffered frame that a later
call runs (the next update() once batching disengages, or a map read)
has its own "update" span inside that call's span. The worker thread's
"delaunay" span carries the snapshot's frame ids and a link to the span
that started it; get_inverse_depth_map() is the span "map_read". A
landed snapshot is recorded as "snapshot_flight", from its copy's start
to its landing, and latency_percentiles() reads the update()->map
latency from these spans. On the card every step_graph.KINDS section
replays CUDA graphs (flame_tpu_torch/step_graph.py), counted as
{kind}_graph_{captures,replays,eager}.

Under ShardedFlame over a process group (parallel/orchestrator.py) the
feature and graph state hold this rank's block only. The stages that
read the whole state gather it explicitly (sharding.gather_rows) and
keep their block of the result (sharding.shard_rows): tracking runs on
the block, detection and insertion, the snapshot, topology, graph sync
and the mesh outputs on the gathered state on every rank, the halo
smoothers over the group; pipeline.batch_step does the same per frame
of a batch, and K2b draws the batch's maps on every rank. Every rank
triangulates the same snapshot (the same bits in give the same
triangles; a broadcast of the coordinator's result would add a
collective whose size is known only after the triangulation), and a
decision that depends on timing (has a copy or a triangulation
landed?) is the coordinator's for the whole group (sharding.agree), so
every rank issues the same collectives in the same order from the main
thread. The getters that read feature or graph state gather it: every
rank calls them.
"""

import collections
import sys
import threading
from time import perf_counter
from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from flame_tpu_torch.ba import window as ba_window
from flame_tpu_torch import step_graph
from flame_tpu_torch.core import detection, keyframe, pipeline
from flame_tpu_torch.core import frame as frame_mod
from flame_tpu_torch.geometry import epipolar
from flame_tpu_torch.mesh import delaunay
from flame_tpu_torch.ops import rasterize
from flame_tpu_torch.optimize import nltgv2, smoother_kernel, topology
from flame_tpu_torch.parallel import halo, sharding
from flame_tpu_torch.params import Params
from flame_tpu_torch.utils import visualization
from flame_tpu_torch.utils.stats import StatsTracker


class _AsyncFetch:
    """A device tensor on its way to the host (the packed snapshot, or a
    BA solve's result): a non-blocking copy into a pinned host buffer,
    then a CUDA event. ready() polls the event and get() waits for it, so
    the buffer is never read before the copy has landed. On the CPU the
    copy is taken at once. t_done is when the host first saw the copy
    complete. A copy that failed counts as landed, its error kept in _exc
    and raised by get()."""

    __slots__ = ("_src", "_host", "_event", "_exc", "t_start", "t_done")

    def __init__(self, packed: torch.Tensor):
        self.t_start = perf_counter()
        self.t_done = None
        self._event = None
        self._exc = None
        self._src = None
        if packed.device.type == "cuda":
            self._src = packed  # held until the copy has landed
            self._host = torch.empty(packed.shape, dtype=packed.dtype,
                                     pin_memory=True)
            self._host.copy_(packed, non_blocking=True)
            self._event = torch.cuda.Event()
            self._event.record()
        else:
            self._host = packed.clone()
            self.t_done = self.t_start

    def _landed(self):
        self.t_done = perf_counter()
        self._src = None

    def ready(self) -> bool:
        if self.t_done is None:
            try:
                done = self._event.query()
            except RuntimeError as e:  # the copy failed on the card
                self._exc = e
                done = True
            if done:
                self._landed()
        return self.t_done is not None

    def get(self) -> np.ndarray:
        if self.t_done is None:
            try:
                self._event.synchronize()
            except RuntimeError as e:
                self._exc = e
            self._landed()
        if self._exc is not None:
            raise self._exc
        return self._host.numpy()


class _AsyncWork:
    """fn() on a worker thread, or at once on the caller's (inline). fn
    is numpy and the ctypes Delaunay, which releases the GIL: no torch
    device op runs off the main thread."""

    __slots__ = ("_result", "_exc", "_thread")

    def __init__(self, fn, inline: bool = False):
        self._result = None
        self._exc = None
        self._thread = None
        if inline:
            self._run(fn)
        else:
            self._thread = threading.Thread(target=self._run, args=(fn,),
                                            daemon=True)
            self._thread.start()

    def _run(self, fn):
        try:
            self._result = fn()
        except BaseException as e:  # re-raised on the main thread
            self._exc = e

    def ready(self) -> bool:
        return self._thread is None or not self._thread.is_alive()

    def get(self):
        if self._thread is not None:
            self._thread.join()
        if self._exc is not None:
            raise self._exc
        return self._result


def _f64(x) -> np.ndarray:
    """A float64 host copy of a pose component (waits for the card when
    x is a CUDA tensor)."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy().astype(np.float64)
    return np.asarray(x, np.float64)


class _Topo(NamedTuple):
    """A triangulation on both sides: host (tris_slots, edges_sorted,
    ranks, perm; perm is the RCM order under a banded smoother, else
    None) and the device tensors _post_delaunay_inner takes."""

    host: Tuple[np.ndarray, np.ndarray, np.ndarray]
    dev: dict


class Flame:
    """Dense inverse-depth mesh estimation (reference flame.h:96). It
    runs on the card unless `device` names another."""

    # Partition mesh of the "halo" / "pallas_halo" smoothers; set by
    # ShardedFlame before Flame.__init__ runs. None: no mesh.
    _sharding_mesh = None

    def __init__(self, width: int, height: int, K, Kinv,
                 params: Optional[Params] = None, *, device="cuda"):
        p = params or Params()
        self.params = p
        self.width = width
        self.height = height
        self.device = torch.device(device)
        if self.device.type == "cuda" and self.device.index is None:
            self.device = torch.device("cuda", torch.cuda.current_device())
        if p.do_ba and p.feature_capacity % 2:
            raise ValueError("do_ba needs an even feature_capacity "
                             "(u16-pair words in pack_ba_outputs)")
        if p.do_ba and p.poseframe_capacity > 128:
            raise ValueError("do_ba packs pf_slot into bits 24..30 of the "
                             "id_slot word; poseframe_capacity must be "
                             "<= 128 (pack_ba_outputs)")
        self._smoother_mode = pipeline.resolve_smoother(p)
        # The banded smoothers take the RCM order and RCM-order ranks
        # with each topology instead of the incidence tables.
        self._pallas_layout = (self._smoother_mode
                               in pipeline.RANK_LAYOUT_SMOOTHERS)
        if self._smoother_mode in ("halo", "pallas_halo") \
                and self._sharding_mesh is None:
            raise ValueError(
                f"smoother={self._smoother_mode!r} needs a partition mesh; "
                f"use parallel.orchestrator.ShardedFlame")
        lim = int(65536 / pipeline.PACK_XY_SCALE)
        if width >= lim or height >= lim:
            raise ValueError(f"image {width}x{height} exceeds the packed "
                             f"coordinate range (< {lim} px per side)")
        if self.device.type == "cuda":
            # Geometry needs full float32 matmuls (small-baseline
            # projections shift by tenths of a pixel under TF32).
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
        self.K = torch.as_tensor(np.asarray(K), dtype=torch.float32,
                                 device=self.device)
        self.Kinv = torch.as_tensor(np.asarray(Kinv), dtype=torch.float32,
                                    device=self.device)
        # Host copies for _want_poseframe, which runs on the host.
        self._K_np = self.K.cpu().numpy().astype(np.float64)
        self._Kinv_np = self.Kinv.cpu().numpy().astype(np.float64)
        self.stats = StatsTracker(device=self.device)
        self.inited = False
        self.num_imgs = 0
        self.num_data_updates = 0
        self.num_regularizer_updates = 0
        self._stack = frame_mod.empty_stack(p.poseframe_capacity, height,
                                            width, p.pad, self.device)
        self._pf_free = list(range(p.poseframe_capacity))
        self._pf_slot_by_id: Dict[int, int] = {}
        self._curr_pf_slot: Optional[int] = None
        self._curr_pf_id: Optional[int] = None
        # Float64 host pose of the current poseframe (auto_poseframe).
        self._curr_pf_pose_np = None
        self._fnew = None
        self._fprev = None
        self._feat_id_counter = 0
        self._last_stats_dev = torch.zeros(pipeline.N_STATS,
                                           dtype=torch.int32)
        self._last_dispatch_frames = 1
        self._cy = -(-height // p.detection.win_size)
        self._cx = -(-width // p.detection.win_size)
        self._add_cap = self._cy * self._cx
        self._warned_capacity = False
        # Async and batch state that outlives clear(): snapshots whose copy
        # cannot be cancelled (shed or cleared; they keep their place in
        # the in-flight count until they land), the first span seq that
        # counts for update->map latency, dispatch counters.
        self._packed_queue = collections.deque()
        self._zombie_fetches = []
        self._latency_seq0 = 0
        self._newest_frame = None
        self._dispatches = 0
        self._coalesce = False
        # Per-step largest per-tile union-candidate count of the batched
        # raster (device scalars, read without a sync per step).
        self._raster_union = collections.deque(maxlen=256)
        self._warned_ba_obs_drop = False
        self._warned_zombie_exc = False
        self._ba = (ba_window.BundleAdjuster(
            p.ba, self.K, self.Kinv, mesh=getattr(self, "_ba_mesh", None))
            if p.do_ba else None)
        self.clear()

    def clear(self):
        """Reset features, graph, mesh and the topology pipeline;
        poseframes survive (reference flame.h:179-202)."""
        p, dev = self.params, self.device
        N = p.feature_capacity
        self.inited = False
        self._feats = pipeline.empty_features(N, dev)
        self._curr = pipeline.empty_curr(N, dev)
        self._graph = nltgv2.empty(N, p.edge_capacity,
                                   p.solver.max_vertex_degree, dev)
        self._graph_scale = torch.ones((), device=dev)
        self._tris = torch.zeros((p.triangle_capacity, 3), dtype=torch.int64,
                                 device=dev)
        self._tri_validity = torch.zeros(p.triangle_capacity,
                                         dtype=torch.bool, device=dev)
        self._vtx_idepths = torch.zeros(N, device=dev)
        self._vtx_normals = torch.zeros((N, 3), device=dev)
        self._idepthmap = torch.full((self.height, self.width),
                                     float("nan"), device=dev)
        self._coverage = None
        self._edges_np = np.zeros((0, 2), np.int64)
        self._n_edges = 0
        self._n_tris = 0
        self._n_members = 0
        # Topology pipeline: the single path's staged topology, the
        # triangulation in flight, one adopted but not yet applied
        # (coalesce), the last applied one (host, and its device copy).
        self._staged: Optional[_Topo] = None
        self._tri_pending = None
        self._pending_topo = None
        self._last_topo_host = None
        self._topo_dev: Optional[_Topo] = None
        self._last_sync_pose = None
        self._batch_pending = []
        # Queued transfers cannot be cancelled: they become zombies. The
        # BA store, snapshot and solve in flight stay, as in the JAX
        # package: the write-back guards reject the cleared features.
        for pk, _frame, _meta, _fids in self._packed_queue:
            self._zombie_fetches.append((pk, None))
        self._packed_queue.clear()
        self._sheds_since_consume = 0
        self._feat_valid_np = np.zeros(N, bool)
        self._n_valid = 0

    # ------------------------------------------------------------------
    # Main entry point (reference flame.cc:127-552).
    # ------------------------------------------------------------------

    def update(self, time: float, frame_id: int, pose, img,
               is_poseframe: Optional[bool] = None) -> bool:
        """Process one posed image; pose = (q wxyz, t) camera-to-world,
        img a (H, W) uint8 numpy array ("host") or a uint8 tensor on the
        Flame's device ("resident"). is_poseframe=None leaves the decision
        to the automatic selector under params.auto_poseframe, else means
        False (the reference's caller decides, flame.h:145-147). Returns
        False while bootstrapping or when the frame cannot produce a mesh;
        a frame buffered for a batch returns True. The call is the root
        span "update" of the frame's spans."""
        self._newest_frame = frame_id
        with self.stats.span("update", frames=(frame_id,),
                             poseframe=is_poseframe, timing="update") as sp:
            return self._update(sp, frame_id, pose, img, is_poseframe)

    def _update(self, sp, frame_id: int, pose, img,
                is_poseframe: Optional[bool]) -> bool:
        p = self.params
        self._poll_fetches()
        q_np = t_np = None
        if is_poseframe is None and p.auto_poseframe:
            q_np, t_np = _f64(pose[0]), _f64(pose[1])
            is_poseframe = self._want_poseframe(q_np, t_np)
        is_poseframe = bool(is_poseframe)
        sp.poseframe = is_poseframe
        q = self._as_pose_tensor(pose[0])
        t = self._as_pose_tensor(pose[1])

        if self._batch_ok(img):
            if is_poseframe and p.auto_poseframe:
                # Later buffered frames compare against this pose (its slot
                # is allocated at dispatch); against the stale poseframe
                # each of them could trip the disparity test and declare
                # back-to-back poseframes that the single path would not.
                self._curr_pf_pose_np = self._host_pose(q, t, q_np, t_np)
            self._batch_pending.append((frame_id, q, t, img, is_poseframe,
                                        q_np, t_np))
            if len(self._batch_pending) < int(p.solver.frame_batch):
                return True
            frames = self._batch_pending
            self._batch_pending = []
            return self._update_batch(frames)
        self._flush_batch()
        return self._update_single(frame_id, q, t, img, is_poseframe, q_np,
                                   t_np)

    @staticmethod
    def _host_pose(q, t, q_np, t_np):
        """The float64 host pose: the copies update() took, else copies of
        the pose tensors."""
        if q_np is None:
            return _f64(q), _f64(t)
        return q_np, t_np

    def _as_pose_tensor(self, x) -> torch.Tensor:
        if isinstance(x, torch.Tensor):
            return x.to(device=self.device, dtype=torch.float32)
        return torch.as_tensor(np.asarray(x, np.float32), device=self.device)

    def _img_mode(self, img) -> Optional[str]:
        """'host' for a numpy uint8 image, 'resident' for a uint8 tensor
        on the Flame's device, else None (not eligible for batching)."""
        if isinstance(img, np.ndarray) and img.dtype == np.uint8:
            return "host"
        if isinstance(img, torch.Tensor) and img.dtype == torch.uint8 \
                and img.device == self.device:
            return "resident"
        return None

    def _batch_ok(self, img) -> bool:
        """Steady-state eligibility for the batched step. coalesce_uploads
        is required only for host images, as in the JAX package, so that
        both packages batch the same frames."""
        p = self.params
        mode = self._img_mode(img)
        return (p.solver.frame_batch >= 2 and p.solver.async_topology
                and (p.solver.coalesce_uploads or mode == "resident")
                and self.inited and self._curr_pf_slot is not None
                and self._fnew is not None
                and self._last_topo_host is not None
                and mode is not None
                and (not self._batch_pending
                     or self._img_mode(self._batch_pending[0][3]) == mode)
                and (self._n_valid > 0 or bool(self._packed_queue)))

    def _flush_batch(self):
        """Run buffered batch frames through the single-frame path (when
        batching disengages, or a caller needs every update reflected)."""
        if not self._batch_pending:
            return
        pending = self._batch_pending
        self._batch_pending = []
        for fid, q, t, img, is_pf, q_np, t_np in pending:
            with self.stats.span("update", frames=(fid,), poseframe=is_pf,
                                 timing="update"):
                self._update_single(fid, q, t, img, is_pf, q_np, t_np)

    def _prepare_upload(self, img) -> torch.Tensor:
        """The frame's image on the device. With coalesce_uploads, async
        topology and a host image, a topology adopted on an earlier frame
        is staged now (see the module docstring)."""
        p = self.params
        self._coalesce = bool(p.solver.coalesce_uploads
                              and p.solver.async_topology
                              and self._img_mode(img) == "host")
        if self._coalesce and self._pending_topo is not None:
            host = self._pending_topo
            self._pending_topo = None
            self._stage(host)
        with self.stats.span("upload"):
            if isinstance(img, torch.Tensor):
                return img.to(self.device)
            return torch.as_tensor(np.asarray(img), device=self.device)

    def _update_single(self, frame_id: int, q, t, img, is_poseframe: bool,
                       q_np=None, t_np=None) -> bool:
        p = self.params
        img = self._prepare_upload(img)
        fast = (self.inited and self._curr_pf_slot is not None
                and self._fnew is not None
                and (self._n_valid > 0 or bool(self._packed_queue)))
        if is_poseframe:
            self._new_poseframe(frame_id, q, t, q_np, t_np)
        self.num_imgs += 1

        with self.stats.timed("frame_creation"):
            self._fprev = self._fnew
            self._fnew = frame_mod.create(frame_id, q, t, img, p.pad)
            if is_poseframe:
                frame_mod.insert(self._stack, self._curr_pf_slot, self._fnew)

        if not fast:
            # Cold path: bootstrap (reference flame.cc:174-242).
            if self.num_imgs < 2 or self._curr_pf_slot is None:
                return self._done(False)
            if not self.inited and is_poseframe and self._n_valid == 0:
                if p.solver.async_topology and self._packed_queue:
                    # Consume the newest snapshot for a current mirror; the
                    # older ones become zombies until their copies land.
                    pk, pk_frame, pk_meta, pk_fids = self._packed_queue[-1]
                    for old, _fr, old_meta, old_fids in \
                            list(self._packed_queue)[:-1]:
                        self._zombie_fetches.append((old, old_fids))
                        self._note_ba_obs_drop(sum(old_meta[1]))
                    self._packed_queue.clear()
                    self._sheds_since_consume = 0
                    with self.stats.span("snapshot_wait"):
                        pk_np = pk.get()
                    self._consume_packed(pk_np, pk_frame, pk_meta)
                    self._note_latency(pk, pk_fids)
                if self._n_valid == 0:
                    self._bootstrap_detect(self._curr_pf_slot)
            if self._n_valid == 0 and not self._packed_queue:
                return self._done(False)

        do_detect = bool(is_poseframe and self._fprev is not None
                         and (p.detection.continuous
                              or self.num_data_updates < 1))
        prev = self._fprev if self._fprev is not None else self._fnew
        with self.stats.timed("update_idepths"):
            (self._feats, curr, member, stat_vec, _obs,
             packed) = pipeline.track_step(
                p, self.K, self.Kinv, self._stack, self._feats, self._fnew,
                self._curr_pf_slot, prev.q, prev.t, do_detect,
                self._feat_id_counter, self._idepthmap,
                mesh=self._sharding_mesh)
        if do_detect:
            self._feat_id_counter += self._add_cap
        self._curr = sharding.shard_rows(curr, self._sharding_mesh)
        self._last_stats_dev = stat_vec
        self._last_dispatch_frames = 1

        if p.solver.async_topology:
            if not self._drain_packed_queue():
                return self._done(False)
        if self._n_valid == 0:
            return self._done(False)

        if p.solver.async_topology:
            stride = max(int(p.solver.fetch_stride), 1)
            if (self.num_imgs % stride == 0 or not self.inited) \
                    and self._in_flight_fetches() < max(
                        int(p.solver.topology_lag), 1):
                self._packed_queue.append((
                    _AsyncFetch(packed), self.num_imgs,
                    ([frame_id], [is_poseframe]), [frame_id]))
            elif is_poseframe:
                self._note_ba_obs_drop(1)
            # Adopt a finished triangulation (forced while nothing is
            # staged, so that the first mesh appears at once).
            self._adopt_tri_result(force=bool(p.solver.deterministic)
                                   or self._staged is None)
            if self._staged is not None:
                with self.stats.timed("sync_graph"):
                    self._run_post_delaunay(member, curr, self._staged)
        else:
            with self.stats.timed("triangulate"):
                with self.stats.span("snapshot_wait"):
                    pk_np = pipeline.as_numpy_packed(packed)
                ok = self._consume_packed(pk_np, self.num_imgs,
                                          ([frame_id], [is_poseframe]))
                if ok:
                    self._adopt_tri_result(force=True)
            if not ok or self._staged is None:
                return self._done(False)
            with self.stats.timed("sync_graph"):
                self._run_post_delaunay(member, curr, self._staged)

        if is_poseframe:
            frame_mod.set_idepthmap(self._stack, self._curr_pf_slot,
                                    self._idepthmap)
        self._ba_step()
        self._set_counts()
        self.inited = True
        self.num_data_updates += 1
        return self._done(True)

    def _update_batch(self, frames) -> bool:
        """One pipeline.batch_step over frame_batch buffered frames. The
        bookkeeping runs in the JAX package's order: poseframe slots for
        all frames are allocated before the step, so an eviction re-anchors
        on the pre-batch stack and a freed slot can go to a later frame of
        the same batch. Over a process group the step takes and returns
        the rank's blocks of the feature and graph state."""
        p, dev = self.params, self.device
        B = len(frames)
        self._coalesce = True
        prev_q, prev_t = self._fnew.q, self._fnew.t
        sync_q, sync_t = (self._last_sync_pose
                          if self._last_sync_pose is not None
                          else (prev_q, prev_t))
        fids, qs, ts = [], [], []
        pf_flags, det_flags, pf_slots, id_bases = [], [], [], []
        for fid, q, t, _img, is_pf, q_np, t_np in frames:
            if is_pf:
                self._new_poseframe(fid, q, t, q_np, t_np)
            det = bool(is_pf and (p.detection.continuous
                                  or self.num_data_updates < 1))
            self.num_imgs += 1
            fids.append(fid)
            qs.append(q)
            ts.append(t)
            pf_flags.append(is_pf)
            det_flags.append(det)
            pf_slots.append(self._curr_pf_slot)
            id_bases.append(self._feat_id_counter)
            if det:
                self._feat_id_counter += self._add_cap

        # The step's spans carry every frame id of the batch.
        with self.stats.span("batch_step", frames=tuple(fids)):
            if self._pending_topo is not None:
                # A fresh triangulation applies in this step; the graph's
                # edges move past the single path's staged topology.
                self._last_topo_host = self._pending_topo
                self._pending_topo = None
                self._topo_dev = None
                self._staged = None
            if self._topo_dev is None:
                self._topo_dev = self._upload(self._last_topo_host)
            topo = self._topo_dev
            with self.stats.span("upload"):
                if self._img_mode(frames[0][3]) == "resident":
                    imgs = [f[3] for f in frames]
                else:  # one upload for the batch's images
                    imgs = list(torch.as_tensor(
                        np.stack([f[3] for f in frames]), device=dev))

            (fnew, self._stack, self._feats, self._curr, member,
             self._last_stats_dev, packed, self._graph, self._vtx_idepths,
             self._vtx_normals, self._tri_validity, self._idepthmap,
             self._graph_scale, self._coverage,
             max_union) = pipeline.batch_step(
                p, self.K, self.Kinv, self._stack, self._feats, self._graph,
                self._graph_scale, imgs, fids, qs, ts, pf_flags, det_flags,
                pf_slots, id_bases, prev_q, prev_t, sync_q, sync_t,
                self._idepthmap, topo.dev, self.width, self.height,
                mesh=self._sharding_mesh, timed=self.stats.timed)
        self._raster_union.append(max_union)
        self._fprev = self._fnew
        self._fnew = fnew
        self._last_dispatch_frames = B
        self._last_sync_pose = (fnew.q, fnew.t)
        self._set_applied(topo)
        if p.do_nltgv2:
            self.num_regularizer_updates += p.solver.n_iters_per_frame
        self._dispatches += 1

        if not self._drain_packed_queue():
            return self._done(False)
        stride = max(int(p.solver.fetch_stride), 1)
        if self._dispatches % stride == 0 and self._in_flight_fetches() \
                < max(int(p.solver.topology_lag), 1):
            self._packed_queue.append((
                _AsyncFetch(packed), self.num_imgs, (fids, pf_flags),
                list(fids)))
        else:
            self._note_ba_obs_drop(sum(pf_flags))
        self._adopt_tri_result(force=bool(p.solver.deterministic))
        self._ba_step()
        self._set_counts()
        self.num_data_updates += B
        return self._done(True, frames=B)

    def _done(self, result: bool, frames: int = 1) -> bool:
        self._copy_graph_counts()
        ms = self.stats.elapsed_ms("update")
        if result and ms > 0:
            self.stats.ema("fps_max", frames * 1000.0 / ms)
        return result

    def _copy_graph_counts(self) -> None:
        """Copy the stack's graph counters (step_graph.counts) to stats."""
        for k, v in step_graph.counts(self._stack).items():
            self.stats.set(k, v)

    def _ba_step(self):
        """Advance the BA pipeline: apply a landed solve or stage a new
        one (BundleAdjuster.step; no blocking device reads)."""
        if self._ba is not None:
            with self.stats.timed("ba"):
                self._ba.step(self)

    def _note_ba_obs_drop(self, n_pfs: int):
        """A dispatch's packed transfer was not staged (queue full, stride
        skip, shed, or dropped at bootstrap), so its poseframes' BA
        observations never reach the store: counted, never silent."""
        if self._ba is None or n_pfs == 0:
            return
        self.stats.add("ba_obs_dropped_pfs", n_pfs)
        if not self._warned_ba_obs_drop:
            self._warned_ba_obs_drop = True
            print("flame_tpu_torch: BA observations dropped for a poseframe "
                  "(packed transfer not staged; see "
                  "stats['ba_obs_dropped_pfs'])", file=sys.stderr)

    def _agree(self, flag: bool) -> bool:
        """A decision that depends on timing, taken by the coordinator for
        the whole group under a process-group mesh (sharding.agree)."""
        return sharding.agree(flag, self._sharding_mesh)

    def _set_counts(self):
        self.stats.set("num_feats", self._n_valid)
        self.stats.set("num_vtx", self._n_members)
        self.stats.set("num_tris", self._n_tris)
        self.stats.set("num_edges", self._n_edges)

    # ------------------------------------------------------------------
    # Host helpers: snapshots, triangulation, topology staging.
    # ------------------------------------------------------------------

    def _drain_packed_queue(self) -> bool:
        """Consume every snapshot that has landed (all of them in
        deterministic mode). A stale in-flight head (age >= join_age
        frames) is shed without blocking, at most max_consecutive_sheds
        in a row; past that budget it is joined, at most once per drain.
        A shed copy cannot be cancelled on the card either: it stays on
        the zombie list, counted in flight, until it lands. Returns False
        when a consumed snapshot cleared the instance."""
        p = self.params
        join_age = int(p.solver.join_age) or (
            max(int(p.solver.topology_lag), 1)
            * max(int(p.solver.fetch_stride), 1))
        shed_budget = max(int(p.solver.max_consecutive_sheds), 0)
        det = bool(p.solver.deterministic)
        joined_any = False
        while self._packed_queue:
            pk, pk_frame, pk_meta, pk_fids = self._packed_queue[0]
            ready = self._agree(pk.ready())
            if not (det or ready):
                if self.num_imgs - pk_frame < join_age:
                    break  # young in-flight head: let it land on its own
                if self._sheds_since_consume < shed_budget:
                    self._packed_queue.popleft()
                    self._zombie_fetches.append((pk, pk_fids))
                    self._sheds_since_consume += 1
                    self.stats.add("packed_sheds", 1)
                    self.stats.ema("fetch_ready_frac", 0.0, alpha=0.2)
                    self._note_ba_obs_drop(sum(pk_meta[1]))
                    continue
                if joined_any:
                    break
            self._packed_queue.popleft()
            self.stats.ema("fetch_ready_frac", 1.0 if ready else 0.0,
                           alpha=0.2)
            with self.stats.span("snapshot_wait", timing="fetch_packed"):
                pk_np = pk.get()
            joined_any = True
            self._sheds_since_consume = 0
            self.stats.ema("fetch_latency_ms", 1e3 * (pk.t_done - pk.t_start),
                           alpha=0.2)
            self._note_latency(pk, pk_fids)
            if not self._consume_packed(pk_np, pk_frame, pk_meta):
                return False
        self._reap_zombies()
        return True

    def _poll_fetches(self):
        """Query the events of the snapshots in flight, so that each
        landing time (and its latency sample) is known to within one
        update() call even while frames only buffer."""
        for pk, _frame, _meta, _fids in self._packed_queue:
            pk.ready()
        for pk, _fids in self._zombie_fetches:
            pk.ready()

    def _reap_zombies(self):
        """Drop shed snapshots whose copy has landed, keeping their
        latency samples. A failed copy is counted and warned about once,
        not raised: the pipeline already went on without its bytes, and a
        fault of the card surfaces at the next live step."""
        live = []
        for pk, fids in self._zombie_fetches:
            if not self._agree(pk.ready()):
                live.append((pk, fids))
                continue
            if pk._exc is not None:
                self.stats.add("zombie_fetch_errors", 1)
                if not self._warned_zombie_exc:
                    self._warned_zombie_exc = True
                    print(f"flame_tpu_torch: shed snapshot copy failed "
                          f"({type(pk._exc).__name__}); see "
                          f"stats['zombie_fetch_errors']", file=sys.stderr)
                continue
            pk.get()  # the coordinator's copy landed; wait for ours
            self._note_latency(pk, fids)
        self._zombie_fetches = live

    def _in_flight_fetches(self) -> int:
        """Snapshots whose copy is still in flight: queued + zombies."""
        self._reap_zombies()
        return len(self._packed_queue) + len(self._zombie_fetches)

    def _note_latency(self, pk: _AsyncFetch, fids):
        """A landed snapshot's flight, from its copy's start to when the
        host first saw it land, as the span "snapshot_flight" with the ids
        of the frames whose update()->map latency it bounds (fids; None
        for a snapshot cleared in flight): it was copied after its step's
        dense map, so its landing bounds when the map existed."""
        if pk.t_done is None:
            return
        self.stats.record(
            "snapshot_flight", round(pk.t_start * 1e9), round(pk.t_done * 1e9),
            frames=tuple(f for f in fids or () if f is not None),
            link=self.stats.current())

    def _restart_latency(self):
        """Latency samples restart here: frames handed to update() before
        now are not sampled."""
        self._latency_seq0 = self.stats.next_seq()

    def _latency_ms(self) -> list:
        """update()->map latency samples in ms: for each frame of each
        snapshot_flight span in the tracker's ring, the flight's end less
        the start of the frame's first update span, both since the last
        _restart_latency()."""
        seq0 = self._latency_seq0
        entry, flights = {}, []
        for s in self.stats.spans.spans():
            if s.seq < seq0:
                continue
            if s.name == "update":
                f = s.frames[0]
                if s.start_ns < entry.get(f, s.start_ns + 1):
                    entry[f] = s.start_ns
            elif s.name == "snapshot_flight":
                flights.append(s)
        return [1e-6 * (s.end_ns - entry[f]) for s in flights
                for f in s.frames if f in entry]

    def latency_percentiles(self, qs=(50.0, 95.0)):
        """Percentiles (default p50, p95) of the update()->map latency in
        ms, from the async path's landed snapshots; None without
        samples."""
        samples = self._latency_ms()
        if not samples:
            return None
        return [float(v) for v in np.percentile(np.asarray(samples), qs)]

    def _consume_packed(self, packed: np.ndarray,
                        packed_frame: Optional[int] = None,
                        meta=None) -> bool:
        """Update the host mirrors from a snapshot and start its
        triangulation (joined by _adopt_tri_result; on a worker thread
        under async topology). False when too few features survive: the
        state is cleared (reference flame.cc:281-290). meta: (fids,
        pf_flags) of the dispatch that staged the transfer; BA attributes
        the widened transfer's per-frame matches with it."""
        p = self.params
        packed = pipeline.host_packed(packed)
        if self._ba is not None:
            packed, snap = ba_window.split_packed(p, packed)
            if snap is not None and meta is not None:
                self._ba.ingest_snapshot(snap, *meta)
        flags = packed[:, 2]
        member_np = (flags & pipeline.PACK_MEMBER) > 0
        self._feat_valid_np = (flags & pipeline.PACK_FEAT_VALID) > 0
        self._n_valid = int(self._feat_valid_np.sum())
        self._n_members = int(member_np.sum())
        if int(((flags & pipeline.PACK_CURR_VALID) > 0).sum()) < 3:
            if not p.debug_quiet:
                print("flame_tpu_torch: too few features; clearing")
            self.clear()
            return False
        # A triangulation still pending is adopted first, never dropped.
        self._adopt_tri_result(force=bool(p.solver.deterministic)
                               or self._tri_pending is not None)
        # The triangulation's span carries the snapshot's frame ids and a
        # link to the span that started it (on the worker it is a root).
        frames = None if meta is None else tuple(meta[0])
        link = self.stats.current()
        self._tri_pending = (_AsyncWork(
            lambda pk=packed: self._host_triangulate(pk, frames, link),
            inline=not p.solver.async_topology), packed_frame)
        return True

    def _adopt_tri_result(self, force: bool):
        """Join the pending triangulation if it is done (or force) and
        stage it; under coalesce it waits for the next dispatch."""
        if self._tri_pending is None:
            return
        work, _frame = self._tri_pending
        if not (force or self._agree(work.ready())):
            return
        self._tri_pending = None
        host = work.get()
        if host is None:  # too few members, or degenerate
            return
        if self._coalesce:
            self._pending_topo = host
            return
        # This newer triangulation supersedes one stashed by a batch.
        self._pending_topo = None
        self._stage(host)

    def _stage(self, host):
        self._last_topo_host = host
        self._topo_dev = self._staged = self._upload(host)

    def _upload(self, host) -> _Topo:
        p, dev = self.params, self.device
        tris_slots, edges_sorted, ranks, perm = host
        with self.stats.timed("topo_upload"):
            tris = np.zeros((p.triangle_capacity, 3), np.int64)
            tris[:tris_slots.shape[0]] = tris_slots
            edges = np.zeros((p.edge_capacity, 2), np.int64)
            edges[:edges_sorted.shape[0]] = edges_sorted
            return _Topo(host=host, dev=dict(
                tris=torch.as_tensor(tris, device=dev),
                n_tris=int(tris_slots.shape[0]),
                edges=torch.as_tensor(edges, device=dev),
                n_edges=int(edges_sorted.shape[0]),
                edge_ranks=torch.as_tensor(ranks, device=dev),
                perm=None if perm is None else torch.as_tensor(perm,
                                                               device=dev)))

    def _set_applied(self, topo: _Topo):
        """Mirrors of the topology the graph now holds (mesh getter)."""
        self._tris = topo.dev["tris"]
        self._n_tris = topo.dev["n_tris"]
        self._n_edges = topo.dev["n_edges"]
        self._edges_np = topo.host[1]

    def _host_triangulate(self, pk: np.ndarray, frames=None, link: int = -1):
        """Delaunay over the members of the packed snapshot, plus the
        sorted unique edges and their slot ranks, or under a banded
        smoother the RCM order of the members and the edges' ranks in it
        (core/flame.py:1001-1175 of the JAX package). Numpy and ctypes
        only (it may run on the worker thread). None when fewer than 3
        distinct members or the member set is degenerate. It runs in the
        span "delaunay" on its thread, tagged with frames (the snapshot's
        frame ids) and link."""
        with self.stats.span("delaunay", frames=frames, link=link,
                             timing="delaunay"):
            return self._triangulate_members(pk)

    def _triangulate_members(self, pk: np.ndarray):
        p = self.params
        V = p.feature_capacity
        member_slots = np.nonzero((pk[:, 2] & pipeline.PACK_MEMBER) > 0)[0]
        # Members on the same 1/32-px position would make Delaunay
        # ill-posed; keep the first of each.
        codes = (pk[member_slots, 0].astype(np.int64) << 16) \
            | pk[member_slots, 1].astype(np.int64)
        _, uniq_idx = np.unique(codes, return_index=True)
        n_dup = member_slots.shape[0] - uniq_idx.shape[0]
        if n_dup:
            member_slots = member_slots[np.sort(uniq_idx)]
        self.stats.set("members_deduped", n_dup)
        if member_slots.shape[0] < 3:
            return None
        xy = pk[member_slots, :2].astype(np.float32) \
            * (1.0 / pipeline.PACK_XY_SCALE)
        try:
            tri = delaunay.triangulate(xy)
        except ValueError:
            tri = None
        if tri is not None:
            # How near the jump lands: triangles a point's walk visited.
            self.stats.set("delaunay_walk_steps",
                           tri.walk_steps / xy.shape[0])
        if tri is None or tri.triangles.shape[0] == 0:
            # Degenerate (collinear) member set: keep the old topology.
            self.stats.add("triangulate_degenerate", 1)
            return None

        tris_slots = member_slots[tri.triangles]
        n_tris_dropped = max(tris_slots.shape[0] - p.triangle_capacity, 0)
        tris_slots = tris_slots[:p.triangle_capacity]

        # Unique undirected edges of the (possibly truncated) triangle
        # set, canonical (lo, hi), sorted by lo*V+hi.
        a = tris_slots.reshape(-1).astype(np.int64)
        b = tris_slots[:, [1, 2, 0]].reshape(-1).astype(np.int64)
        dcode = np.minimum(a, b) * V + np.maximum(a, b)
        ucodes = np.unique(dcode)
        n_edges_dropped = max(ucodes.shape[0] - p.edge_capacity, 0)
        ucodes = ucodes[:p.edge_capacity]
        edges_sorted = np.stack([ucodes // V, ucodes % V], axis=1)
        n_edges = edges_sorted.shape[0]

        # Shortest edges take the lowest slot ranks, so degree overflow
        # drops the longest (weakest alpha = 1/len) couplings.
        pos = np.zeros((V, 2), np.float32)
        pos[member_slots] = xy
        ed = pos[edges_sorted[:, 0]] - pos[edges_sorted[:, 1]]
        elen = np.sqrt((ed * ed).sum(axis=1))
        deg = p.solver.max_vertex_degree
        reach = p.solver.pallas_reach
        perm = None
        n_band_dropped = 0
        if self._pallas_layout:
            mem = np.zeros(V, bool)
            mem[member_slots] = True
            perm = smoother_kernel.rcm_order(edges_sorted, n_edges, V, mem)
            inv = np.empty(V, np.int32)
            inv[perm] = np.arange(V, dtype=np.int32)
            ranks = smoother_kernel.perm_edge_ranks(
                edges_sorted, n_edges, inv, p.edge_capacity, deg, reach,
                tie=elen)
            # Attribute the drops: the RCM band (raise pallas_reach) or
            # a vertex's slots (raise max_vertex_degree).
            n_rank_dropped = int((ranks[:n_edges, 0] == 255).sum())
            lo_p = inv[edges_sorted[:, 0]].astype(np.int64)
            hi_p = inv[edges_sorted[:, 1]].astype(np.int64)
            if n_rank_dropped:
                n_band_dropped = int((np.abs(
                    lo_p // smoother_kernel.LANES
                    - hi_p // smoother_kernel.LANES) > reach).sum())
            if self._smoother_mode == "halo":
                # The plain halo smoother also drops edges spanning more
                # ranks than its strip (clamped to a partition's block).
                width = halo.strip_width(V, self._sharding_mesh.size, reach)
                extra = int(((np.abs(lo_p - hi_p) > width)
                             & (ranks[:n_edges, 0] != 255)).sum())
                n_band_dropped += extra
                n_rank_dropped += extra
        else:
            ranks = topology.build_edge_ranks(edges_sorted, V,
                                              p.edge_capacity, tie=elen)
            n_rank_dropped = int(((ranks[:n_edges, 0] >= deg)
                                  | (ranks[:n_edges, 1] >= deg)).sum())
        n_deg_dropped = n_rank_dropped - n_band_dropped
        self.stats.set("tris_truncated", n_tris_dropped)
        self.stats.set("edges_truncated", n_edges_dropped)
        self.stats.set("edges_rank_dropped", n_rank_dropped)
        self.stats.set("edges_band_dropped", n_band_dropped)
        self.stats.set("edges_degree_dropped", n_deg_dropped)
        if (n_tris_dropped or n_edges_dropped or n_rank_dropped) \
                and not self._warned_capacity:
            self._warned_capacity = True
            print(f"flame_tpu_torch: capacity drops (tris={n_tris_dropped},"
                  f" edges={n_edges_dropped}, band={n_band_dropped}, "
                  f"degree={n_deg_dropped}); raise triangle/edge capacity, "
                  f"pallas_reach (band) or max_vertex_degree (degree)",
                  file=sys.stderr)
        return tris_slots, edges_sorted, ranks, perm

    def _run_post_delaunay(self, member, curr, topo: _Topo):
        """Topology, graph sync, smoothing and mesh outputs for the frame
        just tracked. The graph's vertex idepths project from the pose of
        the frame whose pixel coordinates it holds (the last one a sync
        ran for)."""
        p = self.params
        mesh = self._sharding_mesh
        prev = self._fprev if self._fprev is not None else self._fnew
        sync_pose = (self._last_sync_pose if self._last_sync_pose is not None
                     else (prev.q, prev.t))
        with step_graph.active(step_graph.steps_for(self._stack)):
            (graph, vtx_idepths, vtx_normals,
             self._tri_validity, self._idepthmap, self._graph_scale,
             self._coverage) = pipeline._post_delaunay_inner(
                p, self.K, self.Kinv,
                sharding.gather_rows(mesh, self._graph), member, curr,
                sync_pose, (self._fnew.q, self._fnew.t), self._graph_scale,
                self.width, self.height,
                self._idepthmap if p.init_with_prediction else None,
                mesh=mesh, timed=self.stats.timed, **topo.dev)
        self._graph, self._vtx_idepths, self._vtx_normals = (
            sharding.shard_rows(a, mesh)
            for a in (graph, vtx_idepths, vtx_normals))
        self._last_sync_pose = (self._fnew.q, self._fnew.t)
        self._set_applied(topo)
        if p.do_nltgv2:
            self.num_regularizer_updates += p.solver.n_iters_per_frame

    def _bootstrap_detect(self, pf_slot: int):
        if self._fprev is None:
            return
        mesh = self._sharding_mesh
        feats, curr = sharding.gather_rows(mesh, self._feats, self._curr)
        feats, _valid = pipeline.bootstrap_detect(
            self.params, self.K, self.Kinv, self._stack, feats,
            self._fprev.q, self._fprev.t, pf_slot, self._idepthmap,
            self._feat_id_counter, curr.xy, curr.valid)
        self._feats = sharding.shard_rows(feats, mesh)
        self._feat_id_counter += self._add_cap
        self._refresh_feat_mirror()

    # ------------------------------------------------------------------
    # Poseframes (reference flame.h:155-179, flame.cc:554-706).
    # ------------------------------------------------------------------

    def _new_poseframe(self, frame_id: int, q, t, q_np=None, t_np=None):
        slot = self._alloc_pf_slot(frame_id)
        self._pf_slot_by_id[frame_id] = slot
        self._curr_pf_slot = slot
        self._curr_pf_id = frame_id
        if self.params.auto_poseframe:
            self._curr_pf_pose_np = self._host_pose(q, t, q_np, t_np)

    def _want_poseframe(self, q_np: np.ndarray, t_np: np.ndarray) -> bool:
        """Automatic poseframe decision: the current poseframe has become a
        poor stereo reference for the new pose when the probe disparity at
        the image centre and depth auto_pf_depth reaches
        auto_pf_max_disparity, or the keyframe score hard-rejects it."""
        if self._curr_pf_slot is None or self._curr_pf_pose_np is None:
            return True
        p = self.params
        q_rel, t_rel = keyframe.KeyframeSelector._relative(
            *self._curr_pf_pose_np, q_np, t_np)
        disp = keyframe.test_disparity(
            self._K_np, self._Kinv_np, q_rel, t_rel,
            (self.width / 2.0, self.height / 2.0), p.auto_pf_depth)
        if disp >= p.auto_pf_max_disparity:
            return True
        s = keyframe.score(self.width, self.height, self._K_np,
                           self._Kinv_np, q_rel, t_rel)
        return s <= -np.finfo(np.float32).max / 2

    def _alloc_pf_slot(self, frame_id: int) -> int:
        if self._pf_free:
            return self._pf_free.pop()
        # Evict the oldest poseframe (an external estimator would prune;
        # the reference relies on prunePoseFrames). The validity mirror
        # refreshes with the next snapshot.
        live = sorted(self._pf_slot_by_id)
        self.stats.add("pf_evictions", 1)
        self.prune_poseframes(live[1:], defer_mirror=True)
        return self._pf_free.pop()

    def prune_poseframes(self, keep_ids, defer_mirror: bool = False):
        """Drop every poseframe not in keep_ids, re-anchoring its features
        on the newest survivor (reference flame.cc:554-706). The current
        poseframe must be kept (ValueError otherwise). defer_mirror skips
        the device->host refresh of the validity mirror."""
        self._flush_batch()
        keep = set(int(i) for i in keep_ids)
        if self._curr_pf_id is not None and self._curr_pf_id not in keep:
            raise ValueError(f"prune_poseframes: current poseframe "
                             f"{self._curr_pf_id} missing from keep_ids")
        kill = {fid: slot for fid, slot in self._pf_slot_by_id.items()
                if fid not in keep}
        if not kill:
            return
        surv = [fid for fid in self._pf_slot_by_id if fid in keep]
        if not surv:
            self.clear()
            self._free_slots(kill)
            self._curr_pf_slot = None
            self._curr_pf_id = None
            return
        # The newest survivor (reference crbegin = highest id,
        # flame.cc:607).
        target = self._pf_slot_by_id[max(surv)]
        kill_mask = np.zeros(self.params.poseframe_capacity, bool)
        kill_mask[list(kill.values())] = True
        b = self.params.border
        self._feats = pipeline.reanchor_features(
            self._feats, self.K, self.Kinv, self._stack,
            torch.as_tensor(kill_mask, device=self.device), target, float(b),
            float(self.width - b), float(self.height - b))
        if self._ba is not None:
            self._ba.store.drop_frames(kill.keys())
        self._free_slots(kill)
        if not defer_mirror:
            self._refresh_feat_mirror()

    def _free_slots(self, kill: Dict[int, int]):
        for fid, slot in kill.items():
            frame_mod.remove(self._stack, slot)
            self._pf_slot_by_id.pop(fid, None)
            self._pf_free.append(int(slot))

    def update_poseframe_poses(self, poses: Dict[int, Tuple]):
        """External pose updates {frame_id: (q, t)} (reference
        updatePoseFramePoses, flame.h:155-164)."""
        self._flush_batch()
        for fid, (q, t) in poses.items():
            slot = self._pf_slot_by_id.get(fid)
            if slot is not None:
                frame_mod.set_pose(self._stack, slot,
                                   self._as_pose_tensor(q),
                                   self._as_pose_tensor(t))

    def _refresh_feat_mirror(self):
        self._feat_valid_np = sharding.gather_rows(
            self._sharding_mesh, self._feats.valid).cpu().numpy().copy()
        self._n_valid = int(self._feat_valid_np.sum())

    # ------------------------------------------------------------------
    # Outputs (reference flame.h:207-280). Getters that need every update
    # reflected run the buffered batch frames first.
    # ------------------------------------------------------------------

    def coverage(self) -> float:
        """Fraction of pixels covered by the dense map."""
        return float(self._coverage) if self._coverage is not None else 0.0

    def get_inverse_depth_map(self) -> np.ndarray:
        """The dense map, read in the span "map_read" (tagged with the
        newest frame handed to update())."""
        frames = () if self._newest_frame is None else (self._newest_frame,)
        with self.stats.span("map_read", frames=frames):
            self._flush_batch()
            return self._idepthmap.cpu().numpy()

    def get_filtered_inverse_depth_map(self) -> np.ndarray:
        """The dense map over the triangles that pass the triangle filters
        only (reference flame.h:217-228); K2 on the card."""
        self._flush_batch()
        pos, vtx_idepths = sharding.gather_rows(
            self._sharding_mesh, self._graph.pos, self._vtx_idepths)
        tri_ok = (torch.arange(self._tris.shape[0], device=self.device)
                  < self._n_tris) & self._tri_validity
        return rasterize.rasterize_auto(
            pos, self._tris, vtx_idepths, tri_ok,
            self.height, self.width).cpu().numpy()

    def get_inverse_depth_mesh(self):
        """Compacted mesh: vertices, idepths, w1, w2, normals, triangles,
        tri_validity, edges (indices into the compacted vertex list)."""
        self._flush_batch()
        g, vtx_idepths, vtx_normals = sharding.gather_rows(
            self._sharding_mesh, self._graph, self._vtx_idepths,
            self._vtx_normals)
        member = g.vtx_mask.cpu().numpy()
        slots = np.nonzero(member)[0]
        remap = np.full(member.shape[0], -1, np.int64)
        remap[slots] = np.arange(slots.shape[0])
        tris = remap[self._tris[:self._n_tris].cpu().numpy()]
        edges = remap[self._edges_np[:self._n_edges]]
        validity = self._tri_validity[:self._n_tris].cpu().numpy()
        tri_ok = np.all(tris >= 0, axis=1)
        edge_ok = np.all(edges >= 0, axis=1)
        return {
            "vertices": g.pos.cpu().numpy()[slots],
            "idepths": vtx_idepths.cpu().numpy()[slots],
            "w1": g.w1.cpu().numpy()[slots],
            "w2": g.w2.cpu().numpy()[slots],
            "normals": vtx_normals.cpu().numpy()[slots],
            "triangles": tris[tri_ok],
            "tri_validity": validity[tri_ok],
            "edges": edges[edge_ok],
        }

    def get_raw_idepths(self):
        """Valid current-frame features: (xy (M, 2), idepth (M,), var)."""
        self._flush_batch()
        curr = sharding.gather_rows(self._sharding_mesh, self._curr)
        v = curr.valid.cpu().numpy()
        return (curr.xy.cpu().numpy()[v],
                curr.idepth.cpu().numpy()[v],
                curr.var.cpu().numpy()[v])

    def failure_stats(self) -> Dict[str, int]:
        """Failure counters of the last step: one frame on the single
        path, frame_batch frames summed under batching (frames_counted
        says which); the capacity drops of the last triangulation (0 when
        nothing was truncated); and the largest per-tile union-candidate
        count of the last 256 batched rasters (above
        raster_kernel.MAX_PER_TILE_BATCH a per-frame map lost triangles;
        the JAX package has no such key)."""
        self._flush_batch()
        self._copy_graph_counts()  # quiesce() may have staged a solve
        s = self._last_stats_dev.cpu().numpy()
        self.stats.set("num_idepth_updates", int(s[pipeline.STAT_UPDATES]))
        return {
            "frames_counted": int(self._last_dispatch_frames),
            "updates": int(s[pipeline.STAT_UPDATES]),
            "fail_max_var": int(s[pipeline.STAT_FAIL_MAX_VAR]),
            "fail_max_dropouts": int(s[pipeline.STAT_FAIL_MAX_DROPOUTS]),
            "fail_ref_patch_grad": int(s[pipeline.STAT_FAIL_REF_PATCH]),
            "fail_ambiguous_match": int(s[pipeline.STAT_FAIL_AMBIGUOUS]),
            "fail_max_cost": int(s[pipeline.STAT_FAIL_MAX_COST]),
            # Rank drops split by cause under the banded smoothers: the
            # RCM band (raise solver.pallas_reach) or a vertex's slots
            # (raise solver.max_vertex_degree).
            **{k: int(self.stats.stats(k)) for k in (
                "tris_truncated", "edges_truncated", "edges_rank_dropped",
                "edges_band_dropped", "edges_degree_dropped",
                "members_deduped")},
            "raster_max_union_candidates": max(
                (int(c) for c in self._raster_union), default=0),
            # With do_ba, BA's counters (ba/window.py).
            **({k: int(self.stats.stats(k)) for k in ba_window.COUNTERS}
               if self._ba is not None else {}),
        }

    # ------------------------------------------------------------------
    # Debug images (reference flame.h:286-309), rendered on demand.
    # ------------------------------------------------------------------

    def _gray(self) -> np.ndarray:
        if self._fnew is None:
            return np.zeros((self.height, self.width), np.uint8)
        return np.clip(self._fnew.img.cpu().numpy(), 0, 255).astype(np.uint8)

    def get_debug_image_wireframe(self) -> np.ndarray:
        mesh = self.get_inverse_depth_mesh()
        return visualization.draw_wireframe(
            self._gray(), mesh["vertices"], mesh["idepths"],
            mesh["triangles"], mesh["tri_validity"],
            scale=self.params.scene_color_scale)

    def get_debug_image_features(self) -> np.ndarray:
        verts, mu, _ = self.get_raw_idepths()
        return visualization.draw_features(
            self._gray(), verts, mu, scale=self.params.scene_color_scale)

    def get_debug_image_idepthmap(self) -> np.ndarray:
        return visualization.draw_idepthmap(
            self._gray(), self.get_inverse_depth_map(),
            scale=self.params.scene_color_scale)

    def get_debug_image_normals(self) -> np.ndarray:
        mesh = self.get_inverse_depth_mesh()
        return visualization.draw_normals(
            self._gray(), mesh["vertices"], mesh["normals"],
            mesh["triangles"], mesh["tri_validity"])

    def get_debug_image_detections(self) -> np.ndarray:
        """The detection score map and its cell winners (reference
        drawDetections, flame.cc:2363-2403), detection run afresh on the
        current poseframe against the newest frame that is not the
        poseframe itself (after a non-poseframe update the previous frame
        is the poseframe, and a zero baseline would blank the map)."""
        if self._fprev is None or self._curr_pf_slot is None:
            return visualization.to_rgb(self._gray())
        p = self.params
        slot = self._curr_pf_slot
        new_is_pf = self._pf_slot_by_id.get(int(self._fnew.frame_id)) == slot
        cmp = self._fprev if new_is_pf else self._fnew
        geo = epipolar.load_relative(
            self.K, self.Kinv, (self._stack.q[slot], self._stack.t[slot]),
            (cmp.q, cmp.t))
        res = detection.detect(geo, self._stack.gradx[slot],
                               self._stack.grady[slot],
                               p.detection.min_grad_mag,
                               p.detection.win_size, p.border)
        winners = res.best_xy[res.best_score > 0].cpu().numpy()
        return visualization.draw_detections(
            self._gray(), res.score_map.cpu().numpy(), winners)

    def get_debug_image_matches(self) -> np.ndarray:
        """Valid features coloured by their last search outcome, in the
        reference's drawMatches palette (flame.cc:1699-1746, BGR there):
        reference-patch gradient failure cyan (white while the feature has
        no updates), ambiguous match red, max cost yellow; success blends
        blue -> green over 0..30 updates."""
        img = visualization.to_rgb(self._gray())
        curr, feats = sharding.gather_rows(self._sharding_mesh, self._curr,
                                           self._feats)
        xy = curr.xy.cpu().numpy()
        valid = curr.valid.cpu().numpy()
        status = feats.search_status.cpu().numpy()
        nupd = feats.num_updates.cpu().numpy()
        Hh, Ww = img.shape[:2]
        for s in np.nonzero(valid)[0]:
            x, y = int(round(xy[s, 0])), int(round(xy[s, 1]))
            st = int(status[s])
            if st == 1:  # FAIL_REF_PATCH_GRADIENT
                c = (255, 255, 255) if nupd[s] == 0 else (0, 255, 255)
            elif st == 2:  # FAIL_AMBIGUOUS_MATCH
                c = (255, 0, 0)
            elif st == 3:  # FAIL_MAX_COST
                c = (255, 255, 0)
            else:  # SUCCESS: blue -> green by update count
                a = min(max(nupd[s] / 30.0, 0.0), 1.0)
                c = (0, int(255 * a), int(255 * (1 - a)))
            img[max(0, y - 2):min(Hh, y + 3),
                max(0, x - 2):min(Ww, x + 3)] = c
        return img
