"""Flame: the whole-pipeline orchestrator, synchronous path.

Port of flame_tpu/core/flame.py for the default configuration
(frame_batch=1, async_topology=False, do_ba=False): update() takes its
synchronous branch. Per frame:

  1. frame creation (+ poseframe insertion);
  2. one tracking step over all feature slots, with detection and
     on-device insertion on poseframes;
  3. one device->host copy of the packed (N, 3) snapshot;
  4. host Delaunay over the 1/32-px quantized member positions, edges and
     slot ranks;
  5. topology with dual carry-over, graph sync, n_iters_per_frame
     smoother iterations (CUDA kernel on the GPU), mesh filters and the
     dense map (CUDA tile kernel on the GPU).

Not ported yet, and rejected at construction: async topology, frame
batching, bundle adjustment, automatic poseframes and comparison-
poseframe scoring (photo_error_num_pfs > 0). When every poseframe slot is
taken, update() raises instead of evicting (prune_poseframes and
reanchor_features are not ported).
"""

from typing import Dict, Optional

import numpy as np
import torch

from flame_tpu_torch.core import frame as frame_mod
from flame_tpu_torch.core import pipeline
from flame_tpu_torch.mesh import delaunay
from flame_tpu_torch.optimize import nltgv2, topology
from flame_tpu_torch.params import Params
from flame_tpu_torch.utils.stats import StatsTracker


class Flame:
    """Dense inverse-depth mesh estimation (reference flame.h:96)."""

    def __init__(self, width: int, height: int, K, Kinv,
                 params: Optional[Params] = None, *, device):
        p = params or Params()
        self.params = p
        self.width = width
        self.height = height
        self.device = torch.device(device)
        unsupported = [name for name, on in (
            ("solver.async_topology", p.solver.async_topology),
            ("solver.frame_batch != 1", p.solver.frame_batch != 1),
            ("do_ba", p.do_ba), ("auto_poseframe", p.auto_poseframe),
            ("photo_error_num_pfs > 0", p.photo_error_num_pfs > 0)) if on]
        if unsupported:
            raise NotImplementedError(
                "flame_tpu_torch ports the synchronous path only; not "
                f"ported: {', '.join(unsupported)}")
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
        self.stats = StatsTracker(device=self.device)
        self.inited = False
        self.num_imgs = 0
        self.num_data_updates = 0
        self.num_regularizer_updates = 0
        self._stack = frame_mod.empty_stack(p.poseframe_capacity, height,
                                            width, p.pad, self.device)
        self._pf_free = list(range(p.poseframe_capacity))
        self._curr_pf_slot: Optional[int] = None
        self._fnew = None
        self._fprev = None
        self._feat_id_counter = 0
        self._last_stats_dev = torch.zeros(pipeline.N_STATS,
                                           dtype=torch.int32)
        self._cy = -(-height // p.detection.win_size)
        self._cx = -(-width // p.detection.win_size)
        self._add_cap = self._cy * self._cx
        self._warned_capacity = False
        self.clear()

    def clear(self):
        """Reset features, graph and mesh; poseframes survive
        (reference flame.h:179-202)."""
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
        self._staged = None  # last host topology, as device tensors
        self._last_sync_pose = None
        self._edges_np = np.zeros((0, 2), np.int64)
        self._n_edges = 0
        self._n_tris = 0
        self._n_members = 0
        self._feat_valid_np = np.zeros(N, bool)
        self._n_valid = 0

    # ------------------------------------------------------------------
    # Main entry point (reference flame.cc:127-552).
    # ------------------------------------------------------------------

    def update(self, time: float, frame_id: int, pose, img,
               is_poseframe: Optional[bool] = None) -> bool:
        """Process one posed image; pose = (q wxyz, t) camera-to-world.
        Returns False while bootstrapping or when the frame cannot
        produce a mesh."""
        p, dev = self.params, self.device
        self.stats.tick("update")
        q = torch.as_tensor(np.asarray(pose[0], np.float32), device=dev)
        t = torch.as_tensor(np.asarray(pose[1], np.float32), device=dev)
        img = torch.as_tensor(np.asarray(img), device=dev)
        is_poseframe = bool(is_poseframe)

        fast = (self.inited and self._curr_pf_slot is not None
                and self._fnew is not None and self._n_valid > 0)
        if is_poseframe:
            self._curr_pf_slot = self._alloc_pf_slot()
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
                self._bootstrap_detect(self._curr_pf_slot)
            if self._n_valid == 0:
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
                self._feat_id_counter, self._idepthmap)
        if do_detect:
            self._feat_id_counter += self._add_cap
        self._curr = curr
        self._last_stats_dev = stat_vec

        with self.stats.timed("triangulate"):
            ok = self._consume_packed(pipeline.as_numpy_packed(packed))
        if not ok or self._staged is None:
            return self._done(False)

        with self.stats.timed("sync_graph"):
            self._run_post_delaunay(member, curr)

        if is_poseframe:
            frame_mod.set_idepthmap(self._stack, self._curr_pf_slot,
                                    self._idepthmap)
        self.stats.set("num_feats", self._n_valid)
        self.stats.set("num_vtx", self._n_members)
        self.stats.set("num_tris", self._n_tris)
        self.stats.set("num_edges", self._n_edges)
        self.inited = True
        self.num_data_updates += 1
        return self._done(True)

    def _done(self, result: bool) -> bool:
        ms = self.stats.tock("update")
        if result and ms > 0:
            self.stats.ema("fps_max", 1000.0 / ms)
        return result

    def _alloc_pf_slot(self) -> int:
        if not self._pf_free:
            raise NotImplementedError(
                "all poseframe slots are taken; poseframe eviction "
                "(prune_poseframes / reanchor_features) is not ported: "
                "raise poseframe_capacity")
        return self._pf_free.pop()

    def _bootstrap_detect(self, pf_slot: int):
        if self._fprev is None:
            return
        self._feats, valid = pipeline.bootstrap_detect(
            self.params, self.K, self.Kinv, self._stack, self._feats,
            self._fprev.q, self._fprev.t, pf_slot, self._idepthmap,
            self._feat_id_counter, self._curr.xy, self._curr.valid)
        self._feat_id_counter += self._add_cap
        self._feat_valid_np = valid.cpu().numpy()
        self._n_valid = int(self._feat_valid_np.sum())

    def _consume_packed(self, packed: np.ndarray) -> bool:
        """Update the host mirrors from the packed snapshot and
        triangulate its members. False when too few features survive
        (the state is cleared, reference flame.cc:281-290)."""
        p = self.params
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
        tri = self._host_triangulate(packed)
        if tri is not None:
            self._stage_topology(*tri)
        return True

    def _host_triangulate(self, pk: np.ndarray):
        """Delaunay over the members of the packed snapshot, plus the
        sorted unique edges and their slot ranks (core/flame.py:1001-1175
        of the JAX package). None when fewer than 3 distinct members or
        the member set is degenerate."""
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
        ranks = topology.build_edge_ranks(edges_sorted, V, p.edge_capacity,
                                          tie=elen)
        deg = p.solver.max_vertex_degree
        n_rank_dropped = int(((ranks[:n_edges, 0] >= deg)
                              | (ranks[:n_edges, 1] >= deg)).sum())
        self.stats.set("tris_truncated", n_tris_dropped)
        self.stats.set("edges_truncated", n_edges_dropped)
        self.stats.set("edges_degree_dropped", n_rank_dropped)
        if (n_tris_dropped or n_edges_dropped or n_rank_dropped) \
                and not self._warned_capacity:
            self._warned_capacity = True
            import sys
            print(f"flame_tpu_torch: capacity drops (tris={n_tris_dropped},"
                  f" edges={n_edges_dropped}, degree={n_rank_dropped}); "
                  f"raise triangle/edge capacity or max_vertex_degree",
                  file=sys.stderr)
        return tris_slots, edges_sorted, ranks

    def _stage_topology(self, tris_slots, edges_sorted, ranks):
        p, dev = self.params, self.device
        tris = np.zeros((p.triangle_capacity, 3), np.int64)
        tris[:tris_slots.shape[0]] = tris_slots
        edges = np.zeros((p.edge_capacity, 2), np.int64)
        edges[:edges_sorted.shape[0]] = edges_sorted
        self._staged = dict(
            tris=torch.as_tensor(tris, device=dev),
            n_tris=int(tris_slots.shape[0]),
            edges=torch.as_tensor(edges, device=dev),
            n_edges=int(edges_sorted.shape[0]),
            edge_ranks=torch.as_tensor(ranks, device=dev))
        self._edges_np = edges_sorted

    def _run_post_delaunay(self, member, curr):
        p = self.params
        st = self._staged
        prev = self._fprev if self._fprev is not None else self._fnew
        sync_pose = (self._last_sync_pose if self._last_sync_pose is not None
                     else (prev.q, prev.t))
        (self._graph, self._vtx_idepths, self._vtx_normals,
         self._tri_validity, self._idepthmap, self._graph_scale,
         self._coverage) = pipeline._post_delaunay_inner(
            p, self.K, self.Kinv, self._graph, member, curr, sync_pose,
            (self._fnew.q, self._fnew.t), self._graph_scale, self.width,
            self.height, self._idepthmap if p.init_with_prediction else None,
            timed=self.stats.timed, **st)
        self._last_sync_pose = (self._fnew.q, self._fnew.t)
        self._tris = st["tris"]
        self._n_tris = st["n_tris"]
        self._n_edges = st["n_edges"]
        if p.do_nltgv2:
            self.num_regularizer_updates += p.solver.n_iters_per_frame

    # ------------------------------------------------------------------
    # Outputs (reference flame.h:207-280).
    # ------------------------------------------------------------------

    def coverage(self) -> float:
        """Fraction of pixels covered by the dense map."""
        return float(self._coverage) if self._coverage is not None else 0.0

    def get_inverse_depth_map(self) -> np.ndarray:
        return self._idepthmap.cpu().numpy()

    def get_inverse_depth_mesh(self):
        """Compacted mesh: vertices, idepths, w1, w2, normals, triangles,
        tri_validity, edges (indices into the compacted vertex list)."""
        member = self._graph.vtx_mask.cpu().numpy()
        slots = np.nonzero(member)[0]
        remap = np.full(member.shape[0], -1, np.int64)
        remap[slots] = np.arange(slots.shape[0])
        tris = remap[self._tris[:self._n_tris].cpu().numpy()]
        edges = remap[self._edges_np[:self._n_edges]]
        validity = self._tri_validity[:self._n_tris].cpu().numpy()
        tri_ok = np.all(tris >= 0, axis=1)
        edge_ok = np.all(edges >= 0, axis=1)
        g = self._graph
        return {
            "vertices": g.pos.cpu().numpy()[slots],
            "idepths": self._vtx_idepths.cpu().numpy()[slots],
            "w1": g.w1.cpu().numpy()[slots],
            "w2": g.w2.cpu().numpy()[slots],
            "normals": self._vtx_normals.cpu().numpy()[slots],
            "triangles": tris[tri_ok],
            "tri_validity": validity[tri_ok],
            "edges": edges[edge_ok],
        }

    def get_raw_idepths(self):
        """Valid current-frame features: (xy (M, 2), idepth (M,), var)."""
        v = self._curr.valid.cpu().numpy()
        return (self._curr.xy.cpu().numpy()[v],
                self._curr.idepth.cpu().numpy()[v],
                self._curr.var.cpu().numpy()[v])

    def failure_stats(self) -> Dict[str, int]:
        """Failure counters of the last tracking step."""
        s = self._last_stats_dev.cpu().numpy()
        return {
            "updates": int(s[pipeline.STAT_UPDATES]),
            "fail_max_var": int(s[pipeline.STAT_FAIL_MAX_VAR]),
            "fail_max_dropouts": int(s[pipeline.STAT_FAIL_MAX_DROPOUTS]),
            "fail_ref_patch_grad": int(s[pipeline.STAT_FAIL_REF_PATCH]),
            "fail_ambiguous_match": int(s[pipeline.STAT_FAIL_AMBIGUOUS]),
            "fail_max_cost": int(s[pipeline.STAT_FAIL_MAX_COST]),
        }
