"""Windowed BA bookkeeping and Flame integration.

Port of flame_tpu/ba/window.py.

Tracking's per-poseframe matches ride the packed transfer
(pipeline.pack_ba_outputs) to the host, where split_packed decodes them
and an ObservationStore keeps them, keyed by globally unique feature ids
and frame ids (feature slots are recycled). A solve packs its window
problem into one int32 upload; on the device it is decoded, optionally
re-matched in 2-D and weighted, and solved by Schur Gauss-Newton into one
flat float32 result, which comes back through Flame's _AsyncFetch (a
non-blocking copy and an event). On the card the solve replays a CUDA
graph per window size (flame_tpu_torch/step_graph.py, kind "ba"), the
counterpart of the JAX package's one jitted dispatch: launched op by op
it is ~3,500 small launches.
Poses and refined idepths apply one or more steps later: one pose
scatter, and one idepth scatter guarded by identity (the slot must still
hold the same feat_id mod 2^24 and the same anchor poseframe slot),
which makes the lag safe against slot recycling and re-anchoring.

In Flame.stats a staged solve is the host span "ba_stage" (the window's
build, the pack, the upload and the solve's launch), which holds the
timed block "ba_solve" (the graph's replay, or the eager solve off the
card: its CUDA events give the solve's device time); an apply is the
host span "ba_apply"; COUNTERS are counted beside them (the graph
runner's ba_graph_captures among them).

Under a mesh (ShardedFlame) every solve is decoded, re-matched and
weighted the same way, solved with the observation-sharded assembly
(parallel/distributed_ba.py) while the stack's runner is current (kind
"ba_sharded") and applied at once, as in the JAX package
(flame_tpu/ba/window.py:560-597).
"""

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from flame_tpu_torch import step_graph
from flame_tpu_torch.ba import rematch
from flame_tpu_torch.ba import residuals as resid
from flame_tpu_torch.ba import schur
from flame_tpu_torch.core import frame as frame_mod
from flame_tpu_torch.core import pipeline
from flame_tpu_torch.parallel import sharding
from flame_tpu_torch.params import BAParams
from flame_tpu_torch.utils import evaluation

# The counters BA keeps in Flame.stats, which Flame.failure_stats() lists
# when do_ba is on.
COUNTERS = ("ba_single_solves", "ba_sharded_solves", "ba_graph_captures",
            "ba_solves_applied", "ba_solves_rejected", "ba_writeback_skips",
            "ba_obs_dropped_pfs")


def split_packed(params, arr: np.ndarray):
    """Host-side decode of the widened packed transfer
    (pipeline.pack_ba_outputs layout). Returns (packed_u16 (N, 3),
    snap dict or None). A plain u16 array (BA off) passes through."""
    arr = np.asarray(arr)
    if arr.dtype == np.uint16:
        return arr, None
    N = params.feature_capacity
    P = params.poseframe_capacity
    fixed = 3 * N // 2 + 3 * N + 8 * P
    B = (arr.size - fixed) // N
    off = 0

    def take(n):
        nonlocal off
        s = arr[off: off + n]
        off += n
        return s

    pk = take(3 * N // 2).view(np.uint16).reshape(N, 3)
    uo = take(B * N).view(np.uint16).reshape(B, N, 2)
    xy = take(N).view(np.uint16).reshape(N, 2)
    mu = take(N).view(np.float32)
    id_slot = take(N)
    stack_fid = take(P)
    stack_q = take(4 * P).view(np.float32).reshape(P, 4)
    stack_t = take(3 * P).view(np.float32).reshape(P, 3)
    snap = dict(uo=uo, xy=xy, mu=mu,
                feat_id=id_slot & 0xFFFFFF,
                pf_slot=(id_slot >> 24) & 0x7F,
                stack_fid=stack_fid, stack_q=stack_q, stack_t=stack_t)
    return pk, snap


class ObservationStore:
    """Bounded columnar ring buffer of observations
    (anchor_id, obs_frame_id, feat_id, u_ref, u_obs), vectorized numpy."""

    def __init__(self, capacity: int):
        self.capacity = capacity
        self._aid = np.zeros(capacity, np.int64)
        self._oid = np.zeros(capacity, np.int64)
        self._fid = np.zeros(capacity, np.int64)
        self._uref = np.zeros((capacity, 2), np.float32)
        self._uobs = np.zeros((capacity, 2), np.float32)
        self._n = 0  # live rows
        self._head = 0  # ring write pointer (next slot)

    def add_frame(self, anchor_ids, obs_frame_id: int, feat_ids,
                  u_ref, u_obs) -> None:
        m = len(feat_ids)
        if m == 0:
            return
        if m > self.capacity:  # keep the newest rows of an oversized batch
            anchor_ids = anchor_ids[-self.capacity:]
            feat_ids = feat_ids[-self.capacity:]
            u_ref = u_ref[-self.capacity:]
            u_obs = u_obs[-self.capacity:]
            m = self.capacity
        idx = (self._head + np.arange(m)) % self.capacity
        self._aid[idx] = np.asarray(anchor_ids, np.int64)
        self._oid[idx] = int(obs_frame_id)
        self._fid[idx] = np.asarray(feat_ids, np.int64)
        self._uref[idx] = np.asarray(u_ref, np.float32)
        self._uobs[idx] = np.asarray(u_obs, np.float32)
        self._head = int((self._head + m) % self.capacity)
        self._n = min(self._n + m, self.capacity)

    def _ordered(self):
        """Logical-order (oldest-first) views of the live rows."""
        idx = (self._head - self._n + np.arange(self._n)) % self.capacity
        return (self._aid[idx], self._oid[idx], self._fid[idx],
                self._uref[idx], self._uobs[idx])

    def drop_frames(self, dead_ids) -> None:
        dead = np.fromiter((int(i) for i in dead_ids), np.int64)
        if dead.size == 0 or self._n == 0:
            return
        aid, oid, fid, ur, uo = self._ordered()
        keep = ~(np.isin(aid, dead) | np.isin(oid, dead))
        m = int(keep.sum())
        self._aid[:m] = aid[keep]
        self._oid[:m] = oid[keep]
        self._fid[:m] = fid[keep]
        self._uref[:m] = ur[keep]
        self._uobs[:m] = uo[keep]
        self._n = m
        self._head = m % self.capacity

    def __len__(self):
        return self._n

    def build_window(self, frame_ids: List[int],
                     pose_by_id: Dict[int, Tuple[np.ndarray, np.ndarray]],
                     lm_init: Dict[Tuple[int, int], float],
                     max_landmarks: int, max_obs: int,
                     prior_by_id: Dict[int, Tuple[np.ndarray,
                                                  np.ndarray]] = None):
        """Assemble a numpy BAProblem over the given keyframe window.

        lm_init maps landmark key (feat_id, anchor_id) -> current inverse
        depth; rows whose key is absent are skipped (the feature died or
        re-anchored). Landmarks index in first-appearance (oldest-first)
        order; rows beyond max_obs and landmarks beyond max_landmarks are
        dropped. prior_by_id: optional fid -> (q, t) pose-prior anchors
        (missing fids fall back to pose_by_id; None leaves the prior
        fields unset). Returns (problem, pose_order, landmark_keys, n_obs)
        or None when the window is too small.
        """
        aid, oid, fid, ur_all, uo_all = self._ordered()
        if aid.size == 0 or not lm_init:
            return None

        fids_arr = np.asarray(frame_ids, np.int64)
        sort = np.argsort(fids_arr)
        sf = fids_arr[sort]

        def to_window_idx(ids):
            p = np.clip(np.searchsorted(sf, ids), 0, sf.size - 1)
            return sort[p].astype(np.int32), sf[p] == ids

        a_idx, a_ok = to_window_idx(aid)
        o_idx, o_ok = to_window_idx(oid)
        keep = a_ok & o_ok & (aid != oid)

        # Landmark key = (feat_id, anchor_id) packed into one int64.
        key = (fid << 32) | (aid & 0xFFFFFFFF)
        lk = np.fromiter(((int(f) << 32) | (int(a) & 0xFFFFFFFF)
                          for (f, a) in lm_init.keys()),
                         np.int64, count=len(lm_init))
        lv = np.fromiter(lm_init.values(), np.float64, count=len(lm_init))
        lko = np.argsort(lk)
        lks = lk[lko]
        p = np.clip(np.searchsorted(lks, key), 0, lks.size - 1)
        keep &= lks[p] == key

        kk = key[keep]
        if kk.size < 12:
            return None
        uniq, first_idx, inv = np.unique(kk, return_index=True,
                                         return_inverse=True)
        # Landmark index = rank by first appearance (oldest-first).
        appear = np.argsort(first_idx)
        rank = np.empty(uniq.size, np.int64)
        rank[appear] = np.arange(uniq.size)
        lm_rows = rank[inv]

        sel = lm_rows < max_landmarks
        a = a_idx[keep][sel][:max_obs]
        o = o_idx[keep][sel][:max_obs]
        lidx = lm_rows[sel].astype(np.int32)[:max_obs]
        ur = ur_all[keep][sel][:max_obs].astype(np.float32)
        uo = uo_all[keep][sel][:max_obs].astype(np.float32)
        L = min(uniq.size, max_landmarks)
        # Landmarks that lost all their rows to the obs cap keep their
        # slot (zero rows: inert in the solve).
        if a.shape[0] < 12 or L < 4:
            return None
        uniq_in_order = uniq[appear[:L]]
        lm_idepth = lv[lko][np.searchsorted(lks, uniq_in_order)] \
            .astype(np.float32)

        # Padded to fixed shapes (max_obs rows, max_landmarks landmarks).
        M = a.shape[0]
        pad = max_obs - M
        obs = resid.BAObservations(
            anchor_idx=np.pad(a, (0, pad)), obs_idx=np.pad(o, (0, pad)),
            lm_idx=np.pad(lidx, (0, pad)),
            u_ref=np.pad(ur, ((0, pad), (0, 0))),
            u_obs=np.pad(uo, ((0, pad), (0, 0))),
            valid=np.arange(max_obs) < M)
        lm_pad = np.zeros(max_landmarks, np.float32)
        lm_pad[:L] = lm_idepth

        def stack(by_id, i):
            return np.stack([by_id.get(f, pose_by_id[f])[i]
                             for f in frame_ids]).astype(np.float32)
        pq = pt = None
        if prior_by_id:
            pq, pt = stack(prior_by_id, 0), stack(prior_by_id, 1)
        problem = schur.BAProblem(
            q=stack(pose_by_id, 0), t=stack(pose_by_id, 1),
            lm_idepth=lm_pad, lm_valid=np.arange(max_landmarks) < L,
            obs=obs, prior_q=pq, prior_t=pt)
        keys = list(zip((uniq_in_order >> 32).tolist(),
                        (uniq_in_order & 0xFFFFFFFF).tolist()))
        return problem, list(frame_ids), keys, M


def _pack_problem(problem: schur.BAProblem, slot_w: np.ndarray) -> np.ndarray:
    """The whole window problem as one int32 upload buffer:
    [q 4P | t 3P | prior_q 4P | prior_t 3P | lm L | lm_valid L |
    a_idx M | o_idx M | l_idx M | u_ref 2M | u_obs 2M | valid M |
    slot_w P] (float32 sections bitcast)."""
    obs = problem.obs
    pq = problem.prior_q if problem.prior_q is not None else problem.q
    pt = problem.prior_t if problem.prior_t is not None else problem.t

    def f32(a):
        return np.ascontiguousarray(a, np.float32).view(np.int32).ravel()
    return np.concatenate([
        f32(problem.q), f32(problem.t), f32(pq), f32(pt),
        f32(problem.lm_idepth), np.asarray(problem.lm_valid, np.int32),
        np.asarray(obs.anchor_idx, np.int32),
        np.asarray(obs.obs_idx, np.int32), np.asarray(obs.lm_idx, np.int32),
        f32(obs.u_ref), f32(obs.u_obs), np.asarray(obs.valid, np.int32),
        np.asarray(slot_w, np.int32)])


def well_posed_window(P: int, L: int, M: int, K: np.ndarray, seed: int,
                      u_range: Tuple[float, float],
                      n_invalid: int = 0) -> np.ndarray:
    """A synthetic well-posed window in the _pack_problem layout, for
    checking a solve: cameras 10 cm apart along x with identity rotations,
    landmarks 2-5 m deep at anchor pixels (x and y) in u_range,
    observations projected with 0.3 px noise (the last n_invalid rows
    invalid), the poses starting 5 mm off their priors."""
    r = np.random.default_rng(seed)
    t = np.stack([0.1 * np.arange(P), np.zeros(P), np.zeros(P)], 1)
    a, o = r.integers(0, P, M), r.integers(0, P, M)
    o = np.where(o == a, (a + 1) % P, o)
    lm = np.arange(M) % L
    u_ref = r.uniform(*u_range, (L, 2))
    idepth = r.uniform(0.2, 0.5, L)
    ray = np.stack([(u_ref[:, 0] - K[0, 2]) / K[0, 0],
                    (u_ref[:, 1] - K[1, 2]) / K[1, 1], np.ones(L)], 1)
    p_o = ray[lm] / idepth[lm, None] + t[a] - t[o]
    u_obs = K[0, 0] * p_o[:, :2] / p_o[:, 2:] + K[:2, 2] \
        + r.normal(0, 0.3, (M, 2))
    obs = resid.BAObservations(anchor_idx=a, obs_idx=o, lm_idx=lm,
                               u_ref=u_ref[lm], u_obs=u_obs,
                               valid=np.arange(M) < M - n_invalid)
    ident = np.tile([1.0, 0, 0, 0], (P, 1))
    problem = schur.BAProblem(q=ident, t=t + r.normal(0, 0.005, (P, 3)),
                              lm_idepth=idepth * r.uniform(0.95, 1.05, L),
                              lm_valid=np.ones(L, bool), obs=obs,
                              prior_q=ident, prior_t=t)
    return _pack_problem(problem, np.arange(P, dtype=np.int32))


def _decode_packed(buf: torch.Tensor, P: int, L: int, M: int):
    """The problem upload (_pack_problem layout) as (BAProblem, slot_w)
    on buf's device."""
    sizes = (4 * P, 3 * P, 4 * P, 3 * P, L, L, M, M, M, 2 * M, 2 * M, M, P)
    (q, t, prior_q, prior_t, lm, lm_valid, a_idx, o_idx, l_idx, u_ref,
     u_obs, valid, slot_w) = torch.split(buf, sizes)

    def f32(a, *shape):
        return a.view(torch.float32).reshape(*shape)
    problem = schur.BAProblem(
        q=f32(q, P, 4), t=f32(t, P, 3), lm_idepth=f32(lm, L),
        lm_valid=lm_valid > 0,
        obs=resid.BAObservations(anchor_idx=a_idx.long(),
                                 obs_idx=o_idx.long(), lm_idx=l_idx.long(),
                                 u_ref=f32(u_ref, M, 2),
                                 u_obs=f32(u_obs, M, 2), valid=valid > 0),
        prior_q=f32(prior_q, P, 4), prior_t=f32(prior_t, P, 3))
    return problem, slot_w.long()


def _rematch_and_weigh(p: BAParams, K, Kinv, problem: schur.BAProblem,
                       slot_w: torch.Tensor, img_pad, pad: int):
    """Optionally re-match the observations in 2-D and weight them by the
    anchor's structure tensor: returns (problem, sqrtW or None)."""
    obs = problem.obs
    if p.do_rematch:
        u_obs, _ = rematch.rematch_observations(
            K, Kinv, img_pad, pad, problem.q, problem.t, obs.anchor_idx,
            obs.obs_idx, slot_w[obs.anchor_idx], slot_w[obs.obs_idx],
            obs.u_ref, obs.u_obs, obs.lm_idx, problem.lm_idepth, obs.valid,
            radius=p.rematch_radius, max_cost=p.rematch_max_cost,
            min_eig=p.rematch_min_eig)
        problem = problem._replace(obs=obs._replace(u_obs=u_obs))
    sqrtW = None
    if p.aniso_weights:
        sqrtW = rematch.observation_weights(img_pad, pad,
                                            slot_w[obs.anchor_idx],
                                            obs.u_ref)
    return problem, sqrtW


def _solve_packed(p: BAParams, K, Kinv, buf: torch.Tensor, img_pad, pad: int,
                  n_fixed: int, P: int, L: int, M: int) -> torch.Tensor:
    """Decode the problem upload (_pack_problem layout), optionally
    re-match in 2-D and weight, run the Schur Gauss-Newton window solve,
    and return one flat float32 result [q 4P | t 3P | lm L | cost]."""
    problem, slot_w = _decode_packed(buf, P, L, M)
    problem, sqrtW = _rematch_and_weigh(p, K, Kinv, problem, slot_w, img_pad,
                                        pad)
    return _flat_result(*schur.solve_window(p, K, Kinv, problem,
                                            n_fixed=n_fixed, sqrtW=sqrtW))


def _flat_result(q, t, lm, cost) -> torch.Tensor:
    return torch.cat([q.reshape(-1), t.reshape(-1), lm, cost.reshape(1)])


def _solve_graphed(steps, p: BAParams, K, Kinv, buf: torch.Tensor, img_pad,
                   pad: int, n_fixed: int, P: int, L: int,
                   M: int) -> torch.Tensor:
    """_solve_packed replayed from the graph runner `steps` (a frame
    stack's step_graph.Steps) as kind "ba", one graph per window size;
    eagerly where steps is None. The result is the caller's own."""
    def body(ins, scalars):
        return _solve_packed(p, K, Kinv, ins[0], img_pad, pad, n_fixed, P, L,
                             M)
    if steps is None:
        return body([buf], ())
    return steps.run("ba", body, [buf], (), p, (img_pad, K, Kinv),
                     static=(pad, n_fixed, P, L, M))


def _apply_idepths(feats: pipeline.FeatureState, trip: torch.Tensor,
                   first_slot: int = 0) -> pipeline.FeatureState:
    """Scatter refined idepths into the feature state: trip (L, 4) int32
    rows [slot, feat_id, anchor_slot, mu_bits]. A row applies only where
    the slot is valid and still holds the same feat_id (compared mod
    2^24, as the packed transfer carries it) and the same anchor
    poseframe slot: a feature re-anchored between stage and apply keeps
    its feat_id, but its idepth now lives in the new anchor frame, and
    re-anchoring always changes the slot. feats may be a block of the
    state whose first row is slot first_slot (a rank's block over a
    process group): rows of other slots do not apply."""
    slots = trip[:, 0].long() - first_slot
    ids = trip[:, 1]
    mus = trip[:, 3].contiguous().view(torch.float32)
    N = feats.idepth_mu.shape[0]
    sl = torch.clamp(slots, 0, N - 1)
    ok = (slots >= 0) & (slots < N) \
        & ((feats.feat_id[sl] & 0xFFFFFF) == (ids & 0xFFFFFF)) \
        & (feats.pf_slot[sl] == trip[:, 2].long()) & feats.valid[sl]
    mu = torch.cat([feats.idepth_mu, feats.idepth_mu[:1]])
    mu[torch.where(ok, sl, N)] = mus
    return feats.replace(idepth_mu=mu[:N])


class BundleAdjuster:
    """Drives windowed BA over a Flame instance, asynchronously:
    observations and state snapshots arrive on the packed transfer, a
    solve runs as one upload and one flat result fetched without
    blocking, and results apply later under identity guards."""

    def __init__(self, params: BAParams, K, Kinv, mesh=None):
        self.params = params
        self.K = K
        self.Kinv = Kinv
        # A parallel.sharding.Mesh: every solve takes the observation-
        # sharded path (parallel/distributed_ba.py) and applies at once.
        self.mesh = mesh
        self.store = ObservationStore(params.obs_capacity)
        self.last_cost: Optional[float] = None
        self.last_accepted: bool = False
        self._snap = None  # latest decoded host snapshot
        self._snap_dirty = False  # new observations since the last solve?
        self._inflight = None  # (fetch, meta) of a staged solve result
        self._new_pf_count = 0  # poseframes ingested since the last solve
        # fid -> (q, t): each poseframe's pose from the first snapshot that
        # holds it, before any refinement. The pose prior anchors here, not
        # to the refined poses, which would let the window random-walk.
        self._input_pose_by_id: Dict[int, tuple] = {}

    def ingest_snapshot(self, snap: dict, fids, pf_flags) -> None:
        """Record the poseframes' successful matches of one decoded packed
        transfer into the store and keep the snapshot for the next solve.
        fids/pf_flags: the dispatch's frames."""
        uo = snap["uo"]
        scale = 1.0 / pipeline.PACK_XY_SCALE
        for b in range(min(uo.shape[0], len(fids))):
            if not pf_flags[b]:
                continue
            fid = int(fids[b])
            slots = np.nonzero(uo[b, :, 0] != pipeline.PACK_BA_FAIL)[0]
            if slots.size == 0:
                continue
            anchor_ids = snap["stack_fid"][snap["pf_slot"][slots]]
            keep = anchor_ids != fid
            slots = slots[keep]
            if slots.size == 0:
                continue
            self.store.add_frame(anchor_ids[keep], fid,
                                 snap["feat_id"][slots],
                                 snap["xy"][slots].astype(np.float32) * scale,
                                 uo[b, slots].astype(np.float32) * scale)
            self._snap_dirty = True
            self._new_pf_count += 1
        self._snap = snap
        # Record newly seen poseframes' input poses; forget evicted ones.
        live = set()
        for i, f in enumerate(snap["stack_fid"].tolist()):
            if f >= 0:
                live.add(f)
                if f not in self._input_pose_by_id:
                    self._input_pose_by_id[f] = (snap["stack_q"][i].copy(),
                                                 snap["stack_t"][i].copy())
        for f in [f for f in self._input_pose_by_id if f not in live]:
            del self._input_pose_by_id[f]

    def _snapshot_landmarks(self, feat_valid: np.ndarray):
        """(feat_id, anchor_id) -> (slot, idepth, anchor_slot) from the
        snapshot, without device reads."""
        s = self._snap
        sel = np.nonzero(feat_valid & (s["mu"] > 1e-6))[0]
        aslots = s["pf_slot"][sel]
        anchors = s["stack_fid"][aslots]
        return {(int(f), int(a)): (int(sl), float(m), int(asl))
                for f, a, sl, m, asl in zip(s["feat_id"][sel].tolist(),
                                            anchors.tolist(), sel.tolist(),
                                            s["mu"][sel].tolist(),
                                            aslots.tolist())}

    def step(self, fl, force: bool = False) -> None:
        """Apply a finished solve if one landed, else stage a new solve
        when fresh observations wait. force joins the solve in flight;
        solver.deterministic forces every join (a ready() poll depends on
        timing)."""
        force = force or bool(fl.params.solver.deterministic)
        if self._inflight is not None:
            fetch, meta = self._inflight
            if not (force or fetch.ready()):
                return  # one solve in flight at a time
            self._inflight = None
            self._apply(fl, fetch.get(), meta)
        if self._snap is not None and self._snap_dirty \
                and len(fl._pf_slot_by_id) >= 3 \
                and self._new_pf_count >= self.params.solve_min_new_pfs:
            self._stage_solve(fl)

    def quiesce(self, fl) -> None:
        """Join and apply the solve in flight, and one that step() stages
        right after, so nothing is left in flight."""
        self.step(fl, force=True)
        if self._inflight is not None:
            fetch, meta = self._inflight
            self._inflight = None
            self._apply(fl, fetch.get(), meta)

    def _stage_solve(self, fl, n_fixed: int = 2) -> None:
        from flame_tpu_torch.core.flame import _AsyncFetch
        p = self.params
        need = max(n_fixed + 1, 3)
        # Window members must be in the snapshot, whose poses include
        # every refinement applied so far (a poseframe added after it
        # waits one round).
        s = self._snap
        snap_slot_by_id = {f: i for i, f in
                           enumerate(s["stack_fid"].tolist()) if f >= 0}
        window_ids = sorted(fl._pf_slot_by_id)[-p.window_size:]
        if len(window_ids) < need:
            return
        window_ids = [f for f in window_ids if f in snap_slot_by_id]
        if len(window_ids) < need:
            return
        # ba_stage: the window's build, the pack, the upload and the
        # solve's launch, which holds the timed block ba_solve.
        with fl.stats.span("ba_stage"):
            pose_by_id = {f: (s["stack_q"][snap_slot_by_id[f]],
                              s["stack_t"][snap_slot_by_id[f]])
                          for f in window_ids}
            lm_map = self._snapshot_landmarks(fl._feat_valid_np)
            built = self.store.build_window(
                window_ids, pose_by_id,
                {k: v[1] for k, v in lm_map.items()},
                max_landmarks=p.max_landmarks, max_obs=p.max_obs,
                prior_by_id=self._input_pose_by_id)
            if built is None:
                return
            # The cadence is charged only for a solve that stages.
            self._snap_dirty = False
            self._new_pf_count = 0
            problem, order, keys, n_obs = built
            # Landmark -> current slot and anchor slot, checked again on
            # the device at apply time.
            slot_w = np.array([fl._pf_slot_by_id[f] for f in order],
                              np.int32)
            P, L, M = len(order), p.max_landmarks, p.max_obs
            meta = dict(order=order, P=P, L=L, n_obs=n_obs,
                        lm_slots=np.array([lm_map[k][0] for k in keys],
                                          np.int32),
                        lm_ids=np.array([k[0] for k in keys], np.int32),
                        lm_anchor_slots=np.array([lm_map[k][2] for k in keys],
                                                 np.int32),
                        # Staged poses, for the write-back gate at apply
                        # time.
                        q_in=np.array(problem.q, np.float32),
                        t_in=np.array(problem.t, np.float32))
            buf = torch.as_tensor(_pack_problem(problem, slot_w),
                                  device=fl.device)
            img_pad = fl._stack.img_pad
            steps = step_graph.steps_for(fl._stack)
            if self.mesh is not None:
                # Under a mesh every solve is observation-sharded and
                # counted.
                from flame_tpu_torch.parallel import distributed_ba
                fl.stats.add("ba_sharded_solves", 1)
                with fl.stats.timed("ba_solve"), step_graph.active(steps):
                    prob, slots = _decode_packed(buf, P, L, M)
                    prob, sqrtW = _rematch_and_weigh(
                        p, self.K, self.Kinv, prob, slots, img_pad,
                        fl.params.pad)
                    res = _flat_result(*distributed_ba.solve_window_sharded(
                        p, self.K, self.Kinv, prob, self.mesh,
                        n_fixed=n_fixed, sqrtW=sqrtW))
            else:
                fl.stats.add("ba_single_solves", 1)
                with fl.stats.timed("ba_solve"):
                    res = _solve_graphed(steps, p, self.K, self.Kinv, buf,
                                         img_pad, fl.params.pad, n_fixed, P,
                                         L, M)
        if self.mesh is not None:
            # Under a mesh every solve is applied at once, as in the JAX
            # package.
            self._apply(fl, res.cpu().numpy(), meta)
        else:
            self._inflight = (_AsyncFetch(res), meta)

    def _apply(self, fl, flat: np.ndarray, meta: dict) -> None:
        """Acceptance-check a finished solve and write the poses and the
        refined idepths back (no blocking reads), in the span ba_apply."""
        with fl.stats.span("ba_apply"):
            p = self.params
            P, L = meta["P"], meta["L"]
            q = flat[: 4 * P].reshape(P, 4)
            t = flat[4 * P: 7 * P].reshape(P, 3)
            lm = flat[7 * P: 7 * P + L]
            cost = float(flat[7 * P + L])
            self.last_cost = cost
            mean_cost = cost / max(meta["n_obs"], 1)
            self.last_accepted = bool(np.isfinite(mean_cost)
                                      and mean_cost < p.max_mean_cost)
            if not self.last_accepted:
                fl.stats.add("ba_solves_rejected", 1)
                return
            fl.stats.add("ba_solves_applied", 1)

            # Poses of the frames still resident (a prune or an eviction
            # between stage and apply drops a row).
            rows = [(fl._pf_slot_by_id[f], i)
                    for i, f in enumerate(meta["order"])
                    if f in fl._pf_slot_by_id]
            if rows:
                sel = np.array([i for _, i in rows])
                frame_mod.set_poses(fl._stack, [s for s, _ in rows],
                                    torch.as_tensor(q[sel], device=fl.device),
                                    torch.as_tensor(t[sel], device=fl.device))

            # Write-back gate: when the solve barely moved the window poses,
            # the refined idepths are re-triangulations of converged filter
            # depths from noisier re-matches; skip them (counted). A zero
            # threshold disables its axis only.
            if p.writeback_min_dt > 0 or p.writeback_min_drot > 0:
                pe = evaluation.pose_errors(q, t, meta["q_in"], meta["t_in"])
                t_small = (p.writeback_min_dt <= 0
                           or pe["t_max"] < p.writeback_min_dt)
                r_small = (p.writeback_min_drot <= 0
                           or np.radians(pe["r_max_deg"])
                           < p.writeback_min_drot)
                if t_small and r_small:
                    fl.stats.add("ba_writeback_skips", 1)
                    return

            # Refined idepths: one (L, 4) upload and a guarded scatter; rows
            # past the window's landmarks have slot -1 (inert).
            trip = np.full((L, 4), -1, np.int32)
            Lk = meta["lm_slots"].shape[0]
            trip[:Lk, 0] = meta["lm_slots"]
            trip[:Lk, 1] = meta["lm_ids"]
            trip[:Lk, 2] = meta["lm_anchor_slots"]
            trip[:, 3] = lm.astype(np.float32).view(np.int32)
            first = 0
            if sharding.grouped(self.mesh):
                first = sharding.block_slice(fl.params.feature_capacity,
                                             self.mesh).start
            fl._feats = _apply_idepths(fl._feats,
                                       torch.as_tensor(trip, device=fl.device),
                                       first)
