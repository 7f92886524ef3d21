"""Checkpoint and resume of a Flame's whole state.

Counterpart of flame_tpu/utils/checkpoint.py for the port's own state;
a port checkpoint is read by the port only. save() first quiesces the
instance (_quiesce): it runs the buffered batch frames, consumes every
queued snapshot, joins the triangulation in flight and joins and applies
the BA solve in flight. The live instance is then in exactly the state
that load() reproduces, so a run that saves and continues and a run that
loads and continues compute the same thing.

The file is one npz: the feature, current-feature, graph and frame-stack
tensors (copied to the host), the mesh outputs, the staged topology in
whatever form the drain left it (host tuples; device copies are
uploaded again on load), the host mirrors, the BA observation store,
snapshot, solve cadence and input-pose anchors, and a JSON header of
counters and bookkeeping. Not saved: the CUDA graphs (the stack's
runner captures them again at their first calls after load) and
transfers in flight. Transfers queued on the instance that load()
overwrites cannot be cancelled; they become zombies, counted in flight
until they land, as after clear().

A ShardedFlame over a process group (parallel/orchestrator.py) is saved
and loaded by every rank: save gathers the ranks' blocks of the feature
and graph state and the coordinator writes the one npz (the other ranks
wait for it); load reads the file on every rank, so the path must be
visible to each, and puts each rank's blocks back on it, restoring the
placements (flame_tpu/utils/checkpoint.py's put()).
"""

import dataclasses
import json
import os
from typing import Dict

import numpy as np
import torch
import torch.distributed as dist

from flame_tpu_torch.core import frame as frame_mod
from flame_tpu_torch.parallel import sharding

# Fields of a host topology tuple (Flame._host_triangulate's result).
_TOPO_FIELDS = ("tris", "edges", "ranks", "perm")
# The state a process-group ShardedFlame holds in blocks.
_BLOCKED = ("feats", "curr", "graph", "vtx_idepths", "vtx_normals")


def _quiesce(fl) -> None:
    """Bring the asynchronous pipeline to rest: no buffered batch frames,
    no queued snapshots, no triangulation and no BA solve in flight."""
    fl._flush_batch()
    while fl._packed_queue:
        pk, pk_frame, pk_meta, _fids = fl._packed_queue.popleft()
        fl._sheds_since_consume = 0
        if not fl._consume_packed(pk.get(), pk_frame, pk_meta):
            break  # too few features: the instance cleared itself
    fl._adopt_tri_result(force=True)
    if fl._ba is not None:
        fl._ba.quiesce(fl)


def _np(t) -> np.ndarray:
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t)


def _put_fields(arrays: Dict[str, np.ndarray], prefix: str, obj) -> None:
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        if v is not None:
            arrays[f"{prefix}.{f.name}"] = _np(v)


def _put_topo(arrays, header, name: str, host) -> None:
    header[name] = host is not None
    if host is None:
        return
    for k, v in zip(_TOPO_FIELDS, host):
        if v is not None:
            arrays[f"{name}.{k}"] = np.asarray(v)


def save(path: str, fl) -> None:
    """Quiesce fl and write its state to path (an npz file, replaced
    atomically)."""
    _quiesce(fl)
    if fl._tri_pending is not None or fl._packed_queue:
        raise RuntimeError("checkpoint.save: the pipeline did not come to "
                           "rest")
    mesh = fl._sharding_mesh
    whole = {k: getattr(fl, f"_{k}") for k in _BLOCKED}
    whole = dict(zip(whole, sharding.gather_rows(mesh, *whole.values())))

    def get(name):
        return whole[name] if name in whole else getattr(fl, f"_{name}")
    arrays: Dict[str, np.ndarray] = {}
    for name in ("feats", "curr", "graph", "stack"):
        _put_fields(arrays, name, get(name))
    for name in ("tris", "tri_validity", "vtx_idepths", "vtx_normals",
                 "idepthmap", "graph_scale", "last_stats_dev"):
        arrays[name] = _np(get(name))
    if fl._coverage is not None:
        arrays["coverage"] = _np(fl._coverage)
    arrays["edges_np"] = np.asarray(fl._edges_np)
    # The validity mirror lags feats.valid by design (it reflects the last
    # consumed snapshot): saved as it is, not refreshed.
    arrays["feat_valid_np"] = fl._feat_valid_np
    arrays["raster_union"] = np.array([int(c) for c in fl._raster_union],
                                      np.int64)

    header = {
        "width": fl.width, "height": fl.height,
        "feature_capacity": fl.params.feature_capacity,
        "poseframe_capacity": fl.params.poseframe_capacity,
        "inited": bool(fl.inited), "num_imgs": fl.num_imgs,
        "num_data_updates": fl.num_data_updates,
        "num_regularizer_updates": fl.num_regularizer_updates,
        "n_edges": fl._n_edges, "n_tris": fl._n_tris,
        "n_members": fl._n_members,
        "pf_slot_by_id": {str(k): int(v)
                          for k, v in fl._pf_slot_by_id.items()},
        "curr_pf_slot": fl._curr_pf_slot, "curr_pf_id": fl._curr_pf_id,
        # In its order: _alloc_pf_slot pops from the end, so a sorted list
        # would allocate other slots than the saved instance.
        "pf_free": [int(s) for s in fl._pf_free],
        "feat_id_counter": fl._feat_id_counter,
        "dispatches": fl._dispatches,
        "last_dispatch_frames": fl._last_dispatch_frames,
        "coalesce": bool(fl._coalesce),
        # _staged is the device copy of _last_topo_host when set.
        "staged": fl._staged is not None,
        "stats": fl.stats.snapshot()["stats"],
    }
    # Frames are re-created from (id, pose, image) on load.
    for name in ("fnew", "fprev"):
        f = getattr(fl, f"_{name}")
        header[name] = None if f is None else int(f.frame_id)
        if f is not None:
            arrays[f"{name}.q"] = _np(f.q)
            arrays[f"{name}.t"] = _np(f.t)
            arrays[f"{name}.img"] = _np(f.img)
    if fl._last_sync_pose is not None:
        arrays["sync_q"] = _np(fl._last_sync_pose[0])
        arrays["sync_t"] = _np(fl._last_sync_pose[1])
    if fl._curr_pf_pose_np is not None:
        arrays["pf_pose_q"] = np.asarray(fl._curr_pf_pose_np[0], np.float64)
        arrays["pf_pose_t"] = np.asarray(fl._curr_pf_pose_np[1], np.float64)
    _put_topo(arrays, header, "last_topo", fl._last_topo_host)
    _put_topo(arrays, header, "pending_topo", fl._pending_topo)

    ba = fl._ba
    if ba is not None:
        st = ba.store
        for k in ("aid", "oid", "fid", "uref", "uobs"):
            arrays[f"ba.{k}"] = getattr(st, f"_{k}")
        header["ba"] = {
            "n": int(st._n), "head": int(st._head),
            "capacity": int(st.capacity),
            # The snapshot and its dirty flag decide when the next solve
            # stages and from which poses; the cadence counter where.
            "snap": ba._snap is not None, "snap_dirty": bool(ba._snap_dirty),
            "new_pf_count": int(ba._new_pf_count)}
        if ba._snap is not None:
            for k, v in ba._snap.items():
                arrays[f"ba_snap.{k}"] = v
        ip = ba._input_pose_by_id
        fids = sorted(ip)
        arrays["ba_input.fids"] = np.array(fids, np.int64)
        arrays["ba_input.q"] = np.array([ip[f][0] for f in fids],
                                        np.float32).reshape(-1, 4)
        arrays["ba_input.t"] = np.array([ip[f][1] for f in fids],
                                        np.float32).reshape(-1, 3)

    arrays["__header__"] = np.frombuffer(json.dumps(header).encode(),
                                         dtype=np.uint8)
    grouped = sharding.grouped(mesh)
    if not grouped or mesh.first_block == 0:
        tmp = f"{path}.{os.getpid()}.tmp"
        with open(tmp, "wb") as f:
            np.savez(f, **arrays)
        os.replace(tmp, path)
    if grouped:
        dist.barrier(group=mesh.group)  # the file exists for every rank


def _get_topo(data, header, name: str):
    if not header[name]:
        return None
    return tuple(np.array(data[f"{name}.{k}"]) if f"{name}.{k}" in data
                 else None for k in _TOPO_FIELDS)


def load(path: str, fl) -> None:
    """Restore fl in place from a checkpoint. fl must have been built with
    the same image size and Params; every tensor goes to fl's device."""
    with np.load(path) as npz:
        data = dict(npz)
    header = json.loads(bytes(data["__header__"]).decode())
    want = (fl.width, fl.height, fl.params.feature_capacity,
            fl.params.poseframe_capacity)
    got = (header["width"], header["height"], header["feature_capacity"],
           header["poseframe_capacity"])
    if want != got:
        raise ValueError(f"checkpoint.load: the checkpoint has (width, "
                         f"height, feature_capacity, poseframe_capacity) "
                         f"{got}, the Flame {want}")
    dev = fl.device
    mesh = fl._sharding_mesh

    def tensor(key, proto=None, blocked=False):
        t = torch.as_tensor(data[key], device=dev)
        if proto is not None:
            shape = tuple(proto.shape)
            if blocked and sharding.grouped(mesh):  # proto: the block
                shape = (shape[0] * mesh.size,) + shape[1:]
            if tuple(t.shape) != shape:
                raise ValueError(f"checkpoint.load: {key} has shape "
                                 f"{tuple(t.shape)}, the Flame {shape}")
        return sharding.shard_rows(t, mesh) if blocked else t

    def fields(prefix, proto):
        kw = {}
        for f in dataclasses.fields(proto):
            key = f"{prefix}.{f.name}"
            p = getattr(proto, f.name)
            kw[f.name] = tensor(key, p, True) if key in data else None
        return type(proto)(**kw)

    fl._feats = fields("feats", fl._feats)
    fl._curr = fields("curr", fl._curr)
    fl._graph = fields("graph", fl._graph)
    # The stack is written in place: its CUDA graphs (tracking, the BA
    # solve) read it at its address.
    for f in dataclasses.fields(fl._stack):
        dst = getattr(fl._stack, f.name)
        dst.copy_(tensor(f"stack.{f.name}", dst))
    for name in ("tris", "tri_validity", "vtx_idepths", "vtx_normals",
                 "idepthmap", "graph_scale"):
        setattr(fl, f"_{name}", tensor(name, getattr(fl, f"_{name}"),
                                       name in _BLOCKED))
    fl._last_stats_dev = tensor("last_stats_dev")
    fl._coverage = tensor("coverage") if "coverage" in data else None
    fl._edges_np = np.array(data["edges_np"])
    fl._feat_valid_np = np.array(data["feat_valid_np"])
    fl._n_valid = int(fl._feat_valid_np.sum())
    fl._raster_union.clear()
    fl._raster_union.extend(int(c) for c in data["raster_union"])

    fl.inited = bool(header["inited"])
    fl.num_imgs = int(header["num_imgs"])
    fl.num_data_updates = int(header["num_data_updates"])
    fl.num_regularizer_updates = int(header["num_regularizer_updates"])
    fl._n_edges = int(header["n_edges"])
    fl._n_tris = int(header["n_tris"])
    fl._n_members = int(header["n_members"])
    fl._pf_slot_by_id = {int(k): int(v)
                         for k, v in header["pf_slot_by_id"].items()}
    fl._curr_pf_slot = header["curr_pf_slot"]
    fl._curr_pf_id = header["curr_pf_id"]
    fl._pf_free = [int(s) for s in header["pf_free"]]
    fl._feat_id_counter = int(header["feat_id_counter"])
    fl._dispatches = int(header["dispatches"])
    fl._last_dispatch_frames = int(header["last_dispatch_frames"])
    fl._coalesce = bool(header["coalesce"])
    for k, v in header["stats"].items():
        fl.stats.set(k, v)

    def frame(name):
        if header[name] is None:
            return None
        return frame_mod.create(header[name], tensor(f"{name}.q"),
                                tensor(f"{name}.t"), tensor(f"{name}.img"),
                                fl.params.pad)
    fl._fnew = frame("fnew")
    fl._fprev = frame("fprev")
    fl._last_sync_pose = ((tensor("sync_q"), tensor("sync_t"))
                          if "sync_q" in data else None)
    fl._curr_pf_pose_np = ((np.array(data["pf_pose_q"]),
                            np.array(data["pf_pose_t"]))
                           if "pf_pose_q" in data else None)
    fl._last_topo_host = _get_topo(data, header, "last_topo")
    fl._pending_topo = _get_topo(data, header, "pending_topo")
    fl._topo_dev = fl._staged = None
    if header["staged"]:
        fl._topo_dev = fl._staged = fl._upload(fl._last_topo_host)
    fl._tri_pending = None
    fl._batch_pending = []

    # Transfers queued on this instance cannot be cancelled: they stay in
    # flight as zombies (as after clear()). The shed and latency state
    # belong to the overwritten run.
    for pk, _frame, _meta, _fids in fl._packed_queue:
        fl._zombie_fetches.append((pk, None))
    fl._packed_queue.clear()
    fl._sheds_since_consume = 0
    fl._restart_latency()

    ba = fl._ba
    if ba is not None:
        if "ba" not in header:
            raise ValueError("checkpoint.load: the Flame runs BA, the "
                             "checkpoint has no BA state")
        h = header["ba"]
        st = ba.store
        if h["capacity"] != st.capacity:
            raise ValueError(f"checkpoint.load: BA obs_capacity "
                             f"{h['capacity']} in the checkpoint, "
                             f"{st.capacity} in the Flame")
        for k in ("aid", "oid", "fid", "uref", "uobs"):
            setattr(st, f"_{k}", np.array(data[f"ba.{k}"]))
        st._n, st._head = int(h["n"]), int(h["head"])
        ba._snap = ({k.split(".", 1)[1]: np.array(v) for k, v in data.items()
                     if k.startswith("ba_snap.")} if h["snap"] else None)
        ba._snap_dirty = bool(h["snap_dirty"])
        ba._new_pf_count = int(h["new_pf_count"])
        ba._inflight = None
        ba._input_pose_by_id = {
            int(f): (np.array(q), np.array(t)) for f, q, t in zip(
                data["ba_input.fids"].tolist(), data["ba_input.q"],
                data["ba_input.t"])}
