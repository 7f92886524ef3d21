"""Carry configuration and state from the JAX package into the port.

Takes plain Python/numpy data only (dataclasses.asdict of the JAX Params,
dicts of numpy arrays of its state containers), so this module imports
no JAX. The tests use it to feed both packages the same solver state:
the parameters, the poseframe stack, the features, the graph (its scale
is a plain float), the applied topology and a BA window problem.
"""

import dataclasses
from typing import Mapping

import numpy as np
import torch

from flame_tpu_torch import params as params_mod
from flame_tpu_torch.ba.residuals import BAObservations
from flame_tpu_torch.ba.schur import BAProblem
from flame_tpu_torch.core.frame import FrameStack
from flame_tpu_torch.core.pipeline import CurrFeatures, FeatureState
from flame_tpu_torch.optimize.nltgv2 import GraphState

# Fields of the JAX Params that the port leaves out (TPU-only knobs).
DROPPED_FIELDS = {"max_topology_staleness"}


def _build(cls, d: Mapping):
    kw = {}
    for f in dataclasses.fields(cls):
        if f.name not in d:
            continue
        v = d[f.name]
        if dataclasses.is_dataclass(f.default_factory() if f.default_factory
                                    is not dataclasses.MISSING else None):
            v = _build(type(f.default_factory()), v)
        kw[f.name] = v
    known = {f.name for f in dataclasses.fields(cls)}
    unknown = set(d) - known - DROPPED_FIELDS
    if unknown:
        raise ValueError(f"{cls.__name__}: unknown fields {sorted(unknown)}")
    return cls(**kw)


def params_from_dict(d: Mapping) -> params_mod.Params:
    """The port's Params from dataclasses.asdict(jax_params)."""
    return _build(params_mod.Params, d)


def _t(a, device, dtype=None):
    t = torch.as_tensor(np.array(a), device=device)  # owned copy
    return t if dtype is None else t.to(dtype)


def frame_stack_from_numpy(d: Mapping, device) -> FrameStack:
    """FrameStack from the JAX stack's arrays (its img_pack table, a TPU
    sampling workaround, is ignored)."""
    f32 = torch.float32
    return FrameStack(
        frame_id=_t(d["frame_id"], device, torch.int32),
        q=_t(d["q"], device, f32), t=_t(d["t"], device, f32),
        img_pad=_t(d["img_pad"], device, f32),
        gradx=_t(d["gradx"], device, f32), grady=_t(d["grady"], device, f32),
        idepthmap=_t(d["idepthmap"], device, f32),
        valid=_t(d["valid"], device, torch.bool))


def feature_state_from_numpy(d: Mapping, device) -> FeatureState:
    f32, i32 = torch.float32, torch.int32
    return FeatureState(
        xy=_t(d["xy"], device, f32), pf_slot=_t(d["pf_slot"], device,
                                                torch.int64),
        idepth_mu=_t(d["idepth_mu"], device, f32),
        idepth_var=_t(d["idepth_var"], device, f32),
        valid=_t(d["valid"], device, torch.bool),
        num_updates=_t(d["num_updates"], device, i32),
        num_dropouts=_t(d["num_dropouts"], device, i32),
        search_status=_t(d["search_status"], device, i32),
        feat_id=_t(d["feat_id"], device, i32))


def curr_features_from_numpy(d: Mapping, device) -> CurrFeatures:
    f32 = torch.float32
    return CurrFeatures(xy=_t(d["xy"], device, f32),
                        idepth=_t(d["idepth"], device, f32),
                        var=_t(d["var"], device, f32),
                        valid=_t(d["valid"], device, torch.bool))


def topology_from_words(words: np.ndarray, triangle_capacity: int,
                        edge_capacity: int, device) -> dict:
    """The port's topology (tris, n_tris, edges, n_edges, edge_ranks: the
    keyword arguments of pipeline._post_delaunay_inner and batch_step)
    from the JAX package's u16 topology words [n_tris, n_edges | tris
    (T, 3) | edge_src | ranks lo | hi << 8 | carry] (vertex-smoother
    layout of flame_tpu's Flame._host_triangulate). The carry segment is
    not read: the port carries duals by matching vertex pairs."""
    w = np.asarray(words).astype(np.int64)
    T, E = triangle_capacity, edge_capacity
    n_tris, n_edges = int(w[0]), int(w[1])
    tris = w[2: 2 + 3 * T].reshape(T, 3)
    edge_src = w[2 + 3 * T: 2 + 3 * T + E]
    rk = w[2 + 3 * T + E: 2 + 3 * T + 2 * E]
    a = tris.reshape(-1)
    b = tris[:, [1, 2, 0]].reshape(-1)
    edges = np.stack([np.minimum(a, b), np.maximum(a, b)], axis=1)[edge_src]
    edges[n_edges:] = 0
    ranks = np.stack([rk & 0xFF, rk >> 8], axis=1)
    return dict(tris=_t(tris, device, torch.int64), n_tris=n_tris,
                edges=_t(edges, device, torch.int64), n_edges=n_edges,
                edge_ranks=_t(ranks, device, torch.int64))


def graph_state_from_numpy(d: Mapping, device) -> GraphState:
    """GraphState from the JAX graph's arrays, incidence tables
    included (int fields become int64, masks bool)."""
    ints = {"edges", "inc_edge", "src_slot"}
    bools = {"vtx_mask", "edge_mask"}
    kw = {}
    for f in dataclasses.fields(GraphState):
        a = d.get(f.name)
        if a is None:
            raise ValueError(f"GraphState field {f.name} missing")
        dtype = (torch.int64 if f.name in ints else
                 torch.bool if f.name in bools else torch.float32)
        kw[f.name] = _t(a, device, dtype)
    return GraphState(**kw)


def ba_problem_from_numpy(d: Mapping, device) -> BAProblem:
    """BAProblem and its BAObservations from numpy arrays: d holds q, t,
    lm_idepth, lm_valid, optional prior_q/prior_t, and obs, a mapping of
    anchor_idx, obs_idx, lm_idx, u_ref, u_obs, valid (the fields of the
    JAX package's BAProblem; its NamedTuples' _asdict() gives them)."""
    f32 = torch.float32
    o = d["obs"]
    if not isinstance(o, Mapping):
        o = o._asdict()
    obs = BAObservations(
        anchor_idx=_t(o["anchor_idx"], device, torch.int64),
        obs_idx=_t(o["obs_idx"], device, torch.int64),
        lm_idx=_t(o["lm_idx"], device, torch.int64),
        u_ref=_t(o["u_ref"], device, f32), u_obs=_t(o["u_obs"], device, f32),
        valid=_t(o["valid"], device, torch.bool))

    def opt(k):
        return None if d.get(k) is None else _t(d[k], device, f32)
    return BAProblem(q=_t(d["q"], device, f32), t=_t(d["t"], device, f32),
                     lm_idepth=_t(d["lm_idepth"], device, f32),
                     lm_valid=_t(d["lm_valid"], device, torch.bool), obs=obs,
                     prior_q=opt("prior_q"), prior_t=opt("prior_t"))
