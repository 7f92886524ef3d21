"""The comparison that decides `correct`.

Each sampled step of the window left copies of the inputs of the port's
smoother call (K1), of its single-view raster call (K2) and, on the
batched path, of its B-view raster call (K2b), with the smoother's and
K2b's outputs and the dense map the harness read back for that step.
The plain references (reference/) recompute each stage from those inputs
in float64; the numbers compared are the worst over the samples:

  track_gap  median over the feature slots that both the program and the
             reference updated of |mu - mu_ref| / mu_ref: the tracking
             step's inverse depths (reference/tracking, from the
             program's feature state and poseframe poses, the
             benchmark's frames)
  track_miss slots updated by one side only, over the slots the
             reference updated
  k1_gap     largest |x - x_ref| over the graph's vertices, over the
             median |x_ref|
  map_gap    largest |map - map_ref| over the pixels both cover, over the
             median map_ref: the map the harness read
  map_miss   pixels covered by one of the two only, over the pixels
             map_ref covers
  views_gap, views_miss   the same for K2b's B maps
  tri_gap    the host triangulation's latest call (reference/delaunay.py):
             the larger of the largest relative depth of a point inside
             a triangle's circumcircle and the share of the points'
             convex hull that its triangles miss, cover twice or cover
             inside out; 0 for a whole Delaunay triangulation
  sync_gap   the graph handed to the smoother (K1's input) against the
             post-Delaunay step's inputs (reference/graph_sync.py):
             largest |data term - idepth / graph_scale| over the
             members, over the median
  sync_miss  vertices that are not members or members that are not
             vertices, vertices away from their member's pixel, and
             edges in one of the graph and the reference's edge set but
             not the other, over the members and reference edges; with
             a synchronous topology the reference's edges are those of
             the latest triangulation, which has to be of this frame's
             members, else every edge counts as missed
             (sync_gap and sync_miss also hold the inputs of the raster
             call K2 that follows: its values against K1's output times
             graph_scale, its triangles and vertices against the handed
             triangles and the members' pixels)

With control=True every number is also read with the reference in
bfloat16 in the program's place (the control that has to fail).
"""

import numpy as np
import torch

from reference import delaunay as ref_delaunay
from reference import graph_sync as ref_sync
from reference import nltgv2 as ref_nltgv2
from reference import raster as ref_raster
from reference.tracking import step as ref_track

# The names numbers() gives; a plug-in (compare/) may not take them.
NUMBERS = ("track_gap", "track_miss", "k1_gap", "map_gap", "map_miss",
           "views_gap", "views_miss", "tri_gap", "sync_gap", "sync_miss")
MAX_PER_TILE = 160  # the raster contract's candidates per tile, one view
MAX_PER_TILE_BATCH = 192  # and for B views over their union boxes


def _on(t, device):
    return t.to(device) if isinstance(t, torch.Tensor) else t


def _gap(prog: torch.Tensor, ref: torch.Tensor, mask) -> float:
    """Largest |prog - ref| over mask, over the median |ref| there."""
    p = prog.double()[mask]
    r = ref.double()[mask]
    if r.numel() == 0:
        return float("inf")
    scale = max(float(r.abs().median()), 1e-12)
    return float((p - r).abs().max()) / scale


def _map_numbers(prog: torch.Tensor, ref: torch.Tensor):
    pn, rn = torch.isnan(prog), torch.isnan(ref)
    both = ~pn & ~rn
    gap = _gap(prog, ref, both) if bool(both.any()) else float("inf")
    miss = float((pn != rn).sum()) / max(float((~rn).sum()), 1.0)
    return gap, miss


def k1(cap: dict, device, dtype=torch.float64) -> float:
    g = {k: _on(v, device) for k, v in cap["g"].items()}
    x_ref = ref_nltgv2.smooth(g, cap["rp"], cap["n_iters"], cap["degree"])
    x = (ref_nltgv2.smooth(g, cap["rp"], cap["n_iters"], cap["degree"],
                           dtype) if dtype != torch.float64
         else _on(cap["x_out"], device))
    return _gap(x, x_ref, g["vtx_mask"].bool())


def raster(cap: dict, prog_maps, device, batch: bool,
           dtype=torch.float64):
    """(gap, miss) of prog_maps ((B, H, W)) against the reference of the
    captured call; with a dtype below float64 the reference in that
    dtype stands in for prog_maps."""
    args = [_on(cap[k], device) for k in ("verts", "tris", "vals",
                                          "tri_valid")]
    if not batch:
        args = [args[0][None], args[1], args[2][None], args[3][None]]
    kw = dict(max_per_tile=MAX_PER_TILE_BATCH if batch else MAX_PER_TILE,
              union=batch)
    ref = ref_raster.rasterize(*args, cap["height"], cap["width"], **kw)
    if dtype != torch.float64:
        prog_maps = ref_raster.rasterize(*args, cap["height"], cap["width"],
                                         dtype=dtype, **kw)
    prog_maps = _on(torch.as_tensor(prog_maps), device)
    worst = (0.0, 0.0)
    for b in range(ref.shape[0]):
        gap, miss = _map_numbers(prog_maps[b].double(), ref[b])
        worst = (max(worst[0], gap), max(worst[1], miss))
    return worst


def triangulation(cap: dict, device, dtype=torch.float64) -> float:
    """tri_gap of the latest host triangulation; with a dtype below
    float64 the triangulation of the points rounded to it stands in for
    the program's."""
    pts = torch.as_tensor(cap["points"]).to(device)
    tris = cap["triangles"] if dtype == torch.float64 \
        else ref_delaunay.lowp_triangulation(pts, dtype)
    tris = torch.as_tensor(tris).to(device)
    return max(ref_delaunay.violation(pts, tris),
               ref_delaunay.hull_miss(pts, tris))


def graph_sync(post: dict, g: dict, tri, device, dtype=torch.float64):
    """(sync_gap, sync_miss) of the smoother's input graph g against the
    post-Delaunay step's inputs post and the latest triangulation tri;
    with a dtype below float64 the reference in that dtype stands in for
    the program's graph."""
    member = post["member"].to(device)
    xy = post["xy"].to(device)
    V = member.shape[0]
    ref = ref_sync.data_term(post["idepth"].to(device), member,
                             post["graph_scale"], torch.float64)
    edges_ref = edges_low = None
    if post["async_topology"]:
        e = post["edges"].long().cpu()
        edges_ref = edges_low = ref_sync.edge_codes(
            e, member.cpu()[e[:, 0]] & member.cpu()[e[:, 1]], V)
    elif tri is not None:
        # The latest triangulation (held to Delaunay by tri_gap) has to
        # be of this frame's members.
        slots, pts = ref_sync.member_points(member, xy)
        if np.array_equal(pts, np.asarray(tri["points"], np.float32)):
            def edges_of(tris):
                return ref_sync.triangulation_edges(
                    slots[np.asarray(tris)], post["tri_cap"],
                    post["edge_cap"], V)
            edges_ref = edges_of(tri["triangles"])
            if dtype != torch.float64:
                edges_low = edges_of(ref_delaunay.lowp_triangulation(
                    pts, dtype))
    if dtype == torch.float64:
        vtx = g["vtx_mask"].to(device).bool()
        pos = g["pos"].to(device)
        data = g["data_term"].to(device)[member]
        edges = ref_sync.edge_codes(g["edges"], g["edge_mask"], V)
    else:
        vtx = member
        pos = xy.to(dtype).to(xy.dtype)
        data = ref_sync.data_term(post["idepth"].to(device), member,
                                  post["graph_scale"], dtype)
        edges = edges_low if edges_low is not None else set()
    scale = max(float(ref.abs().median()), 1e-12) if ref.numel() else 1.0
    gap = float((data.double() - ref).abs().max()) / scale \
        if ref.numel() else float("inf")
    n_ref = int(member.sum())
    miss = int((vtx != member).sum()) \
        + int((member & (pos != xy).any(dim=1)).sum())
    if edges_ref is None:
        miss += len(edges)
        n_ref += len(edges)
    else:
        miss += len(edges ^ edges_ref)
        n_ref += len(edges_ref)
    return gap, miss / max(n_ref, 1)


def raster_inputs(post: dict, smooth: dict, rast: dict, device,
                  dtype=torch.float64):
    """(gap, miss) of the inputs of the single-view raster call that
    follows the smoother in the same post-Delaunay step: its values
    against K1's output times graph_scale (largest gap over the members,
    over the median), its triangles against the handed ones (valid where
    all three corners are members) and its vertices against the members'
    pixels; with a dtype below float64 the reference in that dtype
    stands in for the program's values and vertices."""
    member = post["member"].to(device)
    xy = post["xy"].to(device)
    ref = smooth["x_out"].to(device).double()[member] * post["graph_scale"]
    if dtype == torch.float64:
        vals = rast["vals"].to(device)[member].double()
        verts = rast["verts"].to(device)
    else:
        vals = (smooth["x_out"].to(device).to(dtype)[member]
                * torch.tensor(post["graph_scale"], dtype=dtype)).double()
        verts = xy.to(dtype).to(xy.dtype)
    if ref.numel() == 0:
        return float("inf"), 1.0
    gap = float((vals - ref).abs().max()) \
        / max(float(ref.abs().median()), 1e-12)
    tris = rast["tris"].to(device).long()
    handed = post["tris"].to(device).long()
    n = handed.shape[0]
    valid = (torch.arange(tris.shape[0], device=device) < n) \
        & member[tris].all(dim=1)
    miss = int((tris[:n] != handed).any(dim=1).sum()) \
        + int((rast["tri_valid"].to(device).bool() != valid).sum()) \
        + int((member & (verts != xy).any(dim=1)).sum())
    return gap, miss / max(int(valid.sum()) + int(member.sum()), 1)


def _camera(cfg: dict, dtype, device):
    c = cfg["camera"]
    K = torch.tensor([[c["fx"], 0.0, c["cx"]], [0.0, c["fy"], c["cy"]],
                      [0.0, 0.0, 1.0]], dtype=torch.float64)
    return K.to(dtype).to(device), torch.linalg.inv(K).to(dtype).to(device)


def track(cap: dict, cfg: dict, image, device, dtype=torch.float64):
    """(gap, miss) of the program's tracking step against the reference
    step; with a dtype below float64 the reference in that dtype stands
    in for the program."""
    def run(dt):
        prev = torch.get_default_dtype()
        torch.set_default_dtype(dt)
        try:
            p = ref_track.namespace(cap["params"])
            K, Kinv = _camera(cfg, dt, device)
            pad = p.fparams.win_size

            def img(fid):
                return torch.as_tensor(image(fid)).to(device)
            fids = cap["stack_fid"].tolist()
            H, W = image(0).shape
            stack = torch.zeros((len(fids), H + 2 * pad, W + 2 * pad),
                                device=device)
            for s_, fid in enumerate(fids):
                if fid >= 0:
                    stack[s_] = ref_track.frame(img(fid), pad)[0]
            new_pad, gx, gy = ref_track.frame(img(cap["fid"]), pad)
            f = {k: (v.to(device).to(dt) if v.is_floating_point()
                     else v.to(device)) for k, v in cap["feats"].items()}
            return ref_track.track(
                p, K, Kinv, stack, cap["stack_q"].to(device).to(dt),
                cap["stack_t"].to(device).to(dt), f, new_pad, gx, gy,
                cap["q"].to(device).to(dt), cap["t"].to(device).to(dt),
                cap["slot"])
        finally:
            torch.set_default_dtype(prev)

    mu_ref, _, ok_ref = run(torch.float64)
    if dtype != torch.float64:
        mu, _, ok = run(dtype)
    else:
        mu = cap["mu_out"].to(device)
        ok = cap["updates_out"].to(device) \
            > cap["feats"]["num_updates"].to(device)
    both = ok & ok_ref
    if not bool(both.any()):
        return float("inf"), 1.0
    rel = (mu.double()[both] - mu_ref[both]).abs() \
        / mu_ref[both].abs().clamp(min=1e-12)
    miss = float((ok != ok_ref).sum()) / max(float(ok_ref.sum()), 1.0)
    return float(rel.median()), miss


def numbers(samples, device, cfg: dict, image,
            control: bool = False) -> dict:
    """The compared numbers of a run (worst over samples), and with
    control the control's under "<name>.control". image(frame_id): the
    uint8 frame the run fed under that id."""
    from harness.hooks import (DELAUNAY, POST, RASTER, RASTER_BATCH, SMOOTH,
                               TRACK)
    out = {}

    def worst(name, value):
        out[name] = max(out.get(name, 0.0), value)

    for s in samples:
        cap = s["captures"]
        if TRACK in cap:
            gap, miss = track(cap[TRACK], cfg, image, device)
            worst("track_gap", gap)
            worst("track_miss", miss)
            if control:
                gap, miss = track(cap[TRACK], cfg, image, device,
                                  torch.bfloat16)
                worst("track_gap.control", gap)
                worst("track_miss.control", miss)
        if SMOOTH in cap:
            worst("k1_gap", k1(cap[SMOOTH], device))
            if control:
                worst("k1_gap.control", k1(cap[SMOOTH], device,
                                           torch.bfloat16))
        if RASTER in cap:
            gap, miss = raster(cap[RASTER], s["map"][None], device, False)
            worst("map_gap", gap)
            worst("map_miss", miss)
            if control:
                gap, miss = raster(cap[RASTER], None, device, False,
                                   torch.bfloat16)
                worst("map_gap.control", gap)
                worst("map_miss.control", miss)
        if RASTER_BATCH in cap:
            c = cap[RASTER_BATCH]
            gap, miss = raster(c, c["maps"], device, True)
            worst("views_gap", gap)
            worst("views_miss", miss)
            if control:
                gap, miss = raster(c, None, device, True, torch.bfloat16)
                worst("views_gap.control", gap)
                worst("views_miss.control", miss)
        if DELAUNAY in cap:
            worst("tri_gap", triangulation(cap[DELAUNAY], device))
            if control:
                worst("tri_gap.control", triangulation(
                    cap[DELAUNAY], device, torch.bfloat16))
        if POST in cap and SMOOTH in cap:
            args = (cap[POST], cap[SMOOTH]["g"], cap.get(DELAUNAY), device)
            gap, miss = graph_sync(*args)
            worst("sync_gap", gap)
            worst("sync_miss", miss)
            if control:
                gap, miss = graph_sync(*args, dtype=torch.bfloat16)
                worst("sync_gap.control", gap)
                worst("sync_miss.control", miss)
            if RASTER in cap:
                args = (cap[POST], cap[SMOOTH], cap[RASTER], device)
                gap, miss = raster_inputs(*args)
                worst("sync_gap", gap)
                worst("sync_miss", miss)
                if control:
                    gap, miss = raster_inputs(*args, dtype=torch.bfloat16)
                    worst("sync_gap.control", gap)
                    worst("sync_miss.control", miss)
    return out


def decide(values: dict, limits: dict):
    """(correct, [(name, value, limit)]) over the workload's limits: a
    number that is missing, NaN or above its limit fails."""
    rows, ok = [], True
    for name, limit in limits.items():
        v = values.get(name)
        good = v is not None and np.isfinite(v) and v <= limit
        ok &= bool(good)
        rows.append((name, v, limit))
    return ok, rows
