"""Wrappers around the port's kernel entry points, installed by the
benchmark for one run.

The port calls its kernels through module attributes
(smoother_kernel.smooth, raster_kernel.rasterize,
raster_kernel.rasterize_batch_with_count), so replacing the attribute
puts a wrapper in the path without touching the port. Each wrapper runs
its listeners' before() hooks, the original function, then their
after() hooks. The wrappers add a Python call and nothing on the
device; the listeners decide what is kept:

  * Sampler (every run): on a call it is armed for, a device copy of the
    inputs the reference needs, and of the output where the output is
    not what the harness reads back itself. The tracking step
    (pipeline.track_project_sync) and the post-Delaunay step
    (pipeline._post_delaunay_inner), called by name inside the pipeline
    module, are wrapped the same way; so is the host triangulation
    (mesh.delaunay.triangulate), whose latest call, on whichever thread
    made it, is kept for every sample.
  * CallLog (traced slice only): references to the inputs and outputs,
    for the roofline files' byte and operation counts after the slice.
  * A compared-number plug-in's Listener (compare/<name>.py), installed
    only in a cell whose limits name one of its numbers, on the points
    its HOOKS list.

A point is (module, attribute). The attribute may be dotted,
"BundleAdjuster._apply": the wrapper then replaces the method on its
class, is called with the instance first among its args, and uninstall
puts back the very object the class held.
"""

import importlib

SMOOTH = ("flame_tpu_torch.optimize.smoother_kernel", "smooth")
RASTER = ("flame_tpu_torch.ops.raster_kernel", "rasterize")
RASTER_BATCH = ("flame_tpu_torch.ops.raster_kernel",
                "rasterize_batch_with_count")
TRACK = ("flame_tpu_torch.core.pipeline", "track_project_sync")
POST = ("flame_tpu_torch.core.pipeline", "_post_delaunay_inner")
DELAUNAY = ("flame_tpu_torch.mesh.delaunay", "triangulate")
# _post_delaunay_inner's parameters, in order.
POST_ARGS = ("params", "K", "Kinv", "graph", "member", "curr", "pose_prev",
             "pose_new", "graph_scale", "width", "height", "prev_idepthmap",
             "tris", "n_tris", "edges", "n_edges")


class Hooks:
    """One wrapper per (module, attribute), shared by its listeners."""

    def __init__(self):
        self._listeners = {}
        self._orig = {}

    def listen(self, point, listener) -> None:
        self._listeners.setdefault(tuple(point), []).append(listener)

    def install(self) -> None:
        for point, listeners in self._listeners.items():
            owner, attr = _owner(point)
            orig = getattr(owner, attr)
            # What the owner itself held: None for a method its class
            # inherits, which uninstall deletes again.
            self._orig[point] = (owner, attr, vars(owner).get(attr))

            def wrapper(*args, _orig=orig, _ls=listeners, _pt=point,
                        **kwargs):
                tokens = [ls.before(_pt, args, kwargs) for ls in _ls]
                out = _orig(*args, **kwargs)
                for ls, tok in zip(_ls, tokens):
                    ls.after(_pt, tok, out)
                return out
            setattr(owner, attr, wrapper)

    def uninstall(self) -> None:
        for owner, attr, held in self._orig.values():
            if held is None:
                delattr(owner, attr)
            else:
                setattr(owner, attr, held)
        self._orig.clear()


def _owner(point):
    """The module, or the class a dotted attribute names in it, that
    holds the point's attribute, and the attribute's own name."""
    owner = importlib.import_module(point[0])
    *path, attr = point[1].split(".")
    for name in path:
        owner = getattr(owner, name)
    return owner, attr


def _graph_copy(g) -> dict:
    keys = ("pos", "x", "w1", "w2", "x_bar", "w1_bar", "w2_bar", "data_term",
            "data_weight", "vtx_mask", "edges", "edge_mask", "q1", "q2", "q3")
    return {k: getattr(g, k).detach().clone() for k in keys}


class Sampler:
    """Copies the first call of each hook point after arm(), until
    take() hands the copies over."""

    def __init__(self):
        self.armed = False
        self._got = {}
        self.last_tri = None  # the latest triangulation: (points, triangles)

    def arm(self) -> None:
        self.armed = True
        self._got = {}

    def take(self) -> dict:
        self.armed = False
        got, self._got = self._got, {}
        if self.last_tri is not None:
            got[DELAUNAY] = self.last_tri
        return got

    def before(self, point, args, kwargs):
        if point == DELAUNAY:
            return dict(points=args[0].copy())
        if not self.armed or point in self._got:
            return None
        if point == POST:
            a = dict(zip(POST_ARGS, args), **kwargs)
            n_tris, n_edges = int(a["n_tris"]), int(a["n_edges"])
            return dict(member=a["member"].clone(),
                        xy=a["curr"].xy.clone(),
                        idepth=a["curr"].idepth.clone(),
                        graph_scale=float(a["graph_scale"]),
                        tris=a["tris"][:n_tris].clone(),
                        edges=a["edges"][:n_edges].clone(),
                        async_topology=bool(
                            a["params"].solver.async_topology),
                        tri_cap=int(a["params"].triangle_capacity),
                        edge_cap=int(a["params"].edge_capacity))
        if point == SMOOTH:
            rp, g, n_iters = args[:3]
            return dict(g=_graph_copy(g), n_iters=int(n_iters),
                        rp={k: float(getattr(rp, k)) for k in (
                            "data_factor", "step_x", "step_q", "theta",
                            "x_min", "x_max")},
                        degree=int(g.inc_edge.shape[1]))
        if point == TRACK:
            import dataclasses
            params, _K, _Kinv, stack, feats, fnew, slot = args[:7]
            return dict(
                params=dataclasses.asdict(params),
                stack_fid=stack.frame_id.clone(), stack_q=stack.q.clone(),
                stack_t=stack.t.clone(),
                feats={k: getattr(feats, k).clone() for k in (
                    "xy", "pf_slot", "idepth_mu", "idepth_var", "valid",
                    "num_updates")},
                fid=int(fnew.frame_id), q=fnew.q.clone(), t=fnew.t.clone(),
                slot=int(slot))
        if point in (RASTER, RASTER_BATCH):
            verts, tris, vals, tri_valid, height, width = args[:6]
            return dict(verts=verts.detach().clone(), tris=tris.clone(),
                        vals=vals.detach().clone(),
                        tri_valid=tri_valid.clone(), height=int(height),
                        width=int(width))
        return None

    def after(self, point, token, out) -> None:
        if token is None:
            return
        if point == DELAUNAY:
            self.last_tri = dict(token, triangles=out.triangles.copy())
            return
        if point == SMOOTH:
            token["x_out"] = out.x.detach().clone()
        elif point == RASTER_BATCH:
            token["maps"] = out[0].detach().clone()
        elif point == TRACK:
            token["mu_out"] = out[0].idepth_mu.clone()
            token["updates_out"] = out[0].num_updates.clone()
        self._got[point] = token


class CallLog:
    """Per hook point, the record() of every call while recording."""

    def __init__(self, recorders: dict):
        self.recorders = recorders  # point -> [(key, record fn)]
        self.recording = False
        self.calls = {}

    def before(self, point, args, kwargs):
        return (args, kwargs) if self.recording else None

    def after(self, point, token, out) -> None:
        if token is None:
            return
        for key, record in self.recorders.get(point, ()):
            self.calls.setdefault(key, []).append(record(*token, out))
