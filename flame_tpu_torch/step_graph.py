"""The port's one CUDA-graph runner: the tracking step, poseframe
detection, the post-Delaunay section and the BA window solves replayed
from CUDA graphs. It needs only torch and _kernels, so it sits beside
them, below the kernel wrappers, core/, ba/ and parallel/ that call it.

pipeline.track_project_sync launches about 1,800 small kernels a frame,
poseframe detection (pipeline._detect_and_insert) about 730, the
post-Delaunay section (pipeline._post_delaunay_inner) about 690 around
its two hand-written kernels, and a BA window solve some thousands.
Every shape is fixed by the capacities or the window size and none
reads a device value on the host, so on a CUDA device each is
captured once as a CUDA graph and replayed on every later call: the
host then copies the call's inputs into the graph's own buffers (one
multi-tensor copy per dtype), fills its device scalars, replays and
copies the outputs out, instead of dispatching each kernel from Python.
A replay runs the captured kernels in their order, so its results are
the eager body's bit for bit (up to the order of atomic sums: index_add_
on the card, in the normals and the BA assembly).

The post-Delaunay section is cut into graphs at the calls made by name
(smoother_kernel.smooth, raster_kernel.rasterize), which stay calls
with their real inputs and outputs: kind "post" (topology, graph sync,
the triangle mask), "smooth" (inside smooth: the slot prologue, K1, the
write-back), "mesh" (vertex idepths, normals, filters) and "raster"
(inside rasterize: the triangle rows, K2, the crop). The section's
caller makes the stack's Steps current (active()); smooth and rasterize
replay only while a Steps is current, so every other call of theirs
runs eagerly.

The BA window solve (ba/window.py) replays as kind "ba", a graph per
window size. The observation-sharded solve (parallel/distributed_ba.py)
follows smooth's rule as kind "ba_sharded": it replays while a Steps is
current (BundleAdjuster makes the stack's current) and the mesh is not
over a process group.

A graph reads the frame stack, K and Kinv where they live (the stack is
written in place; copying it would move every poseframe each frame).
Steps holds the graphs of one stack, that is of one Flame, and is freed
with it. A graph is keyed on what the code can observe: the Params (or
BAParams) object, the device, shapes and dtypes of the copied inputs,
the other host values the body reads (static), and the storage
addresses (with shapes and dtypes) of the stack's tensors, K and Kinv;
a call under another Params object or storage drops the stack's graphs
of that kind and captures again, so no graph replays over freed
storage.

The capture step is a parameter: cuda_capture on the card;
eager_capture runs the body on the graph's buffers without a graph, so
that the CPU tests hold the plumbing (copies in, device scalars, owned
outputs, keys, counters) to the eager call.

A graph's outputs are cloned for the caller, so that a later replay
leaves them unchanged; an output that is one of the call's inputs comes
back as the caller's own tensor, as the eager body returns it (no body
writes an input in place). The hand-written kernels count their
launches (_kernels.LAUNCHES) once per call: the capture's own runs
leave the counts as they were, and each replay adds the launches its
graph holds.
"""

import contextlib
import dataclasses
import gc
import threading
import weakref
from typing import Callable, Dict, Optional

import torch

from flame_tpu_torch import _kernels

# StatsTracker counters per kind: graphs captured, replays, and calls run
# eagerly on a CUDA device (inside another capture).
COUNTERS = ("captures", "replays", "eager")
# The kinds: tracking, poseframe detection, the post-Delaunay section's
# four graphs, and the single and the sharded BA solve.
KINDS = ("track", "detect", "post", "smooth", "mesh", "raster", "ba",
         "ba_sharded")


def row(table: torch.Tensor, slot) -> torch.Tensor:
    """table[slot] for a Python int, or for a (1,) integer device index
    (a graph's device scalar) without reading it on the host."""
    if isinstance(slot, torch.Tensor):
        return table.index_select(0, slot)[0]
    return table[slot]


def full(n: int, value, dtype, device) -> torch.Tensor:
    """torch.full((n,), value) for a Python int, or for a (1,) device
    scalar."""
    if isinstance(value, torch.Tensor):
        return value.to(dtype).expand(n)
    return torch.full((n,), value, dtype=dtype, device=device)


def cuda_capture(fn: Callable):
    """fn() captured as one CUDA graph: a warm-up run on a side stream
    first, then the capture with the garbage collector off (a collection
    inside it would run a dropped Flame's CUDA destructors, which
    invalidate the capture). The Delaunay worker thread makes no CUDA
    calls; thread_local leaves other threads' calls unchecked all the
    same. Returns (outputs, replay)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    collecting = gc.isenabled()
    gc.disable()
    try:
        with torch.cuda.graph(graph, capture_error_mode="thread_local"):
            out = fn()
    finally:
        if collecting:
            gc.enable()
    return out, graph.replay


def eager_capture(fn: Callable):
    """The capture step without a graph: fn() runs once for the outputs,
    and each replay runs it again and writes its results over those
    outputs, as a graph's replay overwrites its own."""
    out = fn()
    leaves = _leaves(out)

    def replay():
        for dst, src in zip(leaves, _leaves(fn())):
            dst.copy_(src)
    return out, replay


def _leaves(x) -> list:
    """The tensors of a nest of tuples, NamedTuples and dataclasses."""
    if isinstance(x, torch.Tensor):
        return [x]
    if dataclasses.is_dataclass(x):
        x = [getattr(x, f.name) for f in dataclasses.fields(x)]
    if isinstance(x, (tuple, list)):
        return [t for v in x for t in _leaves(v)]
    return []


def copy_all(dsts, srcs) -> None:
    """dst.copy_(src) for each pair, as one multi-tensor copy per dtype
    and device (a launch each, where a copy_ apiece costs the host a
    dispatch per tensor)."""
    groups: Dict[tuple, tuple] = {}
    for d, s in zip(dsts, srcs):
        g = groups.setdefault((d.dtype, d.device, s.device), ([], []))
        g[0].append(d)
        g[1].append(s)
    for ds, ss in groups.values():
        torch._foreach_copy_(ds, ss)


def _rebuild(x, memo: dict):
    """x with every tensor replaced by memo[id(tensor)]."""
    if isinstance(x, torch.Tensor):
        return memo[id(x)]
    if dataclasses.is_dataclass(x):
        return type(x)(**{f.name: _rebuild(getattr(x, f.name), memo)
                          for f in dataclasses.fields(x)})
    if isinstance(x, tuple):
        items = [_rebuild(v, memo) for v in x]
        return type(x)(*items) if hasattr(x, "_fields") else tuple(items)
    return x


def _own(x, memo: dict):
    """x with every tensor not in memo (id -> the tensor to return)
    cloned once (a tensor that appears twice comes back as one clone),
    so that a later replay leaves it unchanged."""
    srcs = [t for t in _leaves(x) if id(t) not in memo]
    srcs = list({id(t): t for t in srcs}.values())
    dsts = [torch.empty_like(t) for t in srcs]
    copy_all(dsts, srcs)
    memo.update((id(s), d) for s, d in zip(srcs, dsts))
    return _rebuild(x, memo)


class _Graph:
    """body(ins, scalars) captured over buffers of its own: ins, clones of
    the first call's tensors, and scalars, (1,) int64 device tensors."""

    def __init__(self, body: Callable, tensors, scalars, capture: Callable):
        self.ins = [t.clone() for t in tensors]
        dev = self.ins[0].device
        self.scalars = [torch.full((1,), int(s), dtype=torch.int64,
                                   device=dev) for s in scalars]
        self.launches: Dict[str, int] = {}

        def counted():
            before = dict(_kernels.LAUNCHES)
            out = body(self.ins, self.scalars)
            self.launches = {k: n - before.get(k, 0)
                             for k, n in _kernels.LAUNCHES.items()
                             if n != before.get(k, 0)}
            _kernels.LAUNCHES.update(before)
            return out
        self.out, self._replay = capture(counted)

    def __call__(self, tensors, scalars):
        copy_all(self.ins, tensors)
        for dst, s in zip(self.scalars, scalars):
            dst.fill_(int(s))
        self._replay()
        for k, n in self.launches.items():
            _kernels.LAUNCHES[k] += n
        return _own(self.out, {id(b): t for b, t in zip(self.ins, tensors)})


class Steps:
    """The graphs of one frame stack, per kind, and their counters."""

    def __init__(self, capture: Callable):
        self.capture = capture
        # kind -> (Params, resident key, {shape key: _Graph})
        self._graphs: Dict[str, tuple] = {}
        self.counts: Dict[str, int] = {}

    def _count(self, kind: str, what: str) -> None:
        key = f"{kind}_graph_{what}"
        self.counts[key] = self.counts.get(key, 0) + 1

    def run(self, kind: str, body: Callable, tensors, scalars, params,
            resident, eager: Optional[Callable] = None, static=()):
        """body(ins, scalars) replayed from the graph of this key, which
        is captured first if there is none. tensors: copied into the
        graph's buffers; scalars: Python ints filled into its device
        scalars; params and the resident tensors (read in place) key the
        graph by identity, and by address, shape and dtype; static: the
        other host values the body reads (hashable), part of the key.
        eager(): the call itself (default: body on the call's own
        tensors and scalars), run while the current stream is already
        capturing (a graph cannot be captured inside another capture)."""
        dev = tensors[0].device
        if dev.type == "cuda" and torch.cuda.is_current_stream_capturing():
            self._count(kind, "eager")
            return eager() if eager is not None else body(tensors, scalars)
        res_key = (dev, tuple((t.data_ptr(), tuple(t.shape), t.dtype)
                              for t in resident))
        shape_key = (tuple((tuple(t.shape), t.dtype) for t in tensors),
                     static)
        held = self._graphs.get(kind)
        if held is None or held[0] is not params or held[1] != res_key:
            # Another Params object or storage: the old graphs hold other
            # constants or read freed memory, and go. The Params object is
            # held, so that no other one takes its place at its address.
            held = self._graphs[kind] = (params, res_key, {})
        g = held[2].get(shape_key)
        if g is None:
            g = held[2][shape_key] = _Graph(body, tensors, scalars,
                                            self.capture)
            self._count(kind, "captures")
        self._count(kind, "replays")
        return g(tensors, scalars)


# id(stack) -> Steps; an entry goes when its stack is collected.
_STEPS: Dict[int, Steps] = {}
# The Steps the running post-Delaunay section replays from, per thread.
_ACTIVE = threading.local()


@contextlib.contextmanager
def active(steps: Optional[Steps]):
    """Make `steps` current (None: the eager path) inside the block."""
    prev = getattr(_ACTIVE, "steps", None)
    _ACTIVE.steps = steps
    try:
        yield steps
    finally:
        _ACTIVE.steps = prev


def current() -> Optional[Steps]:
    """The Steps made current by active(), or None."""
    return getattr(_ACTIVE, "steps", None)


def attach(stack, capture: Callable = cuda_capture) -> Steps:
    """The Steps of this frame stack, made with `capture` if it has none
    (on a CPU stack only this call gives it one)."""
    key = id(stack)
    s = _STEPS.get(key)
    if s is None:
        s = _STEPS[key] = Steps(capture)
        weakref.finalize(stack, _STEPS.pop, key, None)
    return s


def steps_for(stack) -> Optional[Steps]:
    """The stack's Steps: a CUDA stack gets one at its first call; None
    for a stack elsewhere that attach() was not given (the eager path)."""
    s = _STEPS.get(id(stack))
    if s is None and stack.q.device.type == "cuda":
        s = attach(stack)
    return s


def counts(stack) -> Dict[str, int]:
    """The stack's counters (empty while it has no Steps)."""
    s = _STEPS.get(id(stack))
    return dict(s.counts) if s is not None else {}
