"""Named timers, scalar stats and frame-tagged spans (flame_tpu/utils/
stats.py, plus the spans).

A span is one host interval (time.perf_counter_ns) on the thread that
ran it. timed(name) and span(name) open one; it nests under the
thread's innermost open span and carries frame ids and a poseframe flag,
given or inherited from that parent. Finished spans go into a
fixed-capacity ring per tracker (SPAN_CAPACITY, oldest dropped first);
latest() returns the ring of the newest tracker in the process, which
outlives the tracker's owner. While a torch profiler records, each span
also enters record_function("flame." + key), so that the profiler's
trace holds it on the clock of the device's kernels and copies; with no
profiler recording, record_function is never entered.

timed() also keeps each key's last host milliseconds (timings()) and on
a CUDA device records a pair of CUDA events around the block, kept per
stage (EVENT_CAPACITY pairs, oldest dropped) and resolved when read
(device_times_ms). span() keeps a last value only under the timings key
it is given. That value, and elapsed_ms(), count a span's own time: from
its start, or from the end of the last span of its name directly inside
it. tick/tock record host wall time in milliseconds, as in the
JAX package. Every key is stored with the tracker's prefix.
"""

import itertools
import threading
import time
from collections import deque
from typing import Deque, Dict, List, NamedTuple, Optional

import torch
from torch.autograd import profiler as _autograd_profiler

# Spans kept per tracker. The benchmark's busiest cell records about 12
# spans a frame; a run holds at most 48 warm-up frames, a 45-s window at
# 240 frames/s and 24 traced frames: 16 spans x 10,872 frames = 174k.
SPAN_CAPACITY = 1 << 18
# CUDA-event pairs kept per stage (about 11k frames a run, one pair each).
EVENT_CAPACITY = 1 << 16

_latest = None


def latest() -> Optional["SpanRing"]:
    """The span ring of the newest StatsTracker in the process (None
    before the first)."""
    return _latest


def _profiling() -> bool:
    """Whether a torch profiler records (the flag torch keeps for cheap
    checks)."""
    return _autograd_profiler._is_profiler_enabled


class Span(NamedTuple):
    """A finished span."""
    name: str  # the tracker's key: prefix + name
    start_ns: int
    end_ns: int
    thread: int  # threading.get_ident() of the thread that ran it
    seq: int  # unique, increasing in the order spans open
    parent: int  # seq of the enclosing span on that thread; -1: a root
    frames: tuple  # frame ids
    poseframe: Optional[bool]
    link: int  # seq of the span that caused it elsewhere; -1: none
    profiled: bool  # recorded while a torch profiler recorded

    @property
    def ms(self) -> float:
        return (self.end_ns - self.start_ns) * 1e-6


class SpanRing:
    """The finished spans of one tracker, in the order they ended, at
    most `capacity` (the oldest dropped first)."""

    def __init__(self, capacity: int):
        self.capacity = int(capacity)
        self._ring: Deque[tuple] = deque(maxlen=self.capacity)

    def _add(self, rec: tuple) -> None:
        self._ring.append(rec)  # atomic: no lock

    def spans(self) -> List[Span]:
        return [Span._make(r) for r in self._ring.copy()]

    @property
    def lost_end_ns(self) -> int:
        """An end no later than which every dropped span ended (-1 while
        the ring is not full): an interval that starts after it is whole
        in the ring."""
        ring = self._ring
        return ring[0][2] if len(ring) == self.capacity else -1

    def clear(self) -> None:
        self._ring.clear()

    def __len__(self) -> int:
        return len(self._ring)


class _OpenSpan:
    """A span while it is open: the context manager timed() and span()
    return. Its frames and poseframe may be set while it is open; spans
    opened inside it afterwards inherit the new values."""

    __slots__ = ("_tr", "key", "timing", "frames", "poseframe", "link",
                 "seq", "parent", "start_ns", "mark_ns", "_ev", "_rf",
                 "_stack", "_tid")

    def __init__(self, tr, key, timing, frames, poseframe, link, ev):
        self._tr = tr
        self.key = key
        self.timing = timing
        self.frames = frames
        self.poseframe = poseframe
        self.link = link
        self._ev = ev

    def __enter__(self):
        tr = self._tr
        stack, self._tid = tr._thread_stack()
        if stack:
            top = stack[-1]
            self.parent = top.seq
            if self.frames is None:
                self.frames = top.frames
            if self.poseframe is None:
                self.poseframe = top.poseframe
        else:
            self.parent = -1
            if self.frames is None:
                self.frames = ()
        self.seq = next(tr._seq)
        self._stack = stack
        if self._ev is not None:
            self._ev[0].record()
        self._rf = None
        if _profiling():
            self._rf = _autograd_profiler.record_function("flame." + self.key)
            self._rf.__enter__()
        stack.append(self)
        self.start_ns = self.mark_ns = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        end = time.perf_counter_ns()
        stack = self._stack
        if stack and stack[-1] is self:
            stack.pop()
        elif self in stack:
            stack.remove(self)
        if stack and stack[-1].key == self.key:
            # A span of the same name directly inside another (a buffered
            # frame's update run inside the next frame's): the outer one's
            # own time restarts here.
            stack[-1].mark_ns = end
        if self._rf is not None:
            self._rf.__exit__(None, None, None)
        tr = self._tr
        if self._ev is not None:
            self._ev[1].record()
            tr._add_events(self.key, self._ev)
        if self.timing is not None:  # one dict store: atomic
            tr._timings[self.timing] = (end - self.mark_ns) * 1e-6
        tr._ring._add((self.key, self.start_ns, end, self._tid, self.seq,
                       self.parent, self.frames, self.poseframe, self.link,
                       self._rf is not None))
        return False


class StatsTracker:
    """Named timers (milliseconds), scalar statistics and spans, their
    keys prefixed with `prefix`; device: where timed() also records CUDA
    events."""

    def __init__(self, prefix: str = "", device=None):
        global _latest
        self._prefix = prefix
        self._lock = threading.Lock()
        self._tick_times: Dict[str, float] = {}
        self._timings: Dict[str, float] = {}
        self._stats: Dict[str, float] = {}
        self._cuda = device is not None and torch.device(device).type == "cuda"
        # Per stage: resolved milliseconds (float) or a pair of CUDA
        # events not yet read, oldest first.
        self._events: Dict[str, Deque] = {}
        self._ring = SpanRing(SPAN_CAPACITY)
        self._seq = itertools.count()
        self._local = threading.local()
        _latest = self._ring

    def _key(self, name: str) -> str:
        return self._prefix + name

    # --- Spans. ---

    def _thread_stack(self):
        """This thread's open spans (innermost last) and its ident."""
        try:
            return self._local.st
        except AttributeError:
            self._local.st = ([], threading.get_ident())
            return self._local.st

    def span(self, name: str, *, frames=None, poseframe=None, link: int = -1,
             timing: Optional[str] = None) -> _OpenSpan:
        """A host span (no CUDA events). frames (a tuple of frame ids) and
        poseframe default to the enclosing span's; link: the seq of the
        span that caused this one on another thread; timing: the
        timings() key that keeps its last milliseconds (none by
        default)."""
        return _OpenSpan(self, self._key(name),
                         None if timing is None else self._key(timing),
                         frames, poseframe, link, None)

    @property
    def spans(self) -> SpanRing:
        return self._ring

    def current(self) -> int:
        """The seq of this thread's innermost open span (-1: none)."""
        stack = self._thread_stack()[0]
        return stack[-1].seq if stack else -1

    def next_seq(self) -> int:
        """A seq above every span opened so far."""
        return next(self._seq)

    def elapsed_ms(self, name: str) -> float:
        """Host milliseconds of this thread's innermost open span `name`
        so far, since it began or since the last span of that name
        directly inside it ended (0 when none is open); timings() keeps
        the same measure when the span ends."""
        key = self._key(name)
        for sp in reversed(self._thread_stack()[0]):
            if sp.key == key:
                return (time.perf_counter_ns() - sp.mark_ns) * 1e-6
        return 0.0

    def record(self, name: str, start_ns: int, end_ns: int,
               frames: tuple = (), link: int = -1) -> None:
        """A finished interval measured elsewhere (an asynchronous copy):
        a root span on this thread, linked to `link`."""
        self._ring._add((self._key(name), int(start_ns), int(end_ns),
                         threading.get_ident(), next(self._seq), -1,
                         tuple(frames), None, link, _profiling()))

    # --- Timers. ---

    def tick(self, name: str) -> None:
        with self._lock:
            self._tick_times[self._key(name)] = time.perf_counter()

    def tock(self, name: str) -> float:
        """Stop a timer; returns and records elapsed milliseconds."""
        now = time.perf_counter()
        key = self._key(name)
        with self._lock:
            start = self._tick_times.get(key)
            if start is None:
                return 0.0
            ms = (now - start) * 1000.0
            self._timings[key] = ms
            return ms

    def timings(self, name: str) -> float:
        """The last elapsed milliseconds of a timer (0 before its first
        tock)."""
        with self._lock:
            return self._timings.get(self._key(name), 0.0)

    def timed(self, name: str) -> _OpenSpan:
        """A span that keeps its last milliseconds under `name` and, on
        a CUDA device, records CUDA events around the block; its frame
        ids and poseframe flag are the enclosing span's."""
        ev = None
        if self._cuda:
            ev = (torch.cuda.Event(enable_timing=True),
                  torch.cuda.Event(enable_timing=True))
        key = self._key(name)
        return _OpenSpan(self, key, key, None, None, -1, ev)

    def _add_events(self, key: str, ev) -> None:
        with self._lock:
            q = self._events.get(key)
            if q is None:
                q = self._events[key] = deque(maxlen=EVENT_CAPACITY)
            q.append(ev)

    def device_times_ms(self) -> Dict[str, List[float]]:
        """Per-stage CUDA-event times of every timed() block so far, in
        order, up to EVENT_CAPACITY a stage (synchronizes the device)."""
        torch.cuda.synchronize()
        with self._lock:
            out = {}
            for k, q in self._events.items():
                ms = [v if isinstance(v, float) else v[0].elapsed_time(v[1])
                      for v in q]
                q.clear()
                q.extend(ms)
                out[k] = ms
            return out

    # --- Scalar stats. ---

    def set(self, name: str, value: float) -> None:
        with self._lock:
            self._stats[self._key(name)] = float(value)

    def add(self, name: str, value: float) -> None:
        key = self._key(name)
        with self._lock:
            self._stats[key] = self._stats.get(key, 0.0) + float(value)

    def stats(self, name: str) -> float:
        with self._lock:
            return self._stats.get(self._key(name), 0.0)

    def ema(self, name: str, value: float, alpha: float = 0.01) -> float:
        key = self._key(name)
        with self._lock:
            old = self._stats.get(key)
            new = float(value) if old is None \
                else (1 - alpha) * old + alpha * float(value)
            self._stats[key] = new
            return new

    # --- Export. ---

    def snapshot(self) -> Dict[str, Dict[str, float]]:
        with self._lock:
            return {"timings_ms": dict(self._timings),
                    "stats": dict(self._stats)}

    def clear(self) -> None:
        """Forget every timer, statistic, span and recorded CUDA event."""
        with self._lock:
            self._tick_times.clear()
            self._timings.clear()
            self._stats.clear()
            self._events.clear()
        self._ring.clear()
