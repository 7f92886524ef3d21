"""Named timers and scalar stats (a small copy of flame_tpu/utils/stats.py).

tick/tock record host wall time in milliseconds. On a CUDA device,
timed(name) also records a pair of CUDA events around the block, so a
caller can read each stage's device-side time per frame
(device_times_ms); the events are resolved only when read. Every key is
stored with the tracker's prefix, as in the JAX package.
"""

import threading
import time
from contextlib import contextmanager
from typing import Dict, List

import torch


class StatsTracker:
    """Named timers (milliseconds) and scalar statistics, their keys
    prefixed with `prefix`; device: where timed() also records CUDA
    events."""

    def __init__(self, prefix: str = "", device=None):
        self._prefix = prefix
        self._lock = threading.Lock()
        self._tick_times: Dict[str, float] = {}
        self._timings: Dict[str, float] = {}
        self._stats: Dict[str, float] = {}
        self._cuda = device is not None and torch.device(device).type == "cuda"
        self._events: Dict[str, List] = {}

    def _key(self, name: str) -> str:
        return self._prefix + name

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

    @contextmanager
    def timed(self, name: str):
        ev = None
        if self._cuda:
            ev = (torch.cuda.Event(enable_timing=True),
                  torch.cuda.Event(enable_timing=True))
            ev[0].record()
        self.tick(name)
        try:
            yield
        finally:
            self.tock(name)
            if ev is not None:
                ev[1].record()
                with self._lock:
                    self._events.setdefault(self._key(name), []).append(ev)

    def device_times_ms(self) -> Dict[str, List[float]]:
        """Per-stage CUDA-event times of every timed() block so far
        (synchronizes the device)."""
        torch.cuda.synchronize()
        with self._lock:
            return {k: [a.elapsed_time(b) for a, b in v]
                    for k, v in self._events.items()}

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

    def snapshot(self) -> Dict[str, Dict[str, float]]:
        with self._lock:
            return {"timings_ms": dict(self._timings),
                    "stats": dict(self._stats)}

    def clear(self) -> None:
        """Forget every timer, statistic and recorded CUDA event."""
        with self._lock:
            self._tick_times.clear()
            self._timings.clear()
            self._stats.clear()
            self._events.clear()
