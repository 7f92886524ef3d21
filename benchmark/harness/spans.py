"""The program's spans, for the per-layer metrics that read them.

The port keeps its spans in a ring per StatsTracker
(flame_tpu_torch.utils.stats); stats.latest() returns the newest
tracker's ring, which outlives the Flame that the harness deletes before
its readers run. A reader's window is the ctx.frames highest frame ids
among the update spans recorded without the profiler: the measured
window's frames, since the traced slice follows the window under the
profiler. A frame's update span is the one its update() call opened, or,
for a buffered frame run by a later call or by a map read, the one
opened inside that span. The window is whole when every span the ring
dropped ended before the first of its frames' update spans began.
window() returns None for a program that records no spans (one without
stats.latest(), or an empty ring) and for a window that is not whole.
"""


def _ring():
    try:
        from flame_tpu_torch.utils import stats
    except ImportError:
        return None
    latest = getattr(stats, "latest", None)
    return None if latest is None else latest()


def entries(spans) -> dict:
    """Frame id -> the start (ns) of its first update span."""
    out = {}
    for s in spans:
        if s.name == "update" and s.frames:
            f = s.frames[0]
            if s.start_ns < out.get(f, s.start_ns + 1):
                out[f] = s.start_ns
    return out


class Window:
    """The spans that carry one of the frame ids `ids`."""

    def __init__(self, spans, ids):
        self.ids = ids
        self.spans = [s for s in spans if ids.intersection(s.frames)]
        self._kids = {}
        for s in spans:
            if s.parent >= 0:
                self._kids.setdefault(s.parent, []).append(s)

    def named(self, name: str) -> list:
        return [s for s in self.spans if s.name == name]

    def roots(self, name: str) -> list:
        return [s for s in self.named(name) if s.parent < 0]

    def self_ms(self, span) -> float:
        """Host milliseconds of span not covered by a child span."""
        covered, end = 0, span.start_ns
        for c in sorted(self._kids.get(span.seq, ()),
                        key=lambda c: c.start_ns):
            a, b = max(c.start_ns, end), min(c.end_ns, span.end_ns)
            if b > a:
                covered += b - a
                end = b
        return (span.end_ns - span.start_ns - covered) * 1e-6


def window(ctx):
    """The window of ctx.frames frames, or None (see the module)."""
    ring = _ring()
    n = int(ctx.frames)
    if ring is None or n <= 0 or not len(ring):
        return None
    spans = [s for s in ring.spans() if not s.profiled]
    entry = entries(spans)
    if len(entry) < n:
        return None
    ids = sorted(entry)[-n:]
    if ring.lost_end_ns >= min(entry[f] for f in ids):
        return None
    return Window(spans, set(ids))
