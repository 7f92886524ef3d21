"""Update's own host time (core/flame.py Flame.update): the host
milliseconds of the window's update spans not covered by any child
span, over its frames; what the idle gaps labelled bench.update were.
Each frame's update span counts once: a buffered frame run inside
another span has its own, which is a child there. The window is the
ctx.frames highest frame ids among the update spans recorded without the
profiler (harness/spans.py); None when it is not whole."""

from harness import spans


def read(ctx):
    w = spans.window(ctx)
    if w is None:
        return None
    return sum(w.self_ms(s) for s in w.named("update")) / ctx.frames
