"""X1 (csrc/exponents.cu exponents_kernel: the exponents, their strategy
and coding) against its least time on the traced chunks: core.bounds.x1_ms
on each chunk's lane-frames and channels, over the profiler's time for
the kernel."""
from ..core import bounds
from ._enc import share, traced


def read(ctx):
    t = traced(ctx, "exponents_kernel")
    if t is None:
        return None
    return share(t.chunks * bounds.x1_ms(t.rows, t.cfg.channels), t)
