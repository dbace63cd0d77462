"""M1 (csrc/window_mdct.cu window_mdct_kernel: the window, normalize and
MDCT) against its least time on the traced chunks: core.bounds.m1_ms on
each chunk's lane-frames and channels, over the profiler's time for the
kernel."""
from ..core import bounds
from ._enc import share, traced


def read(ctx):
    t = traced(ctx, "window_mdct_kernel")
    if t is None:
        return None
    return share(t.chunks * bounds.m1_ms(t.rows, t.cfg.channels), t)
