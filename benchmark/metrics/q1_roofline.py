"""Q1 (csrc/quantize.cu quantize_kernel, the quantizer) against its least
time on the traced chunks: core.bounds.q1_ms on the reference encoder's
classes of the checked chunk, every lane counted, over the profiler's
time for the kernel."""
from ..core import bounds
from ._enc import share, traced


def read(ctx):
    t = traced(ctx, "quantize_kernel")
    if t is None:
        return None
    return share(t.chunks * bounds.q1_ms(t.bap) * t.per_pair, t)
