"""The encoder's frame core (M1 window_mdct_kernel, X1 exponents_kernel,
E1 snr_search_kernel, Q1 quantize_kernel) against its least time on the
traced chunks: the four kernels' least times summed (core.bounds; Q1's
from the reference encoder's classes of the checked chunk), over the
profiler's time for the four."""
from ..core import bounds
from ..core.trace import kernel_time

KERNELS = ("window_mdct_kernel", "exponents_kernel", "snr_search_kernel",
           "quantize_kernel")


def read(ctx):
    if not ctx.trace or ctx.ref is None or "bap" not in ctx.ref:
        return None
    n, s = kernel_time(ctx.trace["kernels"], *KERNELS)
    calls, _ = kernel_time(ctx.trace["kernels"], "snr_search_kernel")
    if n == 0 or s <= 0:
        return None
    cfg, lanes = ctx.ref["cfg"], ctx.lanes
    w = lanes.count / len(lanes.combos())
    rows = lanes.count * lanes.frames_per_chunk
    chunks = ctx.chunks_traced
    least = chunks * (bounds.m1_ms(rows, cfg.channels)
                      + bounds.x1_ms(rows, cfg.channels)
                      + bounds.q1_ms(ctx.ref["bap"]) * w) \
        + bounds.e1_ms(rows * chunks, cfg.nb_coefs, calls)
    return 100.0 * least / (s * 1e3)
