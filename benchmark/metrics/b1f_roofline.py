"""B1F (csrc/imdct_exact.cu fused_steady_exact_kernel, the decode tail:
the order-exact transform, the OLA chain and the int16) against its least
time on the traced chunks: each chunk's [lanes, 6F, planes, 256]
coefficients in as f32, its int16 PCM out, the carry in and out
(core.bounds.b1f_ms), over the profiler's time for the kernel."""
from ..core import bounds
from ..core.trace import kernel_time


def read(ctx):
    if not ctx.trace:
        return None
    n, s = kernel_time(ctx.trace["kernels"], "fused_steady_exact_kernel")
    if n == 0 or s <= 0:
        return None
    lanes = ctx.lanes
    least = bounds.b1f_ms(lanes.count, lanes.frames_per_chunk,
                          int(ctx.cell["config"]["decode"]["planes"]))
    return 100.0 * least * ctx.chunks_traced / (s * 1e3)
