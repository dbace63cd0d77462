"""P1 (csrc/pack.cu pack_frames_kernel, the device packer) against its
least time on the traced chunks: core.bounds.p1_ms on the reference
encoder's classes and strategies of the checked chunk, over the
profiler's time for the kernel."""
from ..core import bounds
from ..core.trace import kernel_time


def read(ctx):
    if not ctx.trace or ctx.ref is None or "bap" not in ctx.ref:
        return None
    n, s = kernel_time(ctx.trace["kernels"], "pack_frames_kernel")
    if n == 0 or s <= 0:
        return None
    cfg, lanes = ctx.ref["cfg"], ctx.lanes
    w = lanes.count / len(lanes.combos())
    least = bounds.p1_ms(cfg.nb_coefs, cfg.frame_size, ctx.ref["bap"],
                         ctx.ref["strat"]) * w
    return 100.0 * least * ctx.chunks_traced / (s * 1e3)
