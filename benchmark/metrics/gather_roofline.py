"""The device unpack's gathers (csrc/bitgather.cu: K2 extract_fields_kernel
and K4 extract_i16_kernel) against their least time on the traced chunks:
the chunk's frame bytes read once, every exponent group and mantissa word
the reference's parse reads moved at K2's least slot bytes, every dithered
bin's LFSR state at K4's (core.bounds.gather_ms), over the profiler's
time for both kernels."""
from ..core import bounds
from ..core.trace import kernel_time


def read(ctx):
    if not ctx.trace or ctx.ref is None:
        return None
    n, s = kernel_time(ctx.trace["kernels"], "extract_fields_kernel",
                       "extract_i16_kernel")
    if n == 0 or s <= 0:
        return None
    w = ctx.lanes.count / len(ctx.lanes.combos())      # lanes a pair
    least = bounds.gather_ms(int(ctx.ref["sizes"].sum() * w),
                             int(ctx.ref["fields"].sum() * w),
                             int(ctx.ref["draws"].sum() * w))
    return 100.0 * least * ctx.chunks_traced / (s * 1e3)
