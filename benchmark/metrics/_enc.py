"""What the readers of the encode cell's kernels share: the traced run's
time for one kernel, beside what its least work is counted from (the
reference encoder's configuration, classes and strategies of the checked
chunk, core.bounds)."""
from typing import NamedTuple

from ..core.trace import kernel_time


class Traced(NamedTuple):
    cfg: object            # the reference's EncoderConfig
    bap: object            # [C, F, 6, nch, 256] classes of the checked chunk
    strat: object          # [C, F, 6, nch] exponent strategies
    rows: int              # lane-frames a chunk
    per_pair: float        # lanes a (stream, start) pair
    chunks: int            # chunks dispatched in the traced window
    launches: int
    seconds: float         # the profiler's time for the kernel


def traced(ctx, kernel: str):
    """-> Traced for `kernel`, or None without a trace, the reference's
    classes or a launch of the kernel."""
    if not ctx.trace or ctx.ref is None or "bap" not in ctx.ref:
        return None
    n, s = kernel_time(ctx.trace["kernels"], kernel)
    if n == 0 or s <= 0:
        return None
    lanes = ctx.lanes
    return Traced(ctx.ref["cfg"], ctx.ref["bap"], ctx.ref["strat"],
                  lanes.count * lanes.frames_per_chunk,
                  lanes.count / len(lanes.combos()), ctx.chunks_traced, n, s)


def share(least_ms: float, t: Traced) -> float:
    """The least time over the profiler's, in %."""
    return 100.0 * least_ms / (t.seconds * 1e3)
