"""The raw path's host work a chunk: the program's StageClock stages
"host side-info parse", "chunk assembly" and "prune + plan probes",
summed, median over the chunks run with the clock."""
from ..core.runner import median

STAGES = ("host side-info parse", "chunk assembly", "prune + plan probes")


def read(ctx):
    if not ctx.stages or any(s not in ctx.stages for s in STAGES):
        return None
    sums = [sum(v) for v in zip(*(ctx.stages[s] for s in STAGES))]
    return median(sums) * 1e3
