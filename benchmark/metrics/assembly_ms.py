"""The program's spans ac3.chunk_assembly (the raw chunk's arrays from the
parse's) and ac3.prune_plan (the meta pruned, the plan probes, the bias),
summed a chunk, median over the traced window's chunks, in ms."""
from ._spans import step_ms


def read(ctx):
    return step_ms("chunk_assembly", "prune_plan")
