"""The program's span ac3.finish.wait (Transcoder.finish's rate check,
whose copy of the ok mask waits on the default stream behind the next
chunk's work), summed a chunk, median over the traced window's chunks,
in ms."""
from ._spans import step_ms


def read(ctx):
    return step_ms("finish.wait")
