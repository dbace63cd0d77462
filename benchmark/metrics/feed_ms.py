"""The program's span ac3.feed (BatchedDecoder.feed, one a lane a chunk:
the append to the lane's buffer), summed a chunk, median over the traced
window's chunks, in ms."""
from ._spans import step_ms


def read(ctx):
    return step_ms("feed")
