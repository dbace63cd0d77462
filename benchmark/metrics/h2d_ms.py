"""The program's span ac3.h2d (a chunk's host arrays copied to the card),
summed a chunk, median over the traced window's chunks, in ms."""
from ._spans import step_ms


def read(ctx):
    return step_ms("h2d")
