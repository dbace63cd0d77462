"""The program's span ac3.enc.wait (BatchedEncoder.finish: the rate check,
whose copy of the ok mask waits for the card), summed a chunk, median
over the traced window's chunks, in ms."""
from ._spans import step_ms


def read(ctx):
    return step_ms("enc.wait")
