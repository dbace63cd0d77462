"""The program's span ac3.enc.h2d (BatchedEncoder.dispatch_frames: the
staged PCM copied to the card), summed a chunk, median over the traced
window's chunks, in ms."""
from ._spans import step_ms


def read(ctx):
    return step_ms("enc.h2d")
