"""The program's span ac3.enc.stage (BatchedEncoder.dispatch_frames: the
PCM turned frame-major on the host for the copy), summed a chunk, median
over the traced window's chunks, in ms."""
from ._spans import step_ms


def read(ctx):
    return step_ms("enc.stage")
