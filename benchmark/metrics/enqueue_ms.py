"""The host time of enqueuing the decode tail and the encoder: the program's
spans ac3.tail (B1F or K1, the steady body or the block scan, the int16)
and ac3.encode (Transcoder.dispatch_frames' encoder input and frame
core), summed a chunk, median over the traced window's chunks, in ms."""
from ._spans import step_ms


def read(ctx):
    return step_ms("tail", "encode")
