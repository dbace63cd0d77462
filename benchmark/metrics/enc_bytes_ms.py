"""The program's span ac3.enc.bytes (BatchedEncoder.finish: frame_bytes,
the frames' D2H and each lane's tobytes), summed a chunk, median over the
traced window's chunks, in ms."""
from ._spans import step_ms


def read(ctx):
    return step_ms("enc.bytes")
