"""The program's span ac3.enc.run (BatchedEncoder.dispatch_frames:
encode_run, the frame core and the device pack enqueued), summed a chunk,
median over the traced window's chunks, in ms."""
from ._spans import step_ms


def read(ctx):
    return step_ms("enc.run")
