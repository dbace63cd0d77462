"""The program's counter enc_staged_bytes: the bytes the host writes to
stage a chunk's PCM for the copy (BatchedEncoder.dispatch_frames'
frame-major reorder; 0 where nothing is staged), summed a chunk, median
over the traced window's chunks, in MB (1e6 B)."""
from ..core.runner import median
from ._spans import counter


def read(ctx):
    per_step = counter("enc_staged_bytes")
    return median(list(per_step.values())) / 1e6 if per_step else None
