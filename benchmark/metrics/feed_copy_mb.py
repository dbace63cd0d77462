"""The program's counter feed_copied_bytes: the bytes of the lane buffers
that BatchedDecoder.feed builds (each append copies the lane's whole
buffer), summed a chunk, median over the traced window's chunks, in MB
(1e6 B)."""
from ..core.runner import median
from ._spans import counter


def read(ctx):
    per_step = counter("feed_copied_bytes")
    return median(list(per_step.values())) / 1e6 if per_step else None
