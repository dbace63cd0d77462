"""The host time from a chunk's dispatch having returned (and the next
chunk's call made) to its output in host memory: the D2H copy of the PCM
on the copy stream, or Transcoder.finish; median over the window's
chunks."""
from ..core.runner import median


def read(ctx):
    m = median(ctx.spans.get("finish", []))
    return None if m is None else m * 1e3
