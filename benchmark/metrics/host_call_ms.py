"""The host time of the call into the program a chunk (feed +
decode_available, or Transcoder.dispatch_frames), with no synchronise:
the harness's span around it, median over the window's chunks."""
from ..core.runner import median


def read(ctx):
    m = median(ctx.spans.get("dispatch", []))
    return None if m is None else m * 1e3
