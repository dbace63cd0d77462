"""The program's spans ac3.sideinfo_parse (the native side-info parse of
the raw path, with the pending frames joined to its output) and
ac3.dense_parse (the native dense parse), summed a chunk, median over the
traced window's chunks, in ms."""
from ._spans import step_ms


def read(ctx):
    return step_ms("sideinfo_parse", "dense_parse")
