"""The device unpack a chunk (ops/unpack_device.py with the K2 and K4
gathers): the program's StageClock stage "device unpack", median over
the chunks run with the clock."""
from ..core.runner import median


def read(ctx):
    m = median(ctx.stages.get("device unpack", []))
    return None if m is None else m * 1e3
