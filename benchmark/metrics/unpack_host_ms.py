"""The host time of the device unpack (ops/unpack_device.py:unpack_blocks,
whose eager ops the host enqueues one by one): the program's spans
ac3.unpack.exponents, ac3.unpack.alloc and ac3.unpack.mantissas, summed a
chunk, median over the traced window's chunks, in ms.  No synchronise:
unpack_ms is the StageClock's synchronized time of the same stage."""
from ._spans import step_ms


def read(ctx):
    return step_ms("unpack.exponents", "unpack.alloc", "unpack.mantissas")
