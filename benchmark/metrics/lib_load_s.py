"""The program's counter lib_load_s: the seconds of each library's first
load in the process (the CUDA kernels' C-ABI libraries and the native host
library, their builds included), summed: the part of setup_s they take."""
from ._spans import counter


def read(ctx):
    loads = counter("lib_load_s")
    return sum(loads.values()) if loads else None
