"""P1 (csrc/pack.cu pack_frames_kernel, the device packer) at the encode
cell's 6 channels and 2,560-byte frames, against its least time on the
traced chunks: core.bounds.p1_ms on the reference encoder's classes and
strategies of the checked chunk, every lane counted, over the profiler's
time for the kernel."""
from ..core import bounds
from ._enc import share, traced


def read(ctx):
    t = traced(ctx, "pack_frames_kernel")
    if t is None:
        return None
    least = bounds.p1_ms(t.cfg.nb_coefs, t.cfg.frame_size, t.bap, t.strat)
    return share(t.chunks * least * t.per_pair, t)
