"""E1 (csrc/snr_search.cu snr_search_kernel: the masking curve, the SNR
offset search and the classes) against its least time on the traced
chunks: core.bounds.e1_ms on every lane-frame and the live bins of each
channel (the LFE's 7), once a launch for its tables, over the profiler's
time for the kernel."""
from ..core import bounds
from ._enc import share, traced


def read(ctx):
    t = traced(ctx, "snr_search_kernel")
    if t is None:
        return None
    return share(bounds.e1_ms(t.rows * t.chunks, t.cfg.nb_coefs, t.launches),
                 t)
