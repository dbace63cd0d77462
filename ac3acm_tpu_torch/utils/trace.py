"""Tracing and profiling (the reference's ACM message logfile,
AC3ACM_LOGFILE, and its gprof build flag).

``setup_logging`` / ``log_format_negotiation`` log negotiation and stream
events; ``profile`` traces a block of work with torch.profiler (host ops
and, on the card, every kernel by name) into a Chrome trace JSON, where
the JAX package writes an XPlane dump for TensorBoard.
"""
from __future__ import annotations

import contextlib
import logging
import os
import tempfile
import time

log = logging.getLogger("ac3acm_tpu_torch")


def setup_logging(path: str | None = None, level=logging.INFO):
    """AC3ACM_LOGFILE analogue: structured log of negotiation/stream events."""
    handler = (logging.FileHandler(path) if path
               else logging.StreamHandler())
    handler.setFormatter(logging.Formatter(
        "%(asctime)s %(name)s %(levelname)s %(message)s"))
    log.addHandler(handler)
    log.setLevel(level)
    return log


def log_format_negotiation(direction: str, src, dst):
    log.info("format_suggest %s: %s -> %s", direction, src, dst)


@contextlib.contextmanager
def profile(trace_dir: str | None = None):
    """torch.profiler trace context (--enable-gprof analogue).

    with profile("traces") as d: decode(...)
    then open d/ac3tpu_<pid>_<ns>.pt.trace.json in Perfetto or
    chrome://tracing.  The directory defaults to $AC3TPU_TRACE_DIR, else
    ac3tpu_trace in the temporary directory.  Host (CPU) activity is
    always traced; CUDA activity (each kernel's launch and run) when a
    card is present."""
    import torch
    from torch.profiler import ProfilerActivity
    trace_dir = trace_dir or os.environ.get(
        "AC3TPU_TRACE_DIR", os.path.join(tempfile.gettempdir(),
                                         "ac3tpu_trace"))
    os.makedirs(trace_dir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=activities)
    prof.start()
    try:
        yield trace_dir
    finally:
        # written even when the traced block raises, as the JAX package's
        # stop_trace does
        prof.stop()
        prof.export_chrome_trace(os.path.join(
            trace_dir, f"ac3tpu_{os.getpid()}_{time.time_ns()}.pt.trace.json"))
