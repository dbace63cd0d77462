"""Tracing and profiling (the reference's ACM message logfile,
AC3ACM_LOGFILE, and its gprof build flag).

``setup_logging`` / ``log_format_negotiation`` log negotiation and stream
events; ``profile`` traces a block of work with torch.profiler (host ops
and, on the card, every kernel by name) into a Chrome trace JSON, where
the JAX package writes an XPlane dump for TensorBoard.

Spans and counters.  The program marks its host work with ``span(name)``
at the boundaries where it happens (``feed``, ``sideinfo_parse``,
``chunk_assembly``, ``prune_plan``, ``h2d``, ``unpack.*``, ``tail``,
``encode``, ``finish.*``, ``enc.*``) and counts what it moves with
``count``.  A span records only while a torch.profiler is recording;
otherwise it costs one check of the profiler's state.  While one records,
each span is an ``ac3.<name>`` annotation on the profiler's timeline,
beside the card's kernels and copies, and ``(name, step, t0_ns, t1_ns)``
in memory (``spans()``; ``counters()``; ``reset()`` clears both).  The
spans of one chunk share its step: ``BatchedDecoder`` numbers its
``decode_available`` calls, ``BatchedEncoder`` its ``dispatch_frames``
calls.  No span encloses another, so each stretch of host time has one
name.  To see them::

    with profile("traces") as d:
        ...                                  # decode or transcode
    # open d/ac3tpu_<pid>_<ns>.pt.trace.json in Perfetto (ui.perfetto.dev)
"""
from __future__ import annotations

import contextlib
import logging
import os
import tempfile
import threading
import time

log = logging.getLogger("ac3acm_tpu_torch")

# torch's profiler-state check, bound at the first span (torch is not
# imported here: the native host library's users count without it)
_profiling = None
_OFF = contextlib.nullcontext()
_spans: list = []           # (name, step, t0_ns, t1_ns)
_counters: dict = {}        # name -> {step: total}
_count_lock = threading.Lock()
_step = None                # the step a span opened without one takes


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


class _Span:
    __slots__ = ("name", "step", "_rf", "_t0")

    def __init__(self, name: str, step):
        self.name, self.step = name, step

    def __enter__(self):
        import torch
        self._rf = torch.profiler.record_function("ac3." + self.name)
        self._rf.__enter__()
        self._t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        t1 = time.perf_counter_ns()
        self._rf.__exit__(*exc)
        _spans.append((self.name, self.step, self._t0, t1))
        return False


def span(name: str, step=None):
    """Context manager over one stretch of the program's host work.  With
    no profiler recording: a shared no-op context (``with ... as s`` gives
    None).  While one records: the ``ac3.<name>`` annotation and its
    (name, step, t0_ns, t1_ns) in memory (``with ... as s`` gives the
    span).  step None: the step set_step last set."""
    global _profiling
    if _profiling is None:
        import torch
        _profiling = torch._C._autograd._profiler_enabled
    if not _profiling():
        return _OFF
    return _Span(name, _step if step is None else step)


def set_step(step):
    """The step of the spans that follow, where they give none."""
    global _step
    _step = step


def count(name: str, n, step=None):
    """Adds n to the counter `name` of `step`.  It records whenever it is
    called: a count on the hot path is made only inside a live span."""
    with _count_lock:
        c = _counters.setdefault(name, {})
        c[step] = c.get(step, 0) + n


def spans() -> list:
    """The recorded spans, (name, step, t0_ns, t1_ns), in the order they
    ended."""
    return list(_spans)


def counters() -> dict:
    """{name: {step: total}}."""
    with _count_lock:
        return {k: dict(v) for k, v in _counters.items()}


def reset():
    """Clears the recorded spans and counters (the library loads' too)."""
    global _step
    _spans.clear()
    with _count_lock:
        _counters.clear()
    _step = None


@contextlib.contextmanager
def profile(trace_dir: str | None = None):
    """torch.profiler trace context (--enable-gprof analogue).

    with profile("traces") as d: decode(...)
    then open d/ac3tpu_<pid>_<ns>.pt.trace.json in Perfetto or
    chrome://tracing.  The directory defaults to $AC3TPU_TRACE_DIR, else
    ac3tpu_trace in the temporary directory.  Host (CPU) activity is
    always traced, the program's spans (``ac3.*``) among it; CUDA
    activity (each kernel's launch and run) when a card is present."""
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
