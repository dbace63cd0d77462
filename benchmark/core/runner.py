"""One run of one cell: set-up, warm-up, the timed window, the check.

The window opens when the first timed chunk is dispatched and closes at
the end of the first chunk that completes after ``seconds``: x-realtime is
the audio of every lane of the chunks it completed over its wall time.
Chunk k+1 is dispatched before chunk k is finished; the chunk in flight
when the window closes is drained after it and not counted.  A traced run
(``trace``) runs the same window under the profiler, then a few chunks
with the program's StageClock (raw parser), and reports the per-layer
metrics instead of the end-to-end ones.
"""
from __future__ import annotations

import gc
import importlib
import statistics
import time
from dataclasses import dataclass, field

import torch

from . import guard
from .content import make_lanes, seeded


@dataclass
class Context:
    """What the per-layer metric readers read (benchmark/metrics)."""
    cell: dict
    lanes: object
    spans: dict = field(default_factory=dict)     # name -> [s] a chunk
    stages: dict = field(default_factory=dict)    # StageClock -> [s]
    trace: dict = None                            # core.trace.reduce()
    chunks_traced: int = 0
    window_peak_bytes: int = 0
    ref: dict = None                              # paths.<entry>.reference()


def _record(name):
    return torch.profiler.record_function("bench." + name)


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run_cell(cell: dict, seed: int, seconds: float, trace: bool,
             device="cuda:0", t_start_process: float | None = None,
             accuracy: str | None = None, hook=None):
    """-> (result dict without "device", check {name: (value, limit)},
    Context).  accuracy: the program's decode accuracy mode (None: the
    configuration's); hook(path): called on the path before warm-up (the
    tests plant faults there)."""
    t0 = time.perf_counter() if t_start_process is None else t_start_process
    device = torch.device(device)
    config, traffic = cell["config"], cell["traffic"]
    import ac3acm_tpu_torch
    ac3acm_tpu_torch.set_accuracy(accuracy or config["decode"]["accuracy"])
    lanes = make_lanes(traffic, seed)
    mod = importlib.import_module(f"benchmark.paths.{config['entry']}")
    path = mod.Path(cell, lanes, device)
    if hook is not None:
        hook(path)
    for _ in range(int(traffic["warm_chunks"])):
        path.finish(path.dispatch())
    _sync(device)
    peak = 0
    if device.type == "cuda":
        peak = torch.cuda.max_memory_allocated(device)
        torch.cuda.reset_peak_memory_stats(device)
    setup_s = time.perf_counter() - t0

    ctx = Context(cell=cell, lanes=lanes)
    # the chunk kept for the check: the first to complete after a share of
    # the window drawn from the seed
    share = float(seeded(seed, 7).random())
    prof = None
    if trace:
        from .trace import Profiler
        prof = Profiler()
        prof.start()
    k_next = path.k
    dispatch_s, finish_s = [], []
    win = _record("window")
    win.__enter__()
    t_open = time.perf_counter()

    def dispatch():
        nonlocal k_next
        t = time.perf_counter()
        with _record("dispatch"):
            h = path.dispatch()
        dispatch_s.append(time.perf_counter() - t)
        k_next += 1
        return k_next - 1, h

    k, h = dispatch()
    done, invalid, kept = 0, 0, None
    while True:
        nxt = dispatch()
        t = time.perf_counter()
        with _record("finish"):
            out, valid = path.finish(h)
        t_done = time.perf_counter()
        finish_s.append(t_done - t)
        done += 1
        invalid += int((~valid).sum())
        if kept is None and t_done - t_open >= share * seconds:
            kept = (k, path.keep(out))
        if t_done - t_open >= seconds:
            break
        k, h = nxt
    t_close = t_done
    with _record("finish"):
        path.finish(nxt[1])
    _sync(device)
    win.__exit__(None, None, None)
    if prof is not None:
        prof.stop()
    found = guard.forbidden_loaded()
    if found:
        raise RuntimeError(f"modules loaded in the run: {found}")
    if device.type == "cuda":
        ctx.window_peak_bytes = torch.cuda.max_memory_allocated(device)
        peak = max(peak, ctx.window_peak_bytes)
    ctx.spans = dict(dispatch=dispatch_s, finish=finish_s)
    ctx.chunks_traced = len(dispatch_s)
    if prof is not None:
        from .trace import reduce
        ctx.trace = reduce(prof.events())
        del prof
        if traffic["parser"] == "raw":
            ctx.stages = _stage_chunks(path, device,
                                       int(traffic["stage_chunks"]))
    window_s = t_close - t_open
    audio = done * lanes.audio_seconds_per_chunk()
    del path, out, h, nxt
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()

    # the check, on the host, after the program's state is freed
    kk, got = kept
    ctx.ref = mod.reference(lanes, config, kk)
    numbers = mod.compare(lanes, config, ctx.ref, got)
    numbers["invalid_frames"] = (invalid, 0)
    correct = all(v <= lim for v, lim in numbers.values())
    result = dict(correct=bool(correct),
                  attempted=done * lanes.count * lanes.frames_per_chunk,
                  failed=invalid, xrt=audio / window_s, setup_s=setup_s,
                  window_s=window_s, chunks=done, peak=peak,
                  checked_chunk=kk, dispatch_s=dispatch_s,
                  finish_s=finish_s)
    return result, numbers, ctx


def _stage_chunks(path, device, n):
    """n chunks through the program's StageClock, started when
    decode_available is entered (it synchronizes between stages, so these
    run after the window): -> {stage: [s a chunk]}."""
    from ac3acm_tpu_torch.parallel.pipeline import StageClock
    bd = path.decoder()
    orig = bd.decode_available
    clocks = []

    def call(max_frames=8, clock=None):
        clocks.append(StageClock(device))
        return orig(max_frames, clock=clocks[-1])
    bd.decode_available = call
    try:
        for _ in range(n):
            path.finish(path.dispatch())
    finally:
        del bd.decode_available
    _sync(device)
    out = {}
    for clock in clocks:
        for name, s in clock.seconds.items():
            out.setdefault(name, []).append(s)
    return out


def median(xs):
    return statistics.median(xs) if xs else None
