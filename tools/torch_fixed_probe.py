#!/usr/bin/env python3
"""Measure one checkout's fixed-point device decode on one NVIDIA GPU.

    python3 tools/torch_fixed_probe.py [ROOT] [FRAMES]

For the checkout at ROOT (default: this one): SampleDecoder("fixed") on
the card over FRAMES (default 512) frames of the golden 5.1 stream to
2.0 (after a 2-frame warm-up): x-realtime (host clock, the PCM back on
the host), the ATen operations a frame (a TorchDispatchMode over 32
frames, chip_smoke.py's OpClock) and the device busy share of 32 traced
frames (torch.profiler; chip_smoke.py's busy_share: the union of the
kernels' intervals over the trace's span).  Both helpers come from this
checkout's chip_smoke.py, whichever ROOT is measured.  Run it on
two checkouts in turns (A, B, B, A) in one call to compare them on one
card.  Prints one JSON line.
"""
from __future__ import annotations

import importlib.util
import json
import os
import subprocess
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(HERE, "tests", "golden", "bench_51_448.ac3")
FLAGS_51_TO_20 = 2 | 32                       # A52_STEREO | A52_ADJUST_LEVEL


def smoke():
    """This checkout's chip_smoke.py (its OpClock and busy_share), loaded
    by path so that ROOT's copy, if any, is not the one taken."""
    spec = importlib.util.spec_from_file_location(
        "probe_chip_smoke", os.path.join(HERE, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def main():
    root = os.path.abspath(sys.argv[1]) if len(sys.argv) > 1 else HERE
    nframes = int(sys.argv[2]) if len(sys.argv) > 2 else 512
    cs = smoke()
    sys.path.insert(0, root)
    import torch
    from torch.profiler import ProfilerActivity, profile
    from ac3acm_tpu_torch.host.native import SampleDecoder, _frames
    if not torch.cuda.is_available():
        raise SystemExit("torch_fixed_probe: no CUDA device")
    frames = list(_frames(open(GOLDEN, "rb").read()))

    def stream(n):
        return b"".join(frames[i % len(frames)] for i in range(n))

    dec = SampleDecoder("fixed")
    dec.decode_stream(stream(2), FLAGS_51_TO_20)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    pcm = dec.decode_stream(stream(nframes), FLAGS_51_TO_20)
    dt = time.perf_counter() - t0
    assert pcm.shape == (6 * nframes, 2, 256), pcm.shape

    clock = cs.OpClock()
    with clock.mode:
        dec.decode_stream(stream(32), FLAGS_51_TO_20)
    with tempfile.TemporaryDirectory() as tmp:
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            dec.decode_stream(stream(32), FLAGS_51_TO_20)
            torch.cuda.synchronize()
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        share, _, _, kernels = cs.busy_share(
            json.load(open(path))["traceEvents"])
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip().splitlines()[0]
    print(json.dumps({
        "root": root, "card": card, "frames": nframes,
        "x_realtime": nframes * 1536 / 48000.0 / dt, "seconds": dt,
        "aten_ops_per_frame": clock.n / 32,
        "busy_share_32_frames": share, "kernels_32_frames": kernels}),
        flush=True)


if __name__ == "__main__":
    main()
