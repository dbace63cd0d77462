#!/usr/bin/env python3
"""Compare two checkouts of the PyTorch/CUDA port's raw-H2D unpack on
one NVIDIA GPU.

    python3 tools/torch_gather_probe.py [ROOT]

For the checkout at ROOT (default: this one): the device-unpack stage of
one raw main-path chunk (4096 lanes x 16 frames) and one coupling chunk
(4096 lanes x 12 frames), two steps of each after a warm-up step
(StageClock), and the times of the largest bitfield gather calls of
those steps (K2's mantissa call, K3).  Run it on two checkouts in turns
(A, B, B, A) in one call to compare them on one card.  One JSON line per
path: stages in seconds, kernel times in ms (chip_smoke.cuda_ms, three
medians).
"""
from __future__ import annotations

import json
import os
import sys


def record(fn, BG, entries):
    """Run fn() with the gather entries recording (args, kwargs)."""
    calls = []
    orig = {e: getattr(BG, e) for e in entries}

    def wrap(e):
        def call(*a, **k):
            calls.append((e, a, k))
            return orig[e](*a, **k)
        return call

    for e in orig:
        setattr(BG, e, wrap(e))
    try:
        fn()
    finally:
        for e, f in orig.items():
            setattr(BG, e, f)
    return calls


def largest(calls, entry):
    return max(((a, k) for e, a, k in calls if e == entry),
               key=lambda ak: ak[0][1].numel())


def probe(root):
    sys.path.insert(0, root)
    os.chdir(root)
    import torch
    import chip_smoke as CS
    import ac3acm_tpu_torch as port
    from ac3acm_tpu_torch.ops import bitgather as BG
    from ac3acm_tpu_torch.parallel.pipeline import StageClock
    port.set_accuracy("fast")
    dev = torch.device("cuda")
    for path, gold, batch, nframes, rotate, timed in (
            ("main", CS.GOLDEN, CS.MAIN_BATCH, CS.RAW_CHUNK_FRAMES, True,
             "extract_fields"),
            ("coupling", CS.CPL_GOLDEN, CS.CPL_BATCH, CS.CPL_CHUNK_FRAMES,
             False, "extract_fields_shared")):
        streams = CS.lane_streams(batch, nframes * 2, gold, rotate)
        dec = CS.raw_decoder(streams)
        dec.decode_available(max_frames=nframes)
        del dec
        dec = CS.raw_decoder(streams)
        unpack = []
        for _ in range(2):
            clock = StageClock(dev)
            dec.decode_available(max_frames=nframes, clock=clock)
            unpack.append(clock.seconds["device unpack"])
            clock.kept.clear()
        del dec
        dec = CS.raw_decoder(streams)
        calls = record(lambda: dec.decode_available(max_frames=nframes), BG,
                       ("extract_fields", "extract_fields_shared"))
        del dec
        args, kw = largest(calls, timed)
        del calls
        fn = getattr(BG, timed)
        ms = [CS.cuda_ms(lambda: fn(*args, **kw)) for _ in range(3)]
        print(json.dumps({"root": root, "path": path,
                          "device_unpack_s": unpack, "entry": timed,
                          "shape": list(args[1].shape), "kernel_ms": ms}),
              flush=True)
        del args
        torch.cuda.empty_cache()


def main():
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("torch_gather_probe: no CUDA device")
    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    probe(os.path.abspath(sys.argv[1] if len(sys.argv) > 1 else here))


if __name__ == "__main__":
    main()
