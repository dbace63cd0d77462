#!/usr/bin/env python3
"""Count the PyTorch operations of one single-stream block_pipeline call.

    python3 tools/torch_block_ops.py          (from the repository root)

Runs on the CPU.  The golden 5.1 stream's first frames go through the
port's Python parser, then one block_pipeline call (reference mode, 5.1
-> stereo) over 1, 2 and 4 frames, under torch.profiler.  Each count is
the number of top-level aten operations of the call, with the order-exact
transform (B1, one kernel launch on the card) stubbed to a single
operation, so the counts are what the card runs besides B1: a fixed
share a call plus a share a frame (after one warm-up call, which fills
the per-device table caches).  Prints one line per frame count and
the two shares.
"""
from __future__ import annotations

import os
import sys

import torch
from torch.profiler import profile

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(HERE, "tests", "golden", "bench_51_448.ac3")
FLAGS_51_TO_20 = 2 | 32                       # A52_STEREO | A52_ADJUST_LEVEL


def main():
    sys.path.insert(0, HERE)
    from ac3acm_tpu_torch.host.parse import A52Parser, syncinfo
    from ac3acm_tpu_torch.models import decoder as PD
    es = open(GOLDEN, "rb").read()
    parser, frames, pos = A52Parser(), [], 0
    while len(frames) < 4:
        size = syncinfo(es[pos:pos + 7])[0]
        frames.append(parser.decode_frame(es[pos:pos + size],
                                          FLAGS_51_TO_20, 1.0, 0.0))
        pos += size
    fmt = PD.frame_format(frames[0])
    PD.split_fb_exact = lambda x, blksw=None: (
        torch.zeros_like(x), x.new_zeros(x.shape[:-1] + (128,)))
    counts = {}
    PD.block_pipeline(fmt, exact=True)(PD.init_carry(device="cpu"),
                                       PD._stack_blocks(frames[:1]))
    for n in (1, 2, 4):
        carry = PD.init_carry(device="cpu")
        with profile() as prof:
            PD.block_pipeline(fmt, exact=True)(
                carry, PD._stack_blocks(frames[:n]))
        counts[n] = sum(1 for e in prof.events()
                        if e.name.startswith("aten::") and e.cpu_parent is None)
        print(f"{n} frame(s) in one call: {counts[n]} top-level aten "
              f"operations (B1 stubbed)")
    per_frame = (counts[4] - counts[1]) / 3
    print(f"a call: {counts[1] - per_frame:.0f} operations of its own, "
          f"{per_frame:.0f} a frame")


if __name__ == "__main__":
    main()
