#!/usr/bin/env python3
"""Time design variants of the device frame packer P1 on one NVIDIA GPU.

    python3 tools/torch_pack_variants.py

Each variant is this checkout's csrc/pack.cu built with the port's nvcc
flags and one of the macros the source takes (P1_SM_THREADS, P1_NO_CRC)
into build/pack_variants/, and launched through the same C entry as the
wrapper, on real encoder fields at chip_smoke.py's configs 3 and 4 (16,384
frames of 2.0 at 192 kbit/s and of 5.1 at 640 kbit/s):

  committed   csrc/pack.cu as it is (sized for 1,536 threads an SM)
  free        no __launch_bounds__ (ptxas picks the registers)
  sm1024      sized for 1,024 threads an SM
  sm2048      sized for 2,048 threads an SM
  nocrc       the committed kernel with both CRCs left 0: not a packer (its
              bytes are wrong), it shows what the CRCs cost

Prints each variant's registers and spills (ptxas), then its device time
(chip_smoke.py:device_ms, in turns: every variant, then again in reverse)
beside the bound (chip_smoke.py:p1_bound), and whether its frames equal
pack_frames_ref's (every variant but nocrc must), and the card's name and
power limit.
"""
from __future__ import annotations

import ctypes as C
import os
import re
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as CS  # noqa: E402
from ac3acm_tpu_torch.models import encoder as PE  # noqa: E402
from ac3acm_tpu_torch.ops import _cuda  # noqa: E402
from ac3acm_tpu_torch.ops import pack_device as PD  # noqa: E402

# each variant's nvcc defines
VARIANTS = {"committed": [], "free": ["-DP1_SM_THREADS=0"],
            "sm1024": ["-DP1_SM_THREADS=1024"],
            "sm2048": ["-DP1_SM_THREADS=2048"], "nocrc": ["-DP1_NO_CRC"]}


def build(name, defines, out_dir):
    src = os.path.join(HERE, "ac3acm_tpu_torch", "csrc", "pack.cu")
    so = os.path.join(out_dir, f"libpack_{name}.so")
    r = subprocess.run([_cuda._nvcc(), *_cuda.NVCC_FLAGS, *defines, src,
                        "-o", so], capture_output=True, text=True, check=True)
    regs = sorted({int(x) for x in re.findall(r"Used (\d+) registers",
                                               r.stderr)})
    spills = sorted({int(x) for x in re.findall(r"(\d+) bytes spill stores",
                                                r.stderr)})
    lib = C.CDLL(so)
    PD._bind(lib)
    return lib, regs, spills


def fields(label, B, F, nch, kbps):
    """The core's fields of one encode of chip_smoke.py's content at that
    config, the first 16,384 frames, on the card."""
    cfg = PE.make_config(48000, kbps * 1000, nch)
    pcm = CS.enc_bench_pcm(nch, F, B)
    x = torch.from_numpy(np.ascontiguousarray(
        pcm.reshape(B, F, 1536, nch).transpose(1, 0, 2, 3))).cuda()
    (_, _), res = PE.encode_pipeline_multi(cfg)(
        x, torch.zeros((B, nch, 256), dtype=torch.int32, device="cuda"),
        torch.full((B,), 40, dtype=torch.int32, device="cuda"))
    n = min(16384, B * F)
    return cfg, [res[k].reshape((-1,) + tuple(res[k].shape[2:]))[:n]
                 .contiguous() for k in CS.P1_KEYS]


def main():
    CS.phase_card()
    out_dir = os.path.join(HERE, "build", "pack_variants")
    os.makedirs(out_dir, exist_ok=True)
    libs = {}
    for name, defines in VARIANTS.items():
        libs[name], regs, spills = build(name, defines, out_dir)
        CS.log(f"variant {name}: registers {regs}, spill stores {spills}")
    for config in CS.ENC_MAIN:
        cfg, args = fields(*config)
        n = args[0].shape[0]
        tab = PD._kernel_table_on(cfg, args[0].device)
        fs58 = (cfg.frame_size >> 1) + (cfg.frame_size >> 3)
        want = PD.pack_frames_ref(cfg, *args)
        outs, times = {}, {k: [] for k in libs}
        for name in list(libs) + list(libs)[::-1]:
            out = torch.empty((n, cfg.frame_size * 2), dtype=torch.uint8,
                              device="cuda")

            def run(lib=libs[name], out=out):
                rc = lib.pack_frames_launch(
                    *(a.data_ptr() for a in args), tab.data_ptr(),
                    cfg.frame_size * 2, fs58, out.data_ptr(), n,
                    cfg.channels, torch.cuda.current_stream().cuda_stream)
                assert rc == 0, rc

            times[name].append(CS.device_ms(run))
            outs[name] = out
        bound, by = CS.p1_bound(cfg, args[0], args[3])
        for name in libs:
            same = torch.equal(outs[name], want)
            CS.log(f"{config[0]} [{n}, 6, {cfg.channels}, 256] {name}: "
                   f"{', '.join(f'{t:.4f}' for t in times[name])} ms "
                   f"(bound {bound:.4f}, {by}); == pack_frames_ref {same}")
            assert same or name == "nocrc", name


if __name__ == "__main__":
    main()
