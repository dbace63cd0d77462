#!/usr/bin/env python3
"""Time build variants of the encoder kernels P1 (the frame packer) and X1
(the exponent stage) on one NVIDIA GPU.

    python3 tools/torch_pack_variants.py [PARENT_ROOT]

Each variant is this checkout's csrc/pack.cu or csrc/exponents.cu built
with the port's nvcc flags and one of the macros the source takes into
build/pack_variants/, and launched through the same C entry as the wrapper,
on real encoder fields at chip_smoke.py's configs 3 and 4 (16,384 frames of
2.0 at 192 kbit/s and of 5.1 at 640 kbit/s):

  P1 committed   csrc/pack.cu as it is (a frame a warp; 8 warps a CTA up
                 to two channels, 16 above; ptxas picks the registers)
  P1 warps8      8 warps a CTA for every channel count (-DP1_WARPS=8)
  P1 warps16     16 warps a CTA for every channel count
  P1 nocrc       the committed kernel with both CRCs left 0: not a packer
                 (its bytes are wrong), it shows what the CRCs cost
  P1 parent      PARENT_ROOT's csrc/pack.cu when a checkout of the first
                 design (a CTA a frame) is given, on that design's
                 table (parent_table)
  X1 committed   csrc/exponents.cu as it is (5 CTAs an SM up to 2
                 channels, 4 above)
  X1 parent      PARENT_ROOT's csrc/exponents.cu (same C entry), when a
                 parent checkout is given

P1 is also timed on a loud encode's fields (seeded full-scale white noise
at config 4's format, chip_smoke.py:phase_p1_loud's content), where most
live bins carry a class.

Prints each variant's registers and spills (ptxas), then its device time
(chip_smoke.py:device_ms, in turns: every variant, then again in reverse)
beside the bound (chip_smoke.py:p1_bound, x1_bound), and whether its
outputs equal the plain version's (every variant but nocrc must), and the
card's name and power limit.
"""
from __future__ import annotations

import ctypes as C
import os
import re
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as CS  # noqa: E402
from ac3acm_tpu_torch.models import encoder as PE  # noqa: E402
from ac3acm_tpu_torch.ops import _cuda  # noqa: E402
from ac3acm_tpu_torch.ops import exponents as EX  # noqa: E402
from ac3acm_tpu_torch.ops import pack_device as PD  # noqa: E402

CSRC = os.path.join(HERE, "ac3acm_tpu_torch", "csrc")
# each variant's source and nvcc defines
P1_VARIANTS = {"committed": [], "warps8": ["-DP1_WARPS=8"],
               "warps16": ["-DP1_WARPS=16"], "nocrc": ["-DP1_NO_CRC"]}
X1_VARIANTS = {"committed": []}


def _x1_bind(lib):
    """exponents_launch alone: a parent's X1 has no other entry in common."""
    p, i = C.c_void_p, C.c_int
    lib.exponents_launch.restype = i
    lib.exponents_launch.argtypes = [p, p, i, p, p, p, C.c_longlong, i, p]


def _p1_bind(lib):
    """pack_frames_launch alone: the first design has no other entry in
    common."""
    p, i = C.c_void_p, C.c_int
    lib.pack_frames_launch.restype = i
    lib.pack_frames_launch.argtypes = [p, p, p, p, p, p, p, i, i, p,
                                       C.c_longlong, i, p]


def parent_table(cfg):
    """The table of the first design's csrc/pack.cu (a CTA a frame): this
    table with each CRC's multipliers for its 128 (up to two channels) or
    256 threads, 256 entries a region, and the slots from index 840."""
    tab = PD.kernel_table(cfg).astype(np.int64)
    threads = 128 if cfg.channels <= 2 else 256
    total = cfg.frame_size * 2
    fs58 = (cfg.frame_size >> 1) + (cfg.frame_size >> 3)
    crc_inv = PD.pow_poly(PD.CRC16_POLY >> 1, 16 * fs58 - 16, PD.CRC16_POLY)
    out = np.zeros(840 + 6 * PD.MAX_SLOTS, np.int64)
    out[:PD._TAB_MULT1] = tab[:PD._TAB_MULT1]
    out[328:328 + threads] = PD._crc_multipliers(4, 2 * fs58, threads,
                                                 crc_inv)
    out[584:584 + threads] = PD._crc_multipliers(2 * fs58, total - 2,
                                                 threads, 1)
    out[840:] = tab[PD._TAB_SLOTS:]
    return torch.from_numpy(out.astype(np.int32)).cuda()


def build(src, name, defines, out_dir, bind):
    so = os.path.join(out_dir, f"lib{name}.so")
    r = subprocess.run([_cuda._nvcc(), *_cuda.NVCC_FLAGS, *defines, src,
                        "-o", so], capture_output=True, text=True, check=True)
    regs = sorted({int(x) for x in re.findall(r"Used (\d+) registers",
                                               r.stderr)})
    spills = sorted({int(x) for x in re.findall(r"(\d+) bytes spill stores",
                                                r.stderr)})
    lib = C.CDLL(so)
    bind(lib)
    return lib, regs, spills


def fields(label, B, F, nch, kbps, loud=False):
    """One encode of chip_smoke.py's content at that config on the card
    (loud: seeded full-scale white noise): the core's fields (P1_KEYS) and
    the frame core's MDCT output (coef, exp_samples), the first 16,384
    rows of each."""
    cfg = PE.make_config(48000, kbps * 1000, nch)
    pcm = (np.random.default_rng(18).integers(
        -32768, 32768, (B, F * 1536, nch), dtype=np.int16) if loud
        else CS.enc_bench_pcm(nch, F, B))
    x = torch.from_numpy(np.ascontiguousarray(
        pcm.reshape(B, F, 1536, nch).transpose(1, 0, 2, 3))).cuda()
    with CS.core_watch(record=True) as w:
        (_, _), res = PE.encode_pipeline_multi(cfg)(
            x, torch.zeros((B, nch, 256), dtype=torch.int32, device="cuda"),
            torch.full((B,), 40, dtype=torch.int32, device="cuda"))
    n = min(16384, B * F)
    coef, es, nb, lfe, got = w["x1_calls"][0]
    return cfg, [res[k].reshape((-1,) + tuple(res[k].shape[2:]))[:n]
                 .contiguous() for k in CS.P1_KEYS], (got[3][:n].clone(),
                                                      es[:n].contiguous(),
                                                      nb, lfe)


def time_p1(libs, cfg, args):
    n = args[0].shape[0]
    tabs = {k: parent_table(cfg) if k == "parent"
            else PD._kernel_table_on(cfg, args[0].device) for k in libs}
    fs58 = (cfg.frame_size >> 1) + (cfg.frame_size >> 3)
    want = PD.pack_frames_ref(cfg, *args)
    outs, times = {}, {k: [] for k in libs}
    for name in list(libs) + list(libs)[::-1]:
        out = torch.empty((n, cfg.frame_size * 2), dtype=torch.uint8,
                          device="cuda")

        def run(lib=libs[name], out=out, tab=tabs[name]):
            rc = lib.pack_frames_launch(
                *(a.data_ptr() for a in args), tab.data_ptr(),
                cfg.frame_size * 2, fs58, out.data_ptr(), n,
                cfg.channels, torch.cuda.current_stream().cuda_stream)
            assert rc == 0, rc

        times[name].append(CS.device_ms(run))
        outs[name] = out
    bound, by = CS.p1_bound(cfg, args[0], args[3])
    return {k: (times[k], torch.equal(outs[k], want)) for k in libs}, \
        bound, by


def time_x1(libs, call):
    coef, es, nb, lfe = call
    n, _, nch, _ = coef.shape
    want = EX.exponents_ref(coef.clone(), es, nb, lfe)
    outs, times = {}, {k: [] for k in libs}
    for name in list(libs) + list(libs)[::-1]:
        out = (torch.empty((n, 6, nch, 256), dtype=torch.int8,
                           device="cuda"),
               torch.empty((n, 6, nch), dtype=torch.int32, device="cuda"),
               torch.empty((n,), dtype=torch.int32, device="cuda"))

        def run(lib=libs[name], out=out):
            rc = lib.exponents_launch(
                coef.data_ptr(), es.data_ptr(), int(lfe),
                *(t.data_ptr() for t in out), n, nch,
                torch.cuda.current_stream().cuda_stream)
            assert rc == 0, rc

        times[name].append(CS.device_ms(run))
        outs[name] = out
    bound, by = CS.x1_bound(coef, nb, lfe)
    return {k: (times[k], all(torch.equal(a, b) for a, b in
                              zip(outs[k], want))) for k in libs}, bound, by


def main():
    CS.phase_card()
    out_dir = os.path.join(HERE, "build", "pack_variants")
    os.makedirs(out_dir, exist_ok=True)
    jobs = {("P1", k): (os.path.join(CSRC, "pack.cu"), f"pack_{k}", d,
                        PD._bind) for k, d in P1_VARIANTS.items()}
    jobs.update({("X1", k): (os.path.join(CSRC, "exponents.cu"),
                             f"exponents_{k}", d, _x1_bind)
                 for k, d in X1_VARIANTS.items()})
    if len(sys.argv) > 1:
        parent = os.path.join(sys.argv[1], "ac3acm_tpu_torch", "csrc")
        jobs["P1", "parent"] = (os.path.join(parent, "pack.cu"),
                                "pack_parent", [], _p1_bind)
        jobs["X1", "parent"] = (os.path.join(parent, "exponents.cu"),
                                "exponents_parent", [], _x1_bind)
    # every variant's nvcc at once
    with ThreadPoolExecutor(len(jobs)) as pool:
        built = dict(zip(jobs, pool.map(
            lambda j: build(j[0], j[1], j[2], out_dir, j[3]),
            jobs.values())))
    p1, x1 = {}, {}
    for (kernel, name), (lib, regs, spills) in built.items():
        (p1 if kernel == "P1" else x1)[name] = lib
        CS.log(f"{kernel} variant {name}: registers {regs}, spill stores "
               f"{spills}")
    for config, loud in [(c, False) for c in CS.ENC_MAIN] + [
            (CS.ENC_MAIN[1], True)]:
        cfg, args, call = fields(*config, loud=loud)
        runs = [("P1 loud" if loud else "P1", time_p1(p1, cfg, args))]
        if not loud:
            runs.append(("X1", time_x1(x1, call)))
        for kernel, got in runs:
            res, bound, by = got
            for name, (times, same) in res.items():
                CS.log(f"{config[0]} {kernel} [{args[0].shape[0]}, 6, "
                       f"{cfg.channels}, 256] {name}: "
                       f"{', '.join(f'{t:.4f}' for t in times)} ms (bound "
                       f"{bound:.4f}, {by}); == plain version {same}")
                assert same or name == "nocrc", (kernel, name)


if __name__ == "__main__":
    main()
