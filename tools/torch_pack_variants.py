#!/usr/bin/env python3
"""Time build variants of the encoder kernels P1 (the frame packer), X1
(the exponent stage) and Q1 (the quantizer) on one NVIDIA GPU.

    python3 tools/torch_pack_variants.py [PARENT_ROOT]

Each variant is this checkout's csrc/pack.cu, csrc/exponents.cu or
csrc/quantize.cu built with the port's nvcc flags and one of the macros
the source takes into build/pack_variants/, and launched through the same
C entry as the wrapper, on real encoder fields at chip_smoke.py's configs
3 and 4 (16,384 frames of 2.0 at 192 kbit/s and of 5.1 at 640 kbit/s):

  P1 committed   csrc/pack.cu as it is (a frame a warp; 8 warps a CTA up
                 to two channels, 16 above; ptxas picks the registers),
                 given int16 codes (the device-pack path's form) and the
                 same codes as int32 (JAX's calling form)
  P1 warps8      8 warps a CTA for every channel count (-DP1_WARPS=8)
  P1 warps16     16 warps a CTA for every channel count
  P1 nocrc       the committed kernel with both CRCs left 0: not a packer
                 (its bytes are wrong), it shows what the CRCs cost
  P1 parent      PARENT_ROOT's csrc/pack.cu, int32 codes: on its own table
                 layout where it reports one (pack_frames_layout, the warp
                 design), else on the first design's (a CTA a frame,
                 parent_table)
  X1 committed   csrc/exponents.cu as it is (5 CTAs an SM up to 2
                 channels, 4 above)
  X1 parent      PARENT_ROOT's csrc/exponents.cu (same C entry), when a
                 parent checkout is given
  Q1 committed   csrc/quantize.cu as it is (16 bins a thread, the next
                 pass's class loads in flight, the coded quads shared out
                 across the warp, their loads a pass ahead), int16 and
                 int32 codes
  Q1 parent      PARENT_ROOT's csrc/quantize.cu, int32 codes (the first
                 design: 4 bins a thread, a 4-byte class load, then a
                 branch), when a parent checkout is given

P1's other variants take int16 codes; every Q1 variant but the parent
runs in both widths.  P1 is also timed on a loud encode's fields (seeded
full-scale white noise at config 4's format, chip_smoke.py:phase_p1_loud's
content), where most live bins carry a class.  Q1 runs on the core call's own
inputs (its coefficients as X1 left them, its exponents and classes).

Prints each variant's registers and spills (ptxas), then its device time
(chip_smoke.py:device_ms, in turns: every variant, then again in reverse)
beside the bound (chip_smoke.py:p1_bound, x1_bound, q1_bound), and
whether its outputs equal the plain version's (every variant but nocrc
must), and the card's name and power limit.
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
from ac3acm_tpu_torch.ops import quantize as QZ  # noqa: E402

CSRC = os.path.join(HERE, "ac3acm_tpu_torch", "csrc")
# each variant's source and nvcc defines
P1_VARIANTS = {"committed": [], "warps8": ["-DP1_WARPS=8"],
               "warps16": ["-DP1_WARPS=16"], "nocrc": ["-DP1_NO_CRC"]}
X1_VARIANTS = {"committed": []}
Q1_VARIANTS = {"committed": []}


def _x1_bind(lib):
    """exponents_launch alone: a parent's X1 has no other entry in common."""
    p, i = C.c_void_p, C.c_int
    lib.exponents_launch.restype = i
    lib.exponents_launch.argtypes = [p, p, i, p, p, p, C.c_longlong, i, p]


def _p1_bind(lib):
    """A parent's pack_frames_launch, before it took a code width (int32
    codes only)."""
    p, i = C.c_void_p, C.c_int
    lib.pack_frames_launch.restype = i
    lib.pack_frames_launch.argtypes = [p, p, p, p, p, p, p, i, i, p,
                                       C.c_longlong, i, p]


def _q1_parent_bind(lib):
    """A parent's quantize_launch, before it took a code width (int32
    codes only)."""
    p, i = C.c_void_p, C.c_int
    lib.quantize_launch.restype = i
    lib.quantize_launch.argtypes = [p, p, i, p, p, p, C.c_longlong, i, p]


def parent_has_layout(lib):
    """Whether a parent's pack.cu reads this table layout (the warp
    design reports it through pack_frames_layout; the first design has
    none)."""
    try:
        fn = lib.pack_frames_layout
    except AttributeError:
        return False
    fn.restype, fn.argtypes = C.c_int, [C.c_void_p]
    layout = (C.c_int * 16)()
    return tuple(layout[:fn(layout)]) == PD.LAYOUT


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


def ptxas_entries(stderr):
    """ptxas -v's report -> {an entry's template arguments as mangled
    (Li6E: 6 channels; a int8, s int16, i int32): (registers, spill store
    bytes)}."""
    out = {}
    for part in stderr.split("Compiling entry function '")[1:]:
        name = part.split("'", 1)[0]
        args = re.search(r"kernelI(.+?)EEv", name)
        regs = re.search(r"Used (\d+) registers", part)
        spill = re.search(r"(\d+) bytes spill stores", part)
        out[args.group(1) if args else name] = (
            int(regs.group(1)) if regs else None,
            int(spill.group(1)) if spill else None)
    return out


def build(src, name, defines, out_dir, bind):
    so = os.path.join(out_dir, f"lib{name}.so")
    r = subprocess.run([_cuda._nvcc(), *_cuda.NVCC_FLAGS, *defines, src,
                        "-o", so], capture_output=True, text=True, check=True)
    lib = C.CDLL(so)
    bind(lib)
    return lib, ptxas_entries(r.stderr)


def fields(label, B, F, nch, kbps, loud=False):
    """One encode of chip_smoke.py's content at that config on the card
    (loud: seeded full-scale white noise): the core's fields (P1_KEYS,
    qmant as int16, the device-pack path's form), the frame core's MDCT
    output (coef, exp_samples) and its first quantize call's inputs, the
    first 16,384 rows of each."""
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
    args = [res[k].reshape((-1,) + tuple(res[k].shape[2:]))[:n]
            .contiguous() for k in CS.P1_KEYS]
    args[1] = CS.as_int16(args[1])
    q1 = tuple(t[:n].contiguous() for t in w["q1_calls"][0][:4])
    return cfg, args, (got[3][:n].clone(), es[:n].contiguous(), nb,
                       lfe), q1


def time_p1(libs, cfg, args):
    """libs: {name: (lib, code dtype)}; args with int16 codes."""
    n = args[0].shape[0]
    old = {k for k, (lib, _) in libs.items() if k == "parent"
           and not parent_has_layout(lib)}
    tabs = {k: parent_table(cfg) if k in old
            else PD._kernel_table_on(cfg, args[0].device) for k in libs}
    forms = {torch.int16: args, torch.int32: CS.p1_other_codes(args)}
    fs58 = (cfg.frame_size >> 1) + (cfg.frame_size >> 3)
    want = PD.pack_frames_ref(cfg, *args)
    outs, times = {}, {k: [] for k in libs}
    for name in list(libs) + list(libs)[::-1]:
        out = torch.empty((n, cfg.frame_size * 2), dtype=torch.uint8,
                          device="cuda")
        lib, codes = libs[name]
        # a parent takes no code width: int32 codes only
        width = () if name == "parent" else (
            torch.empty((), dtype=codes).element_size(),)

        def run(lib=lib, out=out, tab=tabs[name], a=forms[codes], w=width):
            rc = lib.pack_frames_launch(
                *(t.data_ptr() for t in a), tab.data_ptr(),
                cfg.frame_size * 2, fs58, out.data_ptr(), n,
                cfg.channels, *w, torch.cuda.current_stream().cuda_stream)
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


def time_q1(libs, args):
    """libs: {name: (lib, code dtype)}; args: a quantize call's four
    inputs."""
    coef, enc, gexp, bap = args
    want = {c: QZ.quantize_ref(*args, codes=c)
            for c in (torch.int16, torch.int32)}
    outs, times = {}, {k: [] for k in libs}
    for name in list(libs) + list(libs)[::-1]:
        lib, codes = libs[name]
        out = torch.empty(coef.shape, dtype=codes, device="cuda")
        width = () if name == "parent" else (out.element_size(),)

        def run(lib=lib, out=out, w=width):
            rc = lib.quantize_launch(
                coef.data_ptr(), enc.data_ptr(), int(enc.dtype == torch.int32),
                gexp.data_ptr(), bap.data_ptr(), out.data_ptr(), *w,
                coef.numel(), coef.shape[-1],
                torch.cuda.current_stream().cuda_stream)
            assert rc == 0, rc

        times[name].append(CS.device_ms(run))
        outs[name] = out
    bound, by = CS.q1_bound(bap)
    return {k: (times[k], torch.equal(outs[k], want[libs[k][1]]))
            for k in libs}, bound, by


def main():
    CS.phase_card()
    out_dir = os.path.join(HERE, "build", "pack_variants")
    os.makedirs(out_dir, exist_ok=True)
    jobs = {("P1", k): (os.path.join(CSRC, "pack.cu"), f"pack_{k}", d,
                        PD._bind) for k, d in P1_VARIANTS.items()}
    jobs.update({("X1", k): (os.path.join(CSRC, "exponents.cu"),
                             f"exponents_{k}", d, _x1_bind)
                 for k, d in X1_VARIANTS.items()})
    jobs.update({("Q1", k): (os.path.join(CSRC, "quantize.cu"),
                             f"quantize_{k.replace(' ', '_')}", d, QZ._bind)
                 for k, d in Q1_VARIANTS.items()})
    if len(sys.argv) > 1:
        parent = os.path.join(sys.argv[1], "ac3acm_tpu_torch", "csrc")
        jobs["P1", "parent"] = (os.path.join(parent, "pack.cu"),
                                "pack_parent", [], _p1_bind)
        jobs["X1", "parent"] = (os.path.join(parent, "exponents.cu"),
                                "exponents_parent", [], _x1_bind)
        jobs["Q1", "parent"] = (os.path.join(parent, "quantize.cu"),
                                "quantize_parent", [], _q1_parent_bind)
    def try_build(job):
        try:
            return build(job[0], job[1], job[2], out_dir, job[3])
        except subprocess.CalledProcessError as e:
            return e

    # every variant's nvcc at once
    with ThreadPoolExecutor(len(jobs)) as pool:
        built = dict(zip(jobs, pool.map(try_build, jobs.values())))
    libs = {"P1": {}, "X1": {}, "Q1": {}}
    for (kernel, name), got in list(built.items()):
        if isinstance(got, subprocess.CalledProcessError):
            # a variant that does not build is reported and left out
            if name == "committed":
                raise got
            CS.log(f"{kernel} variant {name}: nvcc failed: "
                   f"{got.stderr.strip()[-300:]}")
            del built[kernel, name]
    for (kernel, name), (lib, entries) in built.items():
        if kernel == "X1":
            libs[kernel][name] = lib
        elif name == "committed" or kernel == "Q1" and name != "parent":
            libs[kernel][f"{name} int16"] = (lib, torch.int16)
            libs[kernel][f"{name} int32"] = (lib, torch.int32)
        else:
            libs[kernel][name] = (lib, torch.int32 if name == "parent"
                                  else torch.int16)
        CS.log(f"{kernel} variant {name}: registers (spill store bytes) "
               + ", ".join(f"{k} {r} ({sp})"
                           for k, (r, sp) in sorted(entries.items())))
    p1, x1, q1 = libs["P1"], libs["X1"], libs["Q1"]
    for config, loud in [(c, False) for c in CS.ENC_MAIN] + [
            (CS.ENC_MAIN[1], True)]:
        cfg, args, call, q1_args = fields(*config, loud=loud)
        runs = [("P1 loud" if loud else "P1", time_p1(p1, cfg, args))]
        if not loud:
            runs.append(("X1", time_x1(x1, call)))
            runs.append(("Q1", time_q1(q1, q1_args)))
        for kernel, got in runs:
            res, bound, by = got
            for name, (times, same) in res.items():
                CS.log(f"{config[0]} {kernel} [{args[0].shape[0]}, 6, "
                       f"{cfg.channels}, 256] {name}: "
                       f"{', '.join(f'{t:.4f}' for t in times)} ms (bound "
                       f"{bound:.4f}, {by}); == plain version {same}")
                assert same or name == "nocrc", (
                    kernel, name)


if __name__ == "__main__":
    main()
