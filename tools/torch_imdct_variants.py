#!/usr/bin/env python3
"""Time csrc/imdct_exact.cu's kernels against a parent checkout's on one
NVIDIA GPU.

    python3 tools/torch_imdct_variants.py [PARENT_ROOT [NAME=SOURCE ...]]

Builds this checkout's ac3acm_tpu_torch/csrc/imdct_exact.cu and, when
PARENT_ROOT is given, that checkout's, and any other version of the
source named on the command line (NAME=path, a design under trial), with
the port's nvcc flags into build/imdct_variants/ (every nvcc run at
once), and launches each through its own C entries (a source whose B1F
takes no pair schedule, as the parent's, is called without one) on:

  B1F   the main path's chunk [4096, 96, 2, 256] of the golden 5.1
        stream's premixed planes (chip_smoke.py:golden_planes): int16,
        f32, and int16 with 30% of the (lane, block)s short
  B1QS  one frame (6 blocks) of the 5.1 golden's fixed parse to 2.0 and
        to 3F2R|LFE, also through the wrapper (ops.fixed_chain, the
        package's build); the call with no blocks; beside them a bare launch
        (a kernel that does nothing): one CTA with no dynamic shared
        memory, a cluster of this checkout's B1QS shape, and one CTA of
        the 84,392 B and 576 threads of the earlier one-CTA B1QS
  B1    786,432 long rows (the same chunk), and B1Q on the 5.1 golden's
        Q30 planes tiled to 786,432 rows (chip_smoke.py:fixed_planes)

Each time is chip_smoke.py:device_ms (the card held busy while the host
enqueues), taken for every variant in turn and then again in reverse.
Prints each instance's registers and spills (ptxas), whether each
variant's outputs equal the plain versions (B1F int16 and B1QS bitwise,
B1F f32 and dlast, B1 by value), and the card's name and power limit.
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
from ac3acm_tpu_torch.ops import _cuda  # noqa: E402
from ac3acm_tpu_torch.ops import fixed_chain as FC  # noqa: E402
from ac3acm_tpu_torch.ops import fused_steady_exact as FE  # noqa: E402
from ac3acm_tpu_torch.ops import imdct_exact as IE  # noqa: E402
from ac3acm_tpu_torch.ops.filterbank import mats_on  # noqa: E402

SRC = os.path.join(HERE, "ac3acm_tpu_torch", "csrc", "imdct_exact.cu")
# the earlier one-CTA B1QS's dynamic shared memory and threads
PARENT_B1QS_SMEM, PARENT_B1QS_THREADS = 84392, 576


def _bind(lib, pairs):
    """The entries the tool calls; `pairs`: B1F takes the pair schedule."""
    p, i = C.c_void_p, C.c_int
    for name in ("imdct_exact_launch", "imdct_fixed_launch"):
        fn = getattr(lib, name)
        fn.restype, fn.argtypes = i, [p] * 6 + [C.c_longlong, p]
    lib.fused_steady_exact_launch.restype = i
    lib.fused_steady_exact_launch.argtypes = [p] * (10 if pairs else 9) + [
        i, i, i, i, p]
    lib.fixed_chain_launch.restype = i
    lib.fixed_chain_launch.argtypes = [p] * 13 + [i, p, p]
    if hasattr(lib, "fixed_chain_shape"):        # this design's B1QS
        lib.imdct_exact_bare_launch.restype = i
        lib.imdct_exact_bare_launch.argtypes = [i, i, i, p]
        lib.fixed_chain_shape.restype = None
        lib.fixed_chain_shape.argtypes = [p]


def ptxas_entries(stderr):
    """ptxas -v's report -> {entry name: (registers, spill store bytes)}."""
    out = {}
    for part in stderr.split("Compiling entry function '")[1:]:
        name = part.split("'", 1)[0]
        short = re.search(r"\d+([a-z_]+_kernel)(I[^E]*E)?", name)
        regs = re.search(r"Used (\d+) registers", part)
        spill = re.search(r"(\d+) bytes spill stores", part)
        key = (short.group(1) + (short.group(2) or "")) if short else name
        out[key] = (int(regs.group(1)) if regs else None,
                    int(spill.group(1)) if spill else None)
    return out


def build(src, name, out_dir):
    so = os.path.join(out_dir, f"lib{name}.so")
    r = subprocess.run([_cuda._nvcc(), *_cuda.NVCC_FLAGS, src, "-o", so],
                       capture_output=True, text=True, check=True)
    return so, ptxas_entries(r.stderr)


def in_turns(runs):
    """{name: fn} -> {name: [device ms in turn order, then reverse]}."""
    times = {k: [] for k in runs}
    for name in list(runs) + list(runs)[::-1]:
        times[name].append(CS.device_ms(runs[name]))
    return times


def show(what, times, bound=None):
    for name, ts in times.items():
        CS.log(f"{what} {name}: " + ", ".join(f"{t:.4f}" for t in ts)
               + " ms" + (f" (bound {bound:.4f})" if bound else ""))


def time_b1f(libs, freq, d0, bias, dev):
    B, n, P, _ = freq.shape
    tw, win = IE._tw_on(dev), mats_on(dev)[2]
    pt = FE._pair_table_on(dev)
    blk = (torch.rand((B, n, 1), device=dev, generator=torch.Generator(
        dev).manual_seed(30)) < 0.3).expand(-1, -1, P).contiguous()
    runs, outs = {}, {}
    for vname, (lib, pairs) in libs.items():
        for form, blksw, dtype in (("int16", None, torch.int16),
                                   ("f32", None, torch.float32),
                                   ("30% short", blk, torch.int16)):
            pcm = torch.empty((B, n, P, 256), dtype=dtype, device=dev)
            dlast = torch.empty((B, P, 128), device=dev)
            args = ([freq.data_ptr(), None if blksw is None
                     else blksw.data_ptr(), d0.data_ptr(), bias.data_ptr(),
                     tw["packed"].data_ptr(), tw["order32"].data_ptr()]
                    + ([pt.data_ptr()] if pairs else [])
                    + [win.data_ptr(), pcm.data_ptr(), dlast.data_ptr(), B,
                       n, P, int(dtype == torch.int16)])

            def run(lib=lib, args=args):
                rc = lib.fused_steady_exact_launch(
                    *args, torch.cuda.current_stream().cuda_stream)
                assert rc == 0, rc

            runs[f"{form} {vname}"] = run
            outs[f"{form} {vname}"] = (blksw, dtype, pcm, dlast)
    for name, run in runs.items():
        run()
    torch.cuda.synchronize()
    for name, (blksw, dtype, pcm, dlast) in outs.items():
        pr, dr = FE.fused_steady_exact_ref(freq, blksw, d0, bias, dtype)
        same = torch.equal(pcm, pr) and torch.equal(dlast, dr)
        CS.log(f"B1F {name}: == plain version {same}")
        assert same, name
        del pr, dr
    return in_turns(runs)


def time_b1qs(libs, dev):
    init = (np.zeros((6, 128), np.int32), np.array(True))
    lib0 = next(iter(libs.values()))[0]
    smem, threads, ctas = CS.b1qs_shape(lib0)
    runs = {}
    for bname, bsmem, bthreads, bctas in (
            ("bare launch, one CTA, no shared memory", 0, threads, 1),
            (f"bare launch, a cluster of {ctas} CTAs x {smem} B (this "
             f"B1QS's shape)",
             smem, threads, ctas),
            (f"bare launch, one CTA of {PARENT_B1QS_SMEM} B (the earlier "
             f"one-CTA B1QS's)", PARENT_B1QS_SMEM, PARENT_B1QS_THREADS, 1)):
        def run(s=bsmem, t=bthreads, c=bctas):
            rc = lib0.imdct_exact_bare_launch(
                s, t, c, torch.cuda.current_stream().cuda_stream)
            assert rc == 0, rc
        runs[bname] = run
    tw = IE._tw_on(dev, "fixed")
    for flags in (CS.FLAGS_51_TO_20, 7 | 16 | 32):
        fmt, blocks = CS.fixed_frames(CS.GOLDEN, flags, 1)[0]
        carry, tb = CS.on_card(init, blocks, dev)
        (rd, rm), rp = FC.fixed_chain_ref(fmt, carry, tb)
        mix = FC._mix_arg(fmt)
        for nb in (6, 0):
            b = {k: v[:nb].contiguous() for k, v in tb.items()}
            for vname, (lib, _) in libs.items():
                pcm = torch.empty((nb, fmt.nch_out, 256), dtype=torch.int32,
                                  device=dev)
                d_out = torch.empty((6, 128), dtype=torch.int32, device=dev)
                m_out = torch.empty((), dtype=torch.bool, device=dev)

                def run(lib=lib, b=b, pcm=pcm, d_out=d_out, m_out=m_out,
                        carry=carry, mix=mix, nb=nb):
                    rc = lib.fixed_chain_launch(
                        b["freq"].data_ptr(), b["blksw"].data_ptr(),
                        b["coeff"].data_ptr(), b["remat"].data_ptr(),
                        b["bias"].data_ptr(), carry[0].data_ptr(),
                        carry[1].data_ptr(), tw["packed"].data_ptr(),
                        tw["order32"].data_ptr(), tw["window"].data_ptr(),
                        pcm.data_ptr(), d_out.data_ptr(), m_out.data_ptr(),
                        nb, C.byref(mix),
                        torch.cuda.current_stream().cuda_stream)
                    assert rc == 0, rc

                run()
                torch.cuda.synchronize()
                if nb:
                    same = (torch.equal(pcm, rp) and torch.equal(d_out, rd)
                            and bool(m_out) == bool(rm))
                else:
                    same = torch.equal(d_out, carry[0]) and bool(m_out)
                tag = (f"to {fmt.output}" if nb else
                       f"no blocks ({fmt.output})") + f" {vname}"
                CS.log(f"B1QS {tag}: == plain version {same}")
                assert same, tag
                runs[tag] = run
            if nb:
                # the same call through the package's wrapper (its own
                # build of this checkout's source)
                runs[f"to {fmt.output} through ops.fixed_chain"] = (
                    lambda fmt=fmt, tb=tb, carry=carry:
                    FC.fixed_chain(fmt, carry, tb))
    return in_turns(runs)


def time_b1(libs, freq, dev):
    rows = freq.numel() // 256
    x = freq.view(rows, 256)
    tw = IE._tw_on(dev)
    planes, _ = CS.fixed_planes(CS.GOLDEN, CS.FLAGS_51_TO_20)
    xq = torch.from_numpy(np.resize(planes, (rows, 256))).to(dev)
    twq = IE._tw_on(dev, "fixed")
    zr, dr = IE.split_fb_exact_ref(x)
    zq, dq = IE.split_fb_fixed_ref(xq)
    runs = {}
    for vname, (lib, _) in libs.items():
        for kernel, entry, inp, t, ref in (
                ("B1", "imdct_exact_launch", x, tw, (zr, dr)),
                ("B1Q", "imdct_fixed_launch", xq, twq, (zq, dq))):
            z = torch.empty((rows, 256), dtype=inp.dtype, device=dev)
            d = torch.empty((rows, 128), dtype=inp.dtype, device=dev)

            def run(fn=getattr(lib, entry), inp=inp, t=t, z=z, d=d):
                rc = fn(inp.data_ptr(), None, t["packed"].data_ptr(),
                        t["order32"].data_ptr(), z.data_ptr(), d.data_ptr(),
                        rows, torch.cuda.current_stream().cuda_stream)
                assert rc == 0, rc

            run()
            torch.cuda.synchronize()
            same = torch.equal(z, ref[0]) and torch.equal(d, ref[1])
            CS.log(f"{kernel} {vname}: == plain version {same}")
            assert same, (kernel, vname)
            runs[f"{kernel} {vname}"] = run
    return in_turns(runs)


def main():
    CS.phase_card()
    out_dir = os.path.join(HERE, "build", "imdct_variants")
    os.makedirs(out_dir, exist_ok=True)
    jobs = {"committed": SRC}
    if len(sys.argv) > 1:
        jobs["parent"] = os.path.join(sys.argv[1], "ac3acm_tpu_torch",
                                      "csrc", "imdct_exact.cu")
    jobs.update(arg.split("=", 1) for arg in sys.argv[2:])
    with ThreadPoolExecutor(len(jobs)) as pool:
        built = dict(zip(jobs, pool.map(
            lambda kv: build(kv[1], f"imdct_{kv[0]}", out_dir),
            jobs.items())))
    libs = {}
    for name, (so, entries) in built.items():
        lib = C.CDLL(so)
        pairs = "const void* ptab" in open(jobs[name]).read()
        _bind(lib, pairs)
        libs[name] = (lib, pairs)
        CS.log(f"{name}: registers (spill store bytes) " + ", ".join(
            f"{k} {r} ({sp})" for k, (r, sp) in sorted(entries.items())))
        assert all(sp == 0 for _, sp in entries.values()), (name, entries)
    dev = torch.device("cuda")
    freq, d0, bias = CS.golden_planes(dev)
    n = CS.CHUNK_FRAMES * 6
    freq, bias = freq[:, :n].contiguous(), bias[:, :n].contiguous()
    b1f = time_b1f(libs, freq, d0, bias, dev)
    B, n, P, _ = freq.shape
    b1f_bound = (B * n * P * 256 * 6 + B * P * 1024 + B * n * 4) \
        / CS.PEAK_BYTES * 1e3
    show(f"B1F [{B}, {n}, {P}, 256]", b1f, b1f_bound)
    show("B1QS one frame", time_b1qs(libs, dev))
    show(f"[{freq.numel() // 256} rows]", time_b1(libs, freq, dev))


if __name__ == "__main__":
    main()
