#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one NVIDIA GPU and check it.

    python3 chip_smoke.py          (from the repository root; needs one card)

Phases, each fatal on failure (nothing is caught and passed over):

  1. card      nvidia-smi name and power limit, torch / CUDA versions
  2. build     the native host library (g++) and every CUDA kernel (nvcc),
               started together, each build timed
  3. check     every kernel against its plain PyTorch version on the card:
               at the bench shape (4096 lanes x 64 frames of the golden
               5.1 stream, premixed to 2 planes) and, through
               batched_pipeline, on four formats x both entry-fixup branches
  4. times     kernel, plain version, library call and bound at the bench
               shape (CUDA events, median after warm-up)
  5. main path BatchedDecoder(parser="native") in fast mode on 4096 lanes
               of distinct golden byte streams, f32 and compact H2D: the
               kernel's launch count must rise on every chunk, the PCM must
               equal the plain path within 1 LSB, and lane 0 must match the
               committed reference-decoder oracle within 1 LSB
  6. report    one JSON line listing every kernel, then the device line

Exits non-zero, printing no result, when no CUDA device is present.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import threading
import time

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
GOLDEN = os.path.join(HERE, "tests", "golden", "bench_51_448.ac3")

# bench shape (bench.py config 2): lanes x frames, 6 blocks per frame
BATCH, FRAMES = 4096, 64
# main path: lanes, frames per chunk, chunks
MAIN_BATCH, CHUNK_FRAMES, NCHUNKS = 4096, 16, 3
# published H100 SXM peaks (NVIDIA data sheet): HBM bytes/s, FP32 FLOP/s
# outside the tensor cores
PEAK_BYTES, PEAK_FP32 = 3.35e12, 67e12


def log(msg):
    print(msg, flush=True)


def cuda_ms(fn, warmup=2, reps=7):
    """Median milliseconds of fn() on the current stream (CUDA events)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        t0.record()
        fn()
        t1.record()
        t1.synchronize()
        times.append(t0.elapsed_time(t1))
    return float(np.median(times))


def phase_card():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip()
    log(smi.splitlines()[0])
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"devices {torch.cuda.device_count()} "
        f"({torch.cuda.get_device_name(0)})")


def phase_build():
    from ac3acm_tpu_torch.host import native
    from ac3acm_tpu_torch.ops import _cuda
    jobs = {"native host (g++)": native._build,
            "fused_steady (nvcc)": lambda: _cuda.build("fused_steady")}
    done, errors = {}, {}

    def run(name, fn):
        t0 = time.perf_counter()
        try:
            fn()
            done[name] = time.perf_counter() - t0
        except BaseException as e:          # re-raised below, never passed
            errors[name] = e

    threads = [threading.Thread(target=run, args=kv) for kv in jobs.items()]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        name, err = next(iter(errors.items()))
        raise RuntimeError(f"build of {name} failed") from err
    for name, dt in done.items():
        log(f"build {name}: {dt:.1f} s")
    for name, info in _cuda.ptxas_info.items():
        log(f"ptxas {name}: " + " | ".join(
            ln.strip() for ln in info.splitlines() if "ptxas" in ln))


def golden_planes(dev):
    """Bench-shape premixed planes from the port's DenseBatchParser over the
    golden stream: 8 frame rotations tiled over the lanes."""
    from ac3acm_tpu_torch import tables as T
    from ac3acm_tpu_torch.host.native import DenseBatchParser
    es = open(GOLDEN, "rb").read()
    r = DenseBatchParser(1).parse([es * (FRAMES // 8 + 1)], FRAMES,
                                  T.A52_STEREO | T.A52_ADJUST_LEVEL,
                                  1.0, 384.0, pre_planes=2)
    assert r["nframes"][0] == FRAMES and r["valid"].all() \
        and r["premix_ok"].all(), "golden parse failed"
    one = torch.from_numpy(r["freq_pre"][0]).to(dev)        # [n, 2, 256]
    rots = torch.stack([torch.roll(one, 6 * k, dims=0) for k in range(8)])
    lane_rot = torch.arange(BATCH, device=dev) % 8
    freq = rots[lane_rot].contiguous()                      # [B, n, 2, 256]
    bias = torch.from_numpy(r["bias"]).to(dev).expand(BATCH, -1).contiguous()
    rng = np.random.default_rng(0)
    d0 = torch.from_numpy((rng.standard_normal((BATCH, 2, 128)) * 0.01)
                          .astype(np.float32)).to(dev)
    return freq, d0, bias


def phase_check_bench(dev):
    from ac3acm_tpu_torch.ops import fused_steady as FS
    freq, d0, bias = golden_planes(dev)
    pcm_k, dl_k = FS.fused_steady(freq, d0, bias)
    pcm_p, dl_p = FS.fused_steady_ref(freq, d0, bias)
    torch.cuda.synchronize()
    err = int((pcm_k.to(torch.int32) - pcm_p.to(torch.int32)).abs().max())
    cerr = float((dl_k - dl_p).abs().max())
    frac = float((pcm_k != pcm_p).float().mean())
    log(f"check fused_steady bench shape {tuple(freq.shape)}: pcm max "
        f"{err} LSB (bar {FS.PCM_LSB_TOL}), {frac:.2e} of samples differ; "
        f"carry max {cerr:.3e} (bar {FS.CARRY_ATOL:.3e})")
    assert err <= FS.PCM_LSB_TOL and cerr <= FS.CARRY_ATOL
    del pcm_p, dl_p
    return (freq, d0, bias), err


def phase_check_formats(dev):
    """Kernel vs plain steady body through batched_pipeline: 4 formats x
    both downmixed branches, 2 chunks with the carry chained."""
    from ac3acm_tpu_torch import tables as T
    from ac3acm_tpu_torch.models.decoder import StreamFormat
    from ac3acm_tpu_torch.ops import fused_steady as FS
    from ac3acm_tpu_torch.parallel.pipeline import batched_pipeline
    fmts = {
        "5.1to2.0": StreamFormat(T.A52_3F2R, T.A52_STEREO, False, 0),
        "5.1to2.0+LFE": StreamFormat(T.A52_3F2R, T.A52_STEREO | T.A52_LFE,
                                     False, 0),
        "2.0pass": StreamFormat(T.A52_STEREO, T.A52_STEREO, True, 0),
        "5.1pass+LFE": StreamFormat(T.A52_3F2R, T.A52_3F2R | T.A52_LFE,
                                    False, 0),
    }
    B, n = 4, 12
    for name, fmt in fmts.items():
        for dm in (True, False):
            rng = np.random.default_rng(7)
            chunks = [{
                "freq": torch.from_numpy((rng.standard_normal(
                    (B, n, fmt.nch_out, 256)) * 0.01).astype(np.float32)
                    ).to(dev),
                "blksw": torch.zeros((B, n, 5), dtype=torch.bool, device=dev),
                "bias": torch.full((B, n), 384.0, device=dev),
            } for _ in range(2)]
            delay = torch.from_numpy((rng.standard_normal((B, 6, 128))
                                      * 0.01).astype(np.float32)).to(dev)
            outs = {}
            for fused in (True, False):
                fn = batched_pipeline(fmt, emit_int16=True, steady=True,
                                      long_only=True, premixed=True,
                                      exact=False, fused=fused)
                carry = (delay, torch.full((B,), dm, device=dev))
                pcms = []
                for blocks in chunks:
                    carry, pcm = fn(carry, blocks)
                    pcms.append(pcm.to(torch.int32))
                outs[fused] = (carry, torch.cat(pcms, dim=1))
            (ck, pk), (cp, pp) = outs[True], outs[False]
            err = int((pk - pp).abs().max())
            cerr = float((ck[0] - cp[0]).abs().max())
            assert err <= FS.PCM_LSB_TOL, (name, dm, err)
            assert cerr <= FS.CARRY_ATOL, (name, dm, cerr)
            assert bool((ck[1] == cp[1]).all()), (name, dm)
            log(f"check fused_steady {name} downmixed={dm}: pcm max {err} "
                f"LSB, carry max {cerr:.3e}")


def phase_times(bench_inputs):
    from ac3acm_tpu_torch.ops import fused_steady as FS
    from ac3acm_tpu_torch.ops.filterbank import mats_on
    freq, d0, bias = bench_inputs
    B, n, P, _ = freq.shape
    R = B * n * P
    w_long = mats_on(freq.device)[0]
    before = FS.launches
    ms = cuda_ms(lambda: FS.fused_steady(freq, d0, bias))
    per_call = (FS.launches - before) / 9
    plain_ms = cuda_ms(lambda: FS.fused_steady_ref(freq, d0, bias))
    flat = freq.view(R, 256)
    library_ms = cuda_ms(lambda: torch.matmul(flat, w_long))
    # least work: each input read once, each output written once; the
    # GEMM's 2*256*384 plus 6 epilogue operations per output sample
    nbytes = (R * 256 * 4 + B * P * 128 * 4 + B * n * 4 + 256 * 384 * 4
              + 256 * 4 + R * 256 * 2 + B * P * 128 * 4)
    flops = R * (2 * 256 * 384 + 6 * 256)
    t_bytes, t_ops = nbytes / PEAK_BYTES * 1e3, flops / PEAK_FP32 * 1e3
    bound_ms = max(t_bytes, t_ops)
    bound_by = "operations" if t_ops >= t_bytes else "bytes"
    log(f"time fused_steady [{B}x{n}x{P} rows={R}]: kernel_ms {ms:.3f} "
        f"plain_ms {plain_ms:.3f} library_ms(torch.matmul "
        f"[{R},256]@[256,384]) {library_ms:.3f} bound_ms {bound_ms:.3f} "
        f"= max({nbytes} B / 3.35e12 B/s = {t_bytes:.3f} ms, {flops:.4e} "
        f"FLOP / 67e12 FLOP/s = {t_ops:.3f} ms) -> {bound_by}; "
        f"{per_call:g} launch per call; "
        f"{flops / (ms * 1e-3) / 1e12:.2f} TFLOP/s achieved")
    return dict(ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                bound_ms=bound_ms, bound_by=bound_by)


def lane_streams(batch, nframes):
    """Distinct per-lane byte streams: golden frames, rotated start."""
    from ac3acm_tpu_torch.host.parse import syncinfo
    es = open(GOLDEN, "rb").read()
    base, pos = [], 0
    while pos + 7 <= len(es):
        size = syncinfo(es[pos:pos + 7])[0]
        assert size
        base.append(es[pos:pos + size])
        pos += size
    assert len(base) == 8
    rots = [b"".join(base[i:] + base[:i]) * (nframes // 8 + 1)
            for i in range(8)]
    return [rots[i % 8][: nframes * len(base[0]) + 7] for i in range(batch)]


def decode(streams, compact, fused):
    """One BatchedDecoder run; -> (chunks of device PCM, launches per
    chunk, seconds from the first parse to the last chunk on device)."""
    from ac3acm_tpu_torch import tables as T
    from ac3acm_tpu_torch.ops import fused_steady as FS
    from ac3acm_tpu_torch.parallel.pipeline import BatchedDecoder
    dec = BatchedDecoder(len(streams), T.A52_STEREO | T.A52_ADJUST_LEVEL,
                         bias=384.0, emit_int16=True, parser="native",
                         compact_h2d=compact, fused=fused)
    for i, s in enumerate(streams):
        dec.feed(i, s)
    torch.cuda.synchronize()
    chunks, counts = [], []
    t0 = time.perf_counter()
    for _ in range(NCHUNKS):
        before = FS.launches
        r = dec.decode_available(max_frames=CHUNK_FRAMES)
        assert r is not None, "main path ran dry"
        pcm, valid = r
        assert valid.all() and pcm.shape == (len(streams), CHUNK_FRAMES * 6,
                                             2, 256), pcm.shape
        counts.append(FS.launches - before)
        chunks.append(pcm)
    torch.cuda.synchronize()
    return chunks, counts, time.perf_counter() - t0


def phase_main_path():
    import ac3acm_tpu_torch as port
    from ac3acm_tpu_torch import tables as T
    from ac3acm_tpu_torch.host.native import DenseBatchParser
    from ac3acm_tpu_torch.ops import fused_steady as FS
    port.set_accuracy("fast")
    streams = lane_streams(MAIN_BATCH, CHUNK_FRAMES * NCHUNKS)
    oracle = np.load(GOLDEN + ".stereo_float.npy")         # [48, 512], bias 0
    want = np.clip(np.round(oracle.reshape(48, 2, 256).astype(np.float64)
                            * 32768.0), -32768, 32767)
    blocks = MAIN_BATCH * CHUNK_FRAMES * NCHUNKS * 6
    # the host half alone, for the breakdown: one native parse of the same
    # lanes, chunk by chunk, with the premix the decoder asks for
    parser = DenseBatchParser(MAIN_BATCH)
    pos = [0] * MAIN_BATCH
    t0 = time.perf_counter()
    for _ in range(NCHUNKS):
        r = parser.parse(list(zip(streams, pos)), CHUNK_FRAMES,
                         T.A52_STEREO | T.A52_ADJUST_LEVEL, 1.0, 384.0,
                         pre_planes=2)
        pos = [p + int(c) for p, c in zip(pos, r["consumed"])]
    dt_parse = time.perf_counter() - t0
    del parser, r
    log(f"host parse alone ({os.cpu_count()} CPUs): {dt_parse:.3f} s "
        f"-> {blocks * 256 / 48000.0 / dt_parse:.0f}x realtime")
    launches = 0
    for compact in (False, True):
        plain, counts_p, dt_p = decode(streams, compact, fused=False)
        assert sum(counts_p) == 0
        FS.launches = 0                       # the main path's own run
        fused, counts, dt = decode(streams, compact, fused=None)
        launches += FS.launches
        assert all(c >= 1 for c in counts), \
            f"fused kernel skipped a chunk: launches per chunk {counts}"
        err = max(int((a.to(torch.int32) - b.to(torch.int32)).abs().max())
                  for a, b in zip(fused, plain))
        assert err <= FS.PCM_LSB_TOL, f"fused vs plain path: {err} LSB"
        lane0 = torch.cat(fused, dim=1)[0, :48].cpu().numpy()
        oerr = int(np.abs(lane0.astype(np.int64) - want).max())
        assert oerr <= 1, f"lane 0 vs reference oracle: {oerr} LSB"
        log(f"main path compact_h2d={compact}: {MAIN_BATCH} lanes x "
            f"{NCHUNKS} chunks x {CHUNK_FRAMES} frames; launches per chunk "
            f"{counts}; fused vs plain max {err} LSB; lane 0 vs oracle max "
            f"{oerr} LSB; {dt:.3f} s -> "
            f"{blocks * 256 / 48000.0 / dt:.0f}x realtime "
            f"(plain path {blocks * 256 / 48000.0 / dt_p:.0f}x)")
        del plain, fused
    return launches


def main():
    phase_card()
    dev = torch.device("cuda")
    phase_build()
    bench_inputs, err = phase_check_bench(dev)
    phase_check_formats(dev)
    times = phase_times(bench_inputs)
    del bench_inputs
    torch.cuda.empty_cache()
    launches = phase_main_path()
    kernels = [dict(
        name="fused_steady", route="cuda",
        source="ac3acm_tpu_torch/csrc/fused_steady.cu",
        replaces="ac3acm_tpu/ops/pallas_steady.py:210",
        launches=launches, max_abs_err=err, **times)]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    sys.path.insert(0, HERE)
    main()
