#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one NVIDIA GPU and check it.

    python3 chip_smoke.py          (from the repository root; needs one card)

Phases, each fatal on failure (nothing is caught and passed over):

  1. card      nvidia-smi name and power limit, torch / CUDA versions
  2. build     the native host library (g++) and every CUDA kernel (nvcc),
               started together, each build timed; no kernel spills, and
               the SASS (cuobjdump) of the order-exact kernels B1 and B1F
               holds no FFMA (every product rounds on its own; B1Q and
               B1QS, the fixed-point entries of the same source, are
               integer); M1's holds no float instruction, and its count
               is M1's design model
  3. check     the fused steady kernel (K1) against its plain PyTorch
               version on the card: at the bench shape (4096 lanes x 64
               frames of the golden 5.1 stream, premixed to 2 planes);
               through batched_pipeline on four formats x both entry-fixup
               branches; on ragged shapes (1..384 blocks x 1..6 planes, a
               non-zero carry in); and twice on the same inputs, bitwise
               equal.  The orbit gather (K4) on totals that are not
               multiples of 8, from a view that is not 16-byte aligned,
               with indices outside the table.  The bitfield gathers (K2,
               K3) on ragged rows, unaligned views and rows, fields on
               and past the edges, widths 0 and 16, the int32 and narrow
               wires, unit=16 against unit=1, a row too wide to stage
               The order-exact IMDCT kernel (B1) equal to its plain
               version BY VALUE on long, short and mixed rows, ragged row
               counts, rows with +-0, subnormals and near-full-scale
               values, and the main path's first chunk of real premixed
               planes (786,432 rows).  The fused order-exact steady tail
               (B1F) equal to its plain version (int16 bitwise, f32 and
               the carry-out by value) on that chunk, long and with 30%
               short rows, and on ragged shapes (B 1/3/257 x n 1/2/7/97 x
               P 1/2/3, edge-case and clipping rows, LFE long, bias 0 /
               384 / varying), each case launched twice, bitwise equal
  4. times     kernel, plain version and library call at the bench shape
               (CUDA events, median after warm-up) beside the function's
               bound (bytes, or one pass of tensor operations) and, labelled
               apart, the design bounds (three TF32 or bf16 passes, the
               FP32 pipes); B1 at the main path's chunk beside its byte
               bound, its plain version and the fast mode's matmul of the
               same rows (not the same function bitwise); B1F there (int16,
               f32, 30% short) beside B1 + the eager epilogue it replaces,
               the eager epilogue alone, its plain version and its bound,
               and the design's model (the SASS on a pair step's path,
               b1f_pair_paths, at the card's issue rate) on its log line
  5. main path BatchedDecoder(parser="native") in fast mode on 4096 lanes
               of distinct golden byte streams, f32 and compact H2D: the
               kernel's launch count must rise on every chunk, the PCM must
               equal the plain path within 1 LSB, and lane 0 must match the
               committed reference-decoder oracle within 1 LSB
  6. gathers   every bitfield/table gather of the raw-H2D unpack (K2-K4)
               against its plain version, bitwise, as one step of each raw
               path's decoder gives it (4096 lanes x 16 frames of the
               golden 5.1 stream; 4096 lanes x 12 frames of the golden
               coupling stream), and the times of the K2 mantissa, K3 and
               K4 calls beside their byte bounds (K2 also on the int32
               wire; K3 and K4 beside torch.index_select of the same
               entries)
  7. raw path  BatchedDecoder(parser="raw") on the main path's lanes: the
               gathers' launch counts must rise on every chunk, the first
               chunk's dequantized planes must equal the native parser's
               bitwise, the PCM must equal the native plain path's within
               1 LSB and lane 0 the oracle within 1 LSB; peak memory; one
               step broken into stages (StageClock)
  8. coupling  BatchedDecoder(parser="raw") on 4096 lanes of the golden
               coupling stream: the shared-table gather must launch on
               every chunk, lane 0 within 1 LSB of its oracle; peak memory;
               one step broken into stages
  9. reference the package default ACCURACY="reference" (no set_accuracy
               call) on the main path: B1F launches on every chunk, B1 and
               K1 never; every lane within 1 LSB of the fast
               mode's PCM; 256 lanes of float output at bias 0 whose lanes
               start at frame 0 equal the reference decoder's output at
               max |diff| 0.0 (through B1F's float form); x-realtime
               beside the fast path's
 10. ref raw   the same lanes through parser="raw" (device premix, B1F on
               every chunk, B1 never): int16 PCM equal to the reference
               native path's; peak memory; stages (StageClock)
 11. general   4096 lanes of the coupling/short-block stream whose every
               chunk needs the block scan, in chunks of 4 frames, through
               both parsers in reference mode and the native one in fast
               mode: the scan runs on every chunk and the steady body
               never, B1 on every reference chunk and B1F never; lane 0
               equals its golden at 0.0; raw equals native;
               fast within 1 LSB of reference
 12. mixed     4096 lanes cycling 5.1 / 2.0 / 1.0 streams, some switching
               5.1 -> 2.0 mid-stream, in reference mode: every lane equals
               its stream decoded in a format-homogeneous batch
 13. single    the single-stream Decoder() in the default reference mode
               (the Python parser on the host, the block scan on the card):
               512 frames of the golden 5.1 stream (16 s of audio), its
               first 8 frames equal to the reference decoder's output at
               0.0 and the whole stream to the native C++ decoder's by
               value; streams that switch 5.1 -> 2.0 mid-stream with DRC
               off and with a DRC callback, equal to the native decoder's;
               B1 on every run, B1F and K1 never; B1 held to its plain
               version on the Decoder's own shapes; x-realtime and the
               host parse's share; the 16 s stream timed in two forms, one
               block_pipeline call a frame and one for the whole run
 14. stream    Ac3ToPcmStream (exact and fast) fed in pieces of 7 B,
               1,000 B and the rest equal to one call; exact int16 equal
               to the native decoder's through the same conversion; the
               a52 API (on the native decoder) equal to it
 15. python    BatchedDecoder(parser="python") on 64 lanes x 2 chunks x 4
               frames equal to parser="native" (reference int16 and float
               with B1F on every chunk, fast int16 with K1 on every
               chunk), and a mixed-format batch of 48 lanes (B1F or B1 on
               every chunk, K1 never); every B1F, K1 and B1 call of the
               python runs held to its plain version
 16. raw_py    BatchedDecoder(parser="raw_py") equal to parser="raw" in
               meta, frame bytes and int16, K2 and K4 on every chunk (64
               lanes), K3 on coupled lanes (4 lanes); every gather and
               B1F call of the raw_py runs held to its plain version
 17. E1        the masking curve, SNR-offset search and bap kernel (E1,
               csrc/snr_search.cu) from the coded exponents, equal to its
               plain version BITWISE in M, fstar and bap on crafted cases
               (1 to 6 channels with and without the LFE and its band-6
               lowcomp, bins past 252, none, 32-bin edges, the three
               sample rates' thresholds; budgets that force M = -1 with
               and without a fine fit, M = 63, fstar 0 and 15, exact ties,
               a ceiling that per-channel or per-frame grouping would
               miss), each launched twice; one row, 1,000 rows, none (no
               launch); refusals.  In the encode phases below: every core
               call launches E1 once and calls no eager masking or rate
               model (band_psd, excitation, masking_curve, bits_for_snro,
               bap_from_mask); every E1 call of one device-alone run of
               configs 3 and 4 and of the transcode's first chunk held to
               its plain version bitwise; its time at each config's core
               call beside its byte bound, its design's floor and the
               plain version
 17b. P1       the device frame packer (P1, csrc/pack.cu) equal to its
               plain version (pack_frames_ref, the eager int64 token
               stream) and to the native C++ packer BYTE FOR BYTE on
               crafted fields (P1_CONFIGS: 1 to 6 channels, the LFE, 32,
               44.1, 48 and 24 kHz, frames of 256 to 3,840 bytes; x
               P1_KINDS: every class and strategy, grouped classes only
               (groups across channels, incomplete last groups), D15, D25
               and D45 throughout, reused exponents, a frame filled to its
               last payload bit, a block coded on every live bin, the
               16-bin chunk that straddles each channel's last live bin,
               frames that overrun), with int32 codes and with their int16
               form (Q1's, read as unsigned), each launched twice; 1 frame
               and a
               CTA's warps - 1 and + 1 (8 up to two channels, 16 above: its
               last warp idle, a second CTA of one frame); [F, B] leading axes; no frames (no launch);
               refusals.  In the encode phases below: P1 once a core call
               with pack="device" and never with "native"; every P1 call
               of one device-alone run of configs 3 and 4 and of the
               transcode's first chunk (int16 codes from Q1) held to its
               plain version and to P1 on the same codes as int32 byte for
               byte; its time in both code widths at each config's call
               beside its byte bound (pack_least_bytes, from that call's
               own fields) and the plain version; and on a loud encode
               (full-scale white noise at config 4's format, most live bins
               coded), every call held so and the first timed so
 17c. X1       the exponent stage (X1, csrc/exponents.cu: raw exponents,
               strategy, run fold, coding, reuse copy) equal to its plain
               version (exponents_ref, the eager chain) BITWISE in the 256
               coded bytes of every block and channel, strat, exp_bits and
               the zeroed coefficients, on crafted rows of 1 to 6 channels
               with and without the LFE: all 32 new-block patterns of
               blocks 1-5 in every full-band channel, diff sums of exactly
               1000 and 1001, dead bins 223-228 unlike the live ones,
               all-zero blocks and channels, overranging coefficients,
               |c| near 2^17 and 2^31; each launched twice; one row,
               twice the resident CTAs' rows + 1 (each CTA walks two or
               three), none (no launch); refusals (nb other than 223
               too).  In the
               encode phases below: X1 once a core call and no eager
               exponent step in a frame core; every X1 call of one
               device-alone run of configs 3 and 4 and of the transcode's
               first chunk held to its plain version bitwise; its time at
               each config's core call beside its byte bound and the plain
               version
 17d. Q1       the quantizer (Q1, csrc/quantize.cu) equal to its plain
               version (quantize_ref, the int64 passes) BITWISE in both
               code widths (int16, the low 16 bits the device-pack path
               hands P1; int32, JAX's values) on every class 0-15 at
               exponent differences -21..33, INT32_MIN/MAX and the powers
               of two, saturating codes, class-15 codes from 32,768 up,
               runs of class 0 (whole sectors skipped), with int8 and int32
               exponents, each launched twice; the frame core's layout;
               more chunks than a pass of the full grid; the public
               models/encoder.py:quantize on JAX's inputs (int32 classes,
               ragged rows of 1,021 and 1,012 bins, strided and unaligned
               tensors), int32 codes; none (no launch); refusals.  In the
               encode phases below as X1: once a core call (int16 codes on
               the device-pack path), every call of the recorded runs held
               to quantize_ref in both widths, its times in both widths
               beside its byte bound (q1_least_bytes, from that call's own
               classes)
 17e. M1       the window, normalize and MDCT (M1, csrc/window_mdct.cu)
               equal to its plain version (window_mdct_ref: ops/mdct.py's
               window_norm_block, then mdct512) BITWISE in coef and
               exp_samples on crafted rows (m1_case: 1 to 6 channels x 1,
               3 and 4,097 rows; square waves at +-32767 and -32768,
               silence, impulses at 0, 100 and 255, a DC ladder to every
               shift, noise at four scales, -32768 at x[384] where the
               rotation negates it; and rows of int32 outside int16, whose
               window products wrap), each launched twice; none (no
               launch); refusals.  In the encode phases below: M1 once a
               core call and no eager window_norm_block, mdct512 or
               _fft128 in a frame core; every M1 call of one device-alone
               run of configs 3 and 4 and of the transcode's first chunk
               held to its plain version bitwise; its time at each config's
               core call beside its byte bound, the plain version and, on
               its log line, the design's model (its SASS count)
 18. enc digest the encoder's integer primitives (window + normalize, MDCT,
               M1, exponents, quantize at shift counts -40..60, av_log2)
               on edge cases, card equal to CPU bitwise; then
               BatchedEncoder(pack="device") and pack="native" on 8 lanes
               x 4 frames (two calls, the carry crossing them) of seeded
               PCM (tones, noise, silence, full scale) in six formats: the
               sha256 of each equal to the JAX encoder's (ENC_DIGESTS)
 19. encode    the JAX benchmark's configs 3 (4096 lanes x 8 frames, 2.0,
               192 kbit/s) and 4 (2048 x 8, 5.1, 640 kbit/s) on
               bench.py:_encode_pcm's content: device pack == native pack
               on every frame; x-realtime end to end (int16 PCM on the host
               in, bytes on the host out) and on the device alone; peak
               memory; each stage's CUDA-event time (the least total of
               three runs, each enqueued behind a held card), ATen op
               count, least bytes and peak allocated memory (the pack one
               "pack" row, P1; the window + normalize + MDCT one M1
               launch, the exponents one X1 launch, the quantize one Q1
               launch); the core's frame grouping both ways; the host
               packer alone
 20. single enc Encoder over 512 frames (x-realtime); X1's and P1's
               wrappers' host cost at its 16-row call, and the occupancy
               query each launch function makes once; a 17-frame call
               (across Encoder.CHUNK) == lane 0 of BatchedEncoder ==
               PcmToAc3Stream fed in ragged pieces == the a52 encode API;
               a round trip through Decoder() above 12 dB SNR
 21. transcode Transcoder(4096, 192000, 2) over the golden 5.1 lanes, 2
               chunks x 4 frames, reference mode, parser "native" (f32 and
               compact) and "raw", and 256 coupled raw lanes: B1F (and on
               the raw paths K2 and K4, on the coupled one K3) on every
               chunk, K1 and B1 never, M1, E1, X1, Q1 and P1 on every
               chunk;
               every
               B1F and gather call held to its plain version; the first 8
               lanes' digest equal to the
               JAX Transcoder's (TC_DIGEST); raw == native; the f32 bytes
               of 64 lanes == BatchedDecoder int16 -> BatchedEncoder;
               x-realtime of step_frames and of dispatch_frames/finish
 22. B1Q       the Q30 order-exact IMDCT kernel (B1Q, the fixed-point
               sample type) equal to its plain version BITWISE on the 5.1
               golden's real Q30 planes (ac3h_sdec_parse_fixed) tiled to
               786,432 rows, long and 30% short, on edge rows (full-range
               int32, INT32_MIN/MAX, zeros, one non-zero bin) and ragged
               row counts; an unaligned view raises; its times at 786,432
               rows and at a 5-row call beside its bound.  B1QS (the fixed
               block chain, one launch a call) equal to its plain version
               (the eager _block_step loop, lane-batched with
               torch.func.vmap) BITWISE in PCM, delay and downmixed: the
               5.1 golden to every output the fixed backend takes, the
               stereo golden, a short-block stream, the 5.1 -> 2.0 switch
               across two calls, synthetic n = 1..13 (full-range int32,
               mixed blksw, zero-coefficient channels, all short, carries
               with downmixed True and False), and the JAX digest's cases
               (B1QS_DIGEST); n = 0 and refusals; its device time a frame,
               the call with no blocks (prologue and launch) beside a
               bare launch (one CTA, and a cluster of B1QS's shape), the
               wrapper's host time, the plain version, the bound (the
               card's rates) and the same instructions at one SM's
               integer issue rate
 23. fixed     SampleDecoder("fixed") on the card: 512 frames of the 5.1
               golden to stereo and to 3F2R|LFE, and the 5.1 -> 2.0
               switch with DRC off, each int32 bitwise the native fixed
               backend's; B1QS once a frame, B1Q, B1, B1F and K1 never;
               every B1QS call's output equal to the plain version of its
               inputs; the ATen operations a frame.  Then B1Q's own path,
               get_variant("fixed")'s imdct512, imdct256 and filterbank,
               bitwise the plain split's
 24. cli       python -m ac3acm_tpu_torch.cli as subprocesses on 128 frames:
               decode to wav on the card (float and fixed) byte-equal to
               --backend native; encode of that wav equal to Encoder's
               bytes; info --check-crc; x-realtime from the CLI's meter
 25. driver    CodecDriver streams on the card equal to Ac3ToPcmStream and
               PcmToAc3Stream on the same bytes
 26. profile   utils.trace.profile() around 32 frames of the fixed decode:
               the Chrome trace names B1QS's kernel once a frame and B1Q's
               never; the device busy share (the union of kernel
               intervals over the traced window)
 27. mesh      the lane split over a mesh's 'data' axis (parallel/mesh.py):
               on one card make_mesh(data=4, devices=["cuda:0"] * 4), the
               card named four times (every line of the split, the shards
               in turn); with more cards one entry per card.  The main
               path's 4096 lanes x 3 chunks x 16 frames through
               BatchedDecoder(mesh=...) native in reference mode (B1F once
               a chunk a shard), native in fast mode (K1) and raw in fast
               mode (K2, K4): PCM bitwise the one-device run in reference
               mode, within 1 LSB in fast mode; every B1F, K1 and gather
               call of the sharded runs held to its plain version; the
               transcode (config 5) through Transcoder(mesh=...), bytes
               equal to the one-device Transcoder's; tp_filterbank on a 2x2
               mesh at [4096, 6, 256] and the one-device filterbank, each
               within the f32 rounding bound (any order of the 256-term
               sums) of the float64 product; x-realtime sharded beside
               one-device, launches per kernel, peak memory
 28. report    one JSON line listing every kernel, then the device line

Exits non-zero, printing no result, when no CUDA device is present.
"""
from __future__ import annotations

import contextlib
import json
from collections import Counter
import os
import re
import subprocess
import sys
import threading
import time

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
GOLDEN = os.path.join(HERE, "tests", "golden", "bench_51_448.ac3")
CPL_GOLDEN = os.path.join(HERE, "tests", "golden", "cpl51_hazard.ac3")
SPEC_GOLDEN = os.path.join(HERE, "tests", "golden", "spec_cpl51_hazard.ac3")
STEREO_GOLDEN = os.path.join(HERE, "tests", "golden", "stereo_192.ac3")
MONO_GOLDEN = os.path.join(HERE, "tests", "golden", "mono_96.ac3")

# bench shape (bench.py config 2): lanes x frames, 6 blocks per frame
BATCH, FRAMES = 4096, 64
# main path: lanes, frames per chunk, chunks
MAIN_BATCH, CHUNK_FRAMES, NCHUNKS = 4096, 16, 3
# raw-H2D main path: frames per chunk (the native path's 16 while peak
# device memory stays <= 60 GB).  Coupling path: lanes, frames per chunk,
# chunks.  Its interleaved lattice holds a coupling copy per channel, so
# a frame costs more device memory than a main-path frame: the main
# path's lanes in chunks of two passes of the 6-frame golden stream (each
# lane plays it from frame 0, over and over) is what fits under the same
# limit
CPL_BATCH, CPL_CHUNK_FRAMES, CPL_NCHUNKS = 4096, 12, 2
RAW_CHUNK_FRAMES = 16
PEAK_MEM_LIMIT = 60e9
# general decode (every chunk needs the block scan) and mixed formats:
# lanes, frames per chunk, chunks
GEN_BATCH, GEN_CHUNK_FRAMES, GEN_NCHUNKS = 4096, 4, 2
MIX_BATCH, MIX_CHUNK_FRAMES, MIX_NCHUNKS = 4096, 4, 2
# the mesh phase: data rows on one card (the card repeated), the
# tp_filterbank input [lanes, channels, 256] and its mesh (data, model)
MESH_DATA_ONE_CARD = 4
MESH_TP_SHAPE, MESH_TP_GRID = (4096, 6, 256), (2, 2)
# FP32 operations of one long row of the order-exact IMDCT (B1): the
# pre-twiddle 128 x 6, the leaves 11 ifft8 x 56 + 10 ifft4 x 16, the
# passes (a zero butterfly 12, another 24) 5 x 84 + 3 x 180 + 372 + 756,
# the post-twiddle 64 x 12
B1_LONG_ROW_FLOP = 768 + 776 + 420 + 540 + 372 + 756 + 768
# published H100 SXM peaks (NVIDIA data sheet): HBM bytes/s, FP32 FLOP/s
# outside the tensor cores, dense TF32 and bf16 FLOP/s in them
PEAK_BYTES, PEAK_FP32, PEAK_TF32, PEAK_BF16 = 3.35e12, 67e12, 495e12, 989e12
# instructions a second an H100 SXM can issue: 4 schedulers x 32 lanes an
# SM x 132 SMs x 1.98 GHz boost, the FP32 peak counted one instruction per
# FMA (67e12 / 2).  Integer instructions issue to the INT pipe and (IMUL,
# IMAD) to the FMA pipe beside it, and no mix of them issues faster
PEAK_ISSUE = PEAK_FP32 / 2
# integer instructions of one long row of the Q30 IMDCT (B1Q), at the
# fewest the function needs: the long row's 1,724 MULs (B1's multiplies)
# at 7 each (of native/ac3sample.inc:33-38, IMUL, IMAD, the shift of tc
# and the LEA that adds it to the high product's << 2, one more IMUL, and
# the two 16-bit halves of each operand, each shared by the two MULs that
# use it) and its 2,676 adds and subtracts (B1's)
B1Q_LONG_ROW_OPS = 1724 * 7 + 2676
# the fixed path: frames of the 5.1 golden a run, frames of each half of
# the 5.1 -> 2.0 switch, frames traced by the profiler, frames the CLI
# decodes and encodes
FIXED_FRAMES, FIXED_SWITCH_FRAMES, PROFILE_FRAMES, CLI_FRAMES = (512, 32, 32,
                                                                 128)


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


def host_us(fn, reps=200):
    """Mean host microseconds of one fn() call: what it costs to enqueue
    (no synchronize between calls; a small call leaves the card idle)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    dt = time.perf_counter() - t0
    torch.cuda.synchronize()
    return dt / reps * 1e6


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


@contextlib.contextmanager
def accuracy(mode):
    """The package accuracy policy set to `mode` inside, restored after,
    so that the reference-mode phases run on the package default."""
    from ac3acm_tpu_torch.models import decoder as PD
    before = PD.ACCURACY
    PD.set_accuracy(mode)
    try:
        yield
    finally:
        PD.ACCURACY = before


# an instruction of cuobjdump's SASS listing: its address, a predicate,
# the opcode
SASS_OP = re.compile(
    r"/\*[0-9a-f]{4,5}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)")


def sass_functions(name, kernel):
    """The SASS listings (cuobjdump) of the functions of csrc/<name>.cu's
    built library whose name holds `kernel`; at least one."""
    from ac3acm_tpu_torch.ops import _cuda
    cuobjdump = os.path.join(os.path.dirname(_cuda._nvcc()), "cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass", _cuda.build(name)],
                          check=True, capture_output=True, text=True).stdout
    funcs = [f for f in sass.split("Function : ")[1:]
             if kernel in f.split("\n", 1)[0]]
    assert funcs, f"no {kernel} function in the SASS of {name}"
    return funcs


# an instruction of cuobjdump's SASS listing: its address and its text
SASS_LINE = re.compile(r"/\*([0-9a-f]{4,5})\*/\s+([^;]*);")


def b1f_pair_paths(func):
    """Instructions on a pair step's path in one B1F function's SASS (a
    cuobjdump listing), each block counted once as laid out: the step
    loop's head (from its top to the dispatch on the pair's kinds), the
    stub that picks the kind, that kind's pair transform, and the loop's
    tail (the OLA and stores, to the branch back); and the __syncwarp()s
    on it (a BRA.DIV each).  The layout read: the transforms' join E is
    the target of the most unconditional branches; the long pair is the
    code that falls into E, the short pair the code between the last two
    unconditional branches to E, after the stub that branches to the long
    one; the step loop is the innermost backward branch around E.
    -> {"long", "short", "syncs_long", "syncs_short", "function"}, or None
    where the listing is not laid out so."""
    ins = [(int(a, 16), t.strip()) for a, t in SASS_LINE.findall(func)]
    jumps = Counter(t.split()[1] for _, t in ins
                    if re.fullmatch(r"BRA 0x[0-9a-f]+", t))
    if not jumps:
        return None
    E = int(jumps.most_common(1)[0][0], 16)
    ends = sorted(a for a, t in ins if t == f"BRA {hex(E)}")
    target = lambda t: int(t.split("0x")[-1], 16)
    loops = [(a, target(t)) for a, t in ins
             if re.fullmatch(r"@!?U?P\w+ BRA 0x[0-9a-f]+", t)
             and target(t) < E < a]
    if len(ends) < 2 or not loops:
        return None
    back, top = min(loops, key=lambda lp: lp[0] - lp[1])
    s_short, s_long = ends[-2] + 16, ends[-1] + 16
    disp = [a for a, t in ins if a < s_short and t.startswith(("BRA", "@"))
            and "BRA" in t and target(t) == s_short]
    stub = [a for a, t in ins if s_short <= a < s_long and "BRA" in t
            and target(t) == s_long]
    if not disp or not stub:
        return None

    def tally(spans, what):
        return sum(lo <= a < hi and what(t) for lo, hi in spans
                   for a, t in ins)

    shared = [(top, disp[0] + 16), (s_short, stub[0] + 16), (E, back + 16)]
    paths = {"long": shared + [(s_long, E)],
             "short": shared + [(stub[0] + 16, s_long)]}
    out = {k: tally(v, lambda t: True) for k, v in paths.items()}
    out.update({f"syncs_{k}": tally(v, lambda t: t.startswith("BRA.DIV"))
                for k, v in paths.items()})
    out["function"] = len(ins)
    return out


def phase_build():
    from ac3acm_tpu_torch.host import native
    from ac3acm_tpu_torch.ops import _cuda
    jobs = {"native host (g++)": native._build,
            "fused_steady (nvcc)": lambda: _cuda.build("fused_steady"),
            "bitgather (nvcc)": lambda: _cuda.build("bitgather"),
            "imdct_exact (nvcc)": lambda: _cuda.build("imdct_exact"),
            "snr_search (nvcc)": lambda: _cuda.build("snr_search"),
            "pack (nvcc)": lambda: _cuda.build("pack"),
            "exponents (nvcc)": lambda: _cuda.build("exponents"),
            "quantize (nvcc)": lambda: _cuda.build("quantize"),
            "window_mdct (nvcc)": lambda: _cuda.build("window_mdct")}
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
            ln.strip() for ln in info.splitlines()
            if "ptxas" in ln or "spill" in ln))
        spills = [int(x) for ln in info.splitlines() if "spill" in ln
                  for x in re.findall(r"(\d+) bytes spill", ln)]
        assert spills and not any(spills), f"{name}: register spills"
    # B1 and B1F are exact only if no product was contracted into an add
    for kernel in ("imdct_exact_kernel", "fused_steady_exact_kernel"):
        funcs = sass_functions("imdct_exact", kernel)
        ops = {op: sum(len(re.findall(rf"\b{op}\b", f)) for f in funcs)
               for op in ("FFMA", "FMUL", "FADD")}
        # the static instruction mix of the first function, by class
        ins = [i.split(".")[0] for i in SASS_OP.findall(funcs[0])]
        mix = {c: sum(i in names for i in ins) for c, names in (
            ("float", ("FADD", "FMUL", "FMNMX", "FRND", "F2I")),
            ("integer", ("IMAD", "LOP3", "LEA", "IADD3", "SHF", "VIADD",
                         "ISETP", "SEL", "MOV")),
            ("shared", ("LDS", "STS", "LDGSTS")),
            ("global", ("LDG", "STG")))}
        log(f"sass {kernel} ({len(funcs)} function(s)): " + ", ".join(
            f"{op} {n}" for op, n in ops.items()) + f"; static mix of one: "
            f"{len(ins)} instructions, " + ", ".join(
                f"{c} {n}" for c, n in mix.items()))
        assert ops["FFMA"] == 0 and ops["FMUL"] > 0, (kernel, ops)
    # B1F's design model counts the instructions on its pair steps' paths
    for f in sass_functions("imdct_exact", "fused_steady_exact_kernel"):
        form = "int16" if "ILb1E" in f.split("\n", 1)[0] else "f32"
        B1F_SASS[form] = paths = b1f_pair_paths(f)
        log(f"sass fused_steady_exact_kernel {form}: " + (
            f"{paths['long']} instructions on a long pair step's path, "
            f"{paths['short']} on a short one's, {paths['syncs_long']} / "
            f"{paths['syncs_short']} __syncwarp; {paths['function']} in "
            f"the function" if paths else "the SASS layout is not the one "
            "b1f_pair_paths reads: no design model"))
    # M1's design model counts its kernel's instructions (m1_bound)
    funcs = sass_functions("window_mdct", "window_mdct_kernel")
    assert len(funcs) == 1, funcs
    ins = SASS_OP.findall(funcs[0])
    floats = [i for i in ins if i.split(".")[0] in (
        "FADD", "FMUL", "FFMA", "MUFU", "I2F", "F2I", "FSETP")]
    M1_SASS["window_mdct_kernel"] = len(ins)
    log(f"sass window_mdct_kernel: {len(ins)} instructions (the loop body "
        f"runs once a transform a warp), {sum(i.startswith('LDS') for i in ins)}"
        f" LDS, {sum(i.startswith('STS') for i in ins)} STS; float "
        f"instructions {len(floats)}")
    assert not floats, floats


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


def phase_check_ragged(dev):
    """K1 against its plain version where tiles are ragged: n around the
    64-row tile and the main path's 96, every plane count the formats
    give, odd chain counts, a non-zero carry in; each shape launched
    twice, the two results bitwise equal."""
    from ac3acm_tpu_torch.ops import fused_steady as FS
    rng = np.random.default_rng(3)
    B = 3
    worst, cworst = 0, 0.0
    for n in (1, 7, 63, 64, 65, 96, 384):
        for P in (1, 2, 3, 6):
            freq = torch.from_numpy((rng.standard_normal((B, n, P, 256))
                                     * 0.05).astype(np.float32)).to(dev)
            d0 = torch.from_numpy((rng.standard_normal((B, P, 128))
                                   * 0.05).astype(np.float32)).to(dev)
            bias = torch.full((B, n), 384.0, device=dev)
            pcm_k, dl_k = FS.fused_steady(freq, d0, bias)
            pcm_2, dl_2 = FS.fused_steady(freq, d0, bias)
            pcm_p, dl_p = FS.fused_steady_ref(freq, d0, bias)
            torch.cuda.synchronize()
            err = int((pcm_k.to(torch.int32)
                       - pcm_p.to(torch.int32)).abs().max())
            cerr = float((dl_k - dl_p).abs().max())
            assert err <= FS.PCM_LSB_TOL and cerr <= FS.CARRY_ATOL, \
                (n, P, err, cerr)
            assert torch.equal(pcm_k, pcm_2) and torch.equal(dl_k, dl_2), \
                f"two launches differ at n={n} P={P}"
            worst, cworst = max(worst, err), max(cworst, cerr)
    log(f"check fused_steady ragged shapes (n in 1..384 x P in 1..6, {B} "
        f"lanes, carry in): pcm max {worst} LSB, carry max {cworst:.3e}; "
        f"two launches bitwise equal on all 28 shapes")


def phase_check_gather_edges(dev):
    """K4 where its 8-slot groups are ragged: totals that are not
    multiples of 8, an index view that is not 16-byte aligned (the
    slot-by-slot branch), indices on and past both ends of the table."""
    from ac3acm_tpu_torch.ops import bitgather as BG
    rng = np.random.default_rng(5)
    table = torch.from_numpy(rng.integers(-32768, 32768, 65535)
                             .astype(np.int16)).to(dev)
    edge = np.array([-1, 65534, 65535, 70000, 0], np.int32)
    cases = 0
    for total in (1, 7, 8, 9, 8 * 1000 + 3):
        idx = ((rng.integers(0, 65535) + np.cumsum(
            rng.integers(0, 2, total + 1))) % 65535).astype(np.int32)
        idx[::5] = edge[np.arange(len(idx[::5])) % len(edge)]
        buf = torch.from_numpy(idx).to(dev)
        for off in (0, 1):
            view = buf[off:off + total].view(1, total)
            assert (view.data_ptr() % 16 == 0) == (off == 0)
            got = BG.extract_i16_table(table, view)
            want = BG.extract_i16_table_ref(table, view)
            torch.cuda.synchronize()
            assert torch.equal(got, want), (total, off)
            cases += 1
    log(f"check extract_i16_table edges: {cases} cases (totals 1, 7, 8, 9, "
        f"8003; aligned and offset views; indices outside the table) "
        f"bitwise equal to the plain version")


def phase_check_field_edges(dev):
    """K2 and K3 against their plain versions, bitwise, where the design
    has edges: rows whose slot count is not a multiple of 8 (scalar head
    and tail), offset and width views that are not 16-byte aligned (all
    slots one by one), frame rows of 3,840 B and of a length that is not
    a multiple of 16 (so row starts are unaligned and the stage takes a
    ragged first and last chunk), a row too wide to stage (read through
    L1, as the shared table is), fields on a row's last bits, past its
    end and at negative offsets, widths 0 and 16; the int32 and narrow
    wires on the same slots give identical fields; the shared form with
    unit=16 equals unit=1 at 16*d, on the orbit's size, a 262,144-byte
    table and the widest table int16 field indices reach (65,534 B), and
    takes a widths array of mixed widths 0..16 (0 included) on both width
    wires, at bit offsets and with unit=16, with int16 offsets too where
    the table allows them."""
    from ac3acm_tpu_torch.ops import bitgather as BG
    rng = np.random.default_rng(9)
    cases = 0

    def same(got, want, what):
        nonlocal cases
        torch.cuda.synchronize()
        assert got.dtype == torch.int16 and torch.equal(got, want), what
        cases += 1

    for MB, sizes in ((1, None), (13, None), (1001, None), (1792, None),
                      (3840, None), (50001, (9, 8 * 37 + 3))):
        for S in sizes or (1, 7, 9, 8 * 37 + 3, 7104):
            N = 5
            narrow = MB <= 4095         # int16 offsets reach bit 32,767
            data = torch.from_numpy(rng.integers(0, 256, (N, MB),
                                                 dtype=np.uint8)).to(dev)
            w = rng.integers(0, 17, (N, S)).astype(np.int32)
            w[:, ::5] = 0
            w[:, 1::5] = 16
            off = rng.integers(-40, 8 * MB + 40, (N, S)).astype(np.int32)
            off[:, 2::7] = 8 * MB - w[:, 2::7]           # ends on the last bit
            off[:, 3::7] = 8 * MB - 1                    # starts on it
            off[:, 4::11] = -w[:, 4::11]                 # ends before the row
            o32 = torch.from_numpy(off).to(dev)
            w32 = torch.from_numpy(w).to(dev)
            want = BG.extract_fields_ref(data, o32, w32)
            same(BG.extract_fields(data, o32, w32), want, (MB, S, "i32"))
            nd = torch.int16 if narrow else torch.int32
            same(BG.extract_fields(data, o32.to(nd), w32.to(torch.uint8)),
                 want, (MB, S, nd, "u8"))
            # unaligned views of the same slots (the slot-by-slot branch)
            for od, wd in ((torch.int32, torch.int32), (nd, torch.uint8)):
                ob = torch.zeros(N * S + 1, dtype=od, device=dev)
                wb = torch.zeros(N * S + 1, dtype=wd, device=dev)
                ob[1:] = o32.view(-1).to(od)
                wb[1:] = w32.view(-1).to(wd)
                ov, wv = ob[1:].view(N, S), wb[1:].view(N, S)
                assert ov.data_ptr() % 16 != 0 and wv.data_ptr() % 16 != 0
                same(BG.extract_fields(data, ov, wv), want,
                     (MB, S, od, "view"))
            # a data view whose rows start off 16-byte boundaries
            buf = torch.zeros(N * MB + 3, dtype=torch.uint8, device=dev)
            buf[3:] = data.view(-1)
            dv = buf[3:].view(N, MB)
            same(BG.extract_fields(dv, o32, w32), want, (MB, S, "data view"))
    # the shared form: the orbit's size and a wider table; unit=16
    # against unit=1
    for TB in (65534, 131070, 262144):
        table = torch.from_numpy(rng.integers(0, 256, TB,
                                              dtype=np.uint8)).to(dev)
        for N, S in ((3, 9), (300, 8 * 211 + 5)):
            d = rng.integers(-3, TB // 2 + 3, (N, S)).astype(np.int32)
            d_t = torch.from_numpy(d).to(dev)
            want = BG.extract_fields_shared_ref(table, d_t * 16)
            same(BG.extract_fields_shared(table, d_t * 16), want,
                 (TB, N, S, "unit 1"))
            same(BG.extract_fields_shared(table, d_t, unit=16), want,
                 (TB, N, S, "unit 16"))
            assert torch.equal(want, BG.extract_fields_shared_ref(
                table, d_t, unit=16))
            bits = torch.from_numpy(rng.integers(-20, 8 * TB + 20, (N, S))
                                    .astype(np.int32)).to(dev)
            same(BG.extract_fields_shared(table, bits),
                 BG.extract_fields_shared_ref(table, bits),
                 (TB, N, S, "bit offsets"))
            # the widths slot: mixed widths, 0 included
            w = rng.integers(0, 17, (N, S)).astype(np.int32)
            w[:, ::5] = 0
            w[:, 1::5] = 16
            w32 = torch.from_numpy(w).to(dev)
            want_b = BG.extract_fields_shared_ref(table, bits, w32)
            want_d = BG.extract_fields_shared_ref(table, d_t, w32, unit=16)
            assert torch.equal(want_d, BG.extract_fields_shared_ref(
                table, d_t * 16, w32))
            for wd in (torch.int32, torch.uint8):
                ww = w32.to(wd)
                same(BG.extract_fields_shared(table, bits, ww), want_b,
                     (TB, N, S, wd, "widths, bit offsets"))
                same(BG.extract_fields_shared(table, d_t, ww, unit=16),
                     want_d, (TB, N, S, wd, "widths, unit 16"))
                if TB <= 65534:
                    d16 = d_t.clamp(-32768, 32767).to(torch.int16)
                    same(BG.extract_fields_shared(table, d16, ww, unit=16),
                         want_d, (TB, N, S, wd, "widths, int16 unit 16"))
    log(f"check extract_fields / extract_fields_shared edges: {cases} cases "
        f"(rows of 1, 13, 1001, 1792, 3840 B x 1, 7, 9, 299, 7104 slots "
        f"and of 50,001 B, read through L1; int32 and int16/uint8 wires, "
        f"unaligned offset, width and data views; fields on, past and "
        f"before the row's ends, widths 0 and 16; 65,534-byte, orbit-size "
        f"and 262,144-byte tables, 3 and 300 rows, unit 16 vs 1, mixed "
        f"widths 0..16 on both width wires) bitwise equal to the plain "
        f"versions")


def b1_rows(rng, R):
    """R rows of 256 coefficients with the edge cases: +0 and -0 entries
    and rows, subnormals, near-full-scale values and a row of them."""
    x = (rng.standard_normal((R, 256)) * 0.05).astype(np.float32)
    x[::3, ::5] = -0.0
    x[1::3, ::7] = 0.0
    x[::4, 1::9] = rng.choice(np.array([1e-45, -1e-45, 1e-40, -3e-39],
                                       np.float32), x[::4, 1::9].shape)
    x[::5, 2::11] = rng.choice(np.array([0.99997, -0.99997, 1.0, -1.0],
                                        np.float32), x[::5, 2::11].shape)
    x[2::7] = np.where(rng.random((len(x[2::7]), 256)) < 0.5, 1.0, -1.0)
    x[0] = -0.0
    return x


def phase_check_b1(dev, bench_inputs):
    """B1 against its plain version on the card, BY VALUE (torch.equal;
    -0.0 and +0.0 are one value): long, short and mixed rows, ragged row
    counts, the edge-case rows of b1_rows, and the main path's first chunk
    of real premixed planes, long and with random short rows.
    -> (that chunk [4096, 96, 2, 256], max |kernel - plain|)."""
    from ac3acm_tpu_torch.ops import imdct_exact as IE
    rng = np.random.default_rng(13)
    cases, worst = 0, 0.0

    def same(x, blk, what):
        nonlocal cases, worst
        z, d = IE.split_fb_exact(x, blk)
        zr, dr = IE.split_fb_exact_ref(x, blk)
        torch.cuda.synchronize()
        err = max(float((z - zr).abs().max()), float((d - dr).abs().max()))
        worst = max(worst, err)
        assert torch.equal(z, zr) and torch.equal(d, dr), (what, err)
        cases += 1

    for R in (1, 2, 31, 1000):
        x = torch.from_numpy(b1_rows(rng, R)).to(dev)
        for tag, blk in (("long", None),
                         ("long flags", torch.zeros(R, dtype=torch.bool)),
                         ("short", torch.ones(R, dtype=torch.bool)),
                         ("mixed", torch.from_numpy(rng.random(R) < 0.5))):
            same(x, None if blk is None else blk.to(dev), (R, tag))
    freq = bench_inputs[0][:, :CHUNK_FRAMES * 6].contiguous()
    same(freq, None, "main-path chunk")
    same(freq, torch.rand(freq.shape[:-1], device=dev) < 0.3,
         "main-path chunk, 30% short rows")
    log(f"check imdct_exact: {cases} cases (1, 2, 31, 1000 rows x long, "
        f"long with flags, short, mixed, with +-0, subnormals and "
        f"near-full-scale values; the main path's first chunk "
        f"{tuple(freq.shape)} = {freq.numel() // 256} rows, long and 30% "
        f"short) equal to the plain version by value, max |diff| {worst}")
    return freq, worst


def phase_times_b1(freq):
    """B1 at the main path's chunk: kernel, plain version, and the fast
    mode's matmul of the same rows, beside the byte bound."""
    from ac3acm_tpu_torch.ops import imdct_exact as IE
    from ac3acm_tpu_torch.ops.filterbank import mats_on
    R = freq.numel() // 256
    before = IE.launches
    ms = cuda_ms(lambda: IE.split_fb_exact(freq))
    per_call = (IE.launches - before) / 9
    blk = torch.rand(freq.shape[:-1], device=freq.device) < 0.3
    ms_mixed = cuda_ms(lambda: IE.split_fb_exact(freq, blk))
    plain_ms = cuda_ms(lambda: IE.split_fb_exact_ref(freq), warmup=1, reps=3)
    flat, w_long = freq.view(R, 256), mats_on(freq.device)[0]
    library_ms = cuda_ms(lambda: torch.matmul(flat, w_long))
    # least work: each coefficient read once, z and d written once; the
    # FP32 operations of the split-radix replay
    nbytes = R * (256 + 256 + 128) * 4
    t_bytes = nbytes / PEAK_BYTES * 1e3
    t_ops = R * B1_LONG_ROW_FLOP / PEAK_FP32 * 1e3
    bound_ms = max(t_bytes, t_ops)
    bound_by = "bytes" if t_bytes >= t_ops else "operations"
    log(f"time imdct_exact [{R} long rows]: kernel_ms {ms:.3f} plain_ms "
        f"{plain_ms:.3f} library_ms(torch.matmul [{R},256]@[256,384], the "
        f"fast mode's product: NOT the same function bitwise) "
        f"{library_ms:.3f}; bounds: bytes {nbytes} B / 3.35e12 B/s = "
        f"{t_bytes:.3f} ms | FP32 operations {R * B1_LONG_ROW_FLOP:.4e} / "
        f"67e12 FLOP/s = {t_ops:.3f} ms; bound_ms {bound_ms:.3f} -> "
        f"{bound_by} ({bound_ms / ms:.0%} of the kernel's time, "
        f"{nbytes / (ms * 1e-3) / 1e12:.2f} TB/s); 30% short rows "
        f"{ms_mixed:.3f} ms; {per_call:g} launch per call")
    return dict(ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                bound_ms=bound_ms, bound_by=bound_by)


def b1f_case(rng, B, n, P, dev, short=0.0, scale=0.05):
    """Inputs of B1F: rows of b1_rows (+-0, subnormals, near-full-scale),
    every third block loud enough to clip at both int16 ends, blksw short
    with probability `short` per row (LFE, the last of 3 planes, long), a
    non-zero d0."""
    freq = b1_rows(rng, B * n * P).reshape(B, n, P, 256) * np.float32(
        scale / 0.05)
    freq[:, 1::3] *= np.float32(40.0)
    blk = rng.random((B, n, P)) < short
    if P == 3:
        blk[:, :, 2] = False
    d0 = (rng.standard_normal((B, P, 128)) * 0.05).astype(np.float32)
    to = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    return to(freq), (to(blk) if short else None), to(d0)


def phase_check_b1f(dev, bench_inputs, freq):
    """B1F against its plain version on the card: int16 PCM bitwise, f32 PCM
    and dlast by value (torch.equal).  The main path's first chunk (real
    premixed planes), all long and with 30% short (lane, block) flags
    uniform across its planes; ragged shapes B in {1, 3, 257} x n in {1, 2,
    7, 97} x P in {1, 2, 3} with the edge-case rows of b1_rows, rows that
    clip, a non-zero d0, short rows and LFE long; bias 0, 384 and one that
    varies per block; each case launched twice, bitwise equal.
    -> (max |kernel - plain| over the cases, the chunk's inputs)."""
    from ac3acm_tpu_torch.ops import fused_steady_exact as FE
    rng = np.random.default_rng(17)
    cases, worst = 0, 0.0

    def same(freq, blk, d0, bias, what):
        nonlocal cases, worst
        for dtype in (torch.int16, torch.float32):
            pcm, dl = FE.fused_steady_exact(freq, blk, d0, bias, dtype)
            pcm2, dl2 = FE.fused_steady_exact(freq, blk, d0, bias, dtype)
            pr, dr = FE.fused_steady_exact_ref(freq, blk, d0, bias, dtype)
            torch.cuda.synchronize()
            err = max(float((pcm.float() - pr.float()).abs().max()),
                      float((dl - dr).abs().max()))
            worst = max(worst, err)
            assert torch.equal(pcm, pr) and torch.equal(dl, dr), \
                (what, dtype, err)
            assert torch.equal(pcm.view(torch.int16 if dtype == torch.int16
                                        else torch.int32),
                               pcm2.view(torch.int16 if dtype == torch.int16
                                         else torch.int32)) \
                and torch.equal(dl.view(torch.int32), dl2.view(torch.int32)), \
                (what, dtype, "two launches differ")
            del pcm, pr, pcm2
            cases += 1

    B, n = freq.shape[:2]
    d0 = bench_inputs[1]
    bias = bench_inputs[2][:, :n].contiguous()
    vary = (384.0 + (torch.rand((B, n), device=dev) - 0.5) * 0.02)
    same(freq, None, d0, bias, "main-path chunk, long")
    blk = (torch.rand((B, n, 1), device=dev) < 0.3).expand(
        -1, -1, freq.shape[2]).contiguous()
    same(freq, blk, d0, vary, "main-path chunk, 30% short, varying bias")
    torch.cuda.empty_cache()
    for Bs in (1, 3, 257):
        for n_ in (1, 2, 7, 97):
            for P in (1, 2, 3):
                f, b, d = b1f_case(rng, Bs, n_, P, dev,
                                   short=0.3 if (Bs + n_ + P) % 2 else 0.0)
                for bias_kind in ("0", "384", "varying"):
                    bv = {"0": torch.zeros((Bs, n_), device=dev),
                          "384": torch.full((Bs, n_), 384.0, device=dev),
                          "varying": 384.0 + torch.from_numpy(
                              rng.standard_normal((Bs, n_)).astype(
                                  np.float32)).to(dev)}[bias_kind]
                    same(f, b, d, bv, (Bs, n_, P, bias_kind))
    log(f"check fused_steady_exact: {cases} cases (the main path's first "
        f"chunk {tuple(freq.shape)}, long and 30% short; B 1/3/257 x n "
        f"1/2/7/97 x P 1/2/3 with +-0, subnormals, clipping rows, short "
        f"rows, LFE long; bias 0/384/varying; int16 and f32) equal to the "
        f"plain version, PCM and dlast, max |diff| {worst}; every case "
        f"launched twice, bitwise equal")
    return worst, (freq, d0, bias)


def phase_times_b1f(inputs, b1_times):
    """B1F at the main path's chunk beside B1 + the eager epilogue it
    replaces, the eager epilogue alone, its plain version and the fast
    mode's matmul of the same rows, and its byte bound."""
    from ac3acm_tpu_torch.ops import fused_steady_exact as FE
    from ac3acm_tpu_torch.ops import imdct_exact as IE
    from ac3acm_tpu_torch.ops.filterbank import convert_to_int16, mats_on
    freq, d0, bias = inputs
    B, n, P, _ = freq.shape
    R, chains = B * n * P, B * P
    dev = freq.device
    _, _, win, win_r = mats_on(dev)
    blk = (torch.rand((B, n, 1), device=dev) < 0.3).expand(-1, -1, P) \
        .contiguous()

    def eager(z, d):
        # the steady body's chain, OLA and int16, as _pipeline_steady runs
        # them after B1
        dchain = torch.cat([d0[:, None], d[:, :-1]], dim=1)
        dfold = torch.cat([dchain, dchain.flip(-1)], dim=-1)
        return convert_to_int16(z * win + dfold * win_r
                                + bias[:, :, None, None]), d[:, -1]

    before = FE.launches
    ms = cuda_ms(lambda: FE.fused_steady_exact(freq, None, d0, bias))
    per_call = (FE.launches - before) / 9
    ms_f32 = cuda_ms(lambda: FE.fused_steady_exact(freq, None, d0, bias,
                                                   torch.float32))
    ms_short = cuda_ms(lambda: FE.fused_steady_exact(freq, blk, d0, bias))
    ms_b1 = cuda_ms(lambda: IE.split_fb_exact(freq))
    z, d = IE.split_fb_exact(freq)
    ms_eager = cuda_ms(lambda: eager(z, d))
    del z, d
    ms_b1_eager = cuda_ms(lambda: eager(*IE.split_fb_exact(freq)))
    plain_ms = cuda_ms(lambda: FE.fused_steady_exact_ref(freq, None, d0,
                                                         bias),
                       warmup=1, reps=3)
    # least work of the function: each coefficient read once, the PCM
    # written once, d0 read and dlast written once a chain, the bias once;
    # the transform's FP32 operations and 9 a sample for the OLA and int16
    def bytes_of(out_bytes):
        return R * 256 * (4 + out_bytes) + chains * 128 * 4 * 2 + B * n * 4

    nbytes, nbytes_f32 = bytes_of(2), bytes_of(4)
    flop = R * (B1_LONG_ROW_FLOP + 9 * 256)
    t_bytes = nbytes / PEAK_BYTES * 1e3
    t_ops = flop / PEAK_FP32 * 1e3
    bound_ms = max(t_bytes, t_ops)
    bound_by = "bytes" if t_bytes >= t_ops else "operations"
    t_f32 = max(nbytes_f32 / PEAK_BYTES * 1e3, t_ops)
    log(f"time fused_steady_exact [{B}x{n}x{P} = {R} long rows, {chains} "
        f"chains]: kernel_ms int16 {ms:.3f} | f32 {ms_f32:.3f} | int16 with "
        f"30% short rows {ms_short:.3f}; B1 alone {ms_b1:.3f} (the B1 timing "
        f"phase: {b1_times['ms']:.3f}); the eager epilogue alone (chain, "
        f"OLA, int16 after B1) {ms_eager:.3f}; B1 + eager epilogue "
        f"{ms_b1_eager:.3f}; plain_ms {plain_ms:.3f}; library_ms "
        f"(torch.matmul of the same rows, the fast mode's product: NOT the "
        f"same function bitwise) {b1_times['library_ms']:.3f}; bounds: bytes "
        f"{R} x 256 x (4 + 2) + {chains} x 1024 + {B * n} x 4 = {nbytes} B / "
        f"3.35e12 B/s = {t_bytes:.3f} ms | FP32 operations {flop:.4e} / "
        f"67e12 FLOP/s = {t_ops:.3f} ms; bound_ms {bound_ms:.3f} -> "
        f"{bound_by} ({bound_ms / ms:.0%} of the kernel's time, "
        f"{nbytes / (ms * 1e-3) / 1e12:.2f} TB/s); f32 bound {t_f32:.3f} ms "
        f"({nbytes_f32} B; {t_f32 / ms_f32:.0%}); B1F / (B1 + eager) "
        f"{ms / ms_b1_eager:.3f}; {per_call:g} launch per call")
    paths = B1F_SASS.get("int16")
    if paths:
        # a pair step transforms two rows; the 30% short chunk's pairs are
        # of one kind, 30% of them short
        rate = PEAK_ISSUE / 32
        model = R * paths["long"] / 2 / rate * 1e3
        model_short = R * (0.7 * paths["long"] + 0.3 * paths["short"]) \
            / 2 / rate * 1e3
        log(f"     fused_steady_exact design model (not bound_ms): "
            f"{paths['long']} SASS instructions a long pair step "
            f"({paths['long'] / 2:g} a row; a short pair step "
            f"{paths['short']}) x {R} rows at {rate:.4e} warp instructions/s "
            f"= {model:.3f} ms ({model / ms:.0%} of the kernel's time; the "
            f"30% short chunk {model_short:.3f} ms, {model_short / ms_short:.0%})"
            f", beside the byte bound {t_bytes:.3f} ms")
    else:
        log("     fused_steady_exact design model: none (phase_build did not "
            "recognize the SASS layout)")
    assert ms < ms_b1_eager, "B1F is not faster than B1 + eager epilogue"
    return dict(ms=ms, plain_ms=plain_ms, library_ms=b1_times["library_ms"],
                bound_ms=bound_ms, bound_by=bound_by)


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
    # least work of the FUNCTION: each input read once, each output written
    # once; the product's 2*256*384 operations per row, once, at the tensor
    # cores' rate for float32 operands (TF32).  How a design reaches the
    # 1-LSB contract on those cores (three passes over a hi/lo split) is
    # the design's cost, not the function's: the three-pass figures are
    # printed beside the bound, as is the FP32 pipes' (product plus 6
    # epilogue operations per output sample), the earlier design's bound.
    def least_bytes(n_):
        r = B * n_ * P
        return (r * 256 * 4 + B * P * 128 * 4 + B * n_ * 4 + 256 * 384 * 4
                + 256 * 4 + r * 256 * 2 + B * P * 128 * 4)

    nbytes = least_bytes(n)
    gemm = R * 2 * 256 * 384
    t_bytes = nbytes / PEAK_BYTES * 1e3
    t_tensor = gemm / PEAK_TF32 * 1e3
    t_simt = R * (2 * 256 * 384 + 6 * 256) / PEAK_FP32 * 1e3
    t_3tf32 = 3 * gemm / PEAK_TF32 * 1e3
    t_3bf16 = 3 * gemm / PEAK_BF16 * 1e3
    bound_ms = max(t_bytes, t_tensor)
    bound_by = "operations" if t_tensor > t_bytes else "bytes"
    log(f"time fused_steady [{B}x{n}x{P} rows={R}]: kernel_ms {ms:.3f} "
        f"plain_ms {plain_ms:.3f} library_ms(torch.matmul "
        f"[{R},256]@[256,384]) {library_ms:.3f}; bounds: bytes {nbytes} B / "
        f"3.35e12 B/s = {t_bytes:.3f} ms | tensor operations {gemm:.4e} "
        f"FLOP / 495e12 FLOP/s = {t_tensor:.3f} ms; bound_ms "
        f"{bound_ms:.3f} -> {bound_by} ({bound_ms / ms:.0%} of the kernel's "
        f"time); {per_call:g} launch per call")
    log(f"     fused_steady design bounds (not bound_ms): three TF32 passes "
        f"{t_3tf32:.3f} ms ({t_3tf32 / ms:.0%} of the kernel's time, "
        f"{3 * gemm / (ms * 1e-3) / 1e12:.1f} tensor TFLOP/s achieved) | "
        f"three bf16 passes at 989e12 FLOP/s {t_3bf16:.3f} ms | FP32 pipes "
        f"at 67e12 FLOP/s {t_simt:.3f} ms")
    # the native main path's own shape: one 16-frame chunk of 4096 lanes
    # (a 96-block chain is one full 64-row tile and half of another)
    n_main = CHUNK_FRAMES * 6
    f_main, b_main = freq[:, :n_main].contiguous(), \
        bias[:, :n_main].contiguous()
    ms_main = cuda_ms(lambda: FS.fused_steady(f_main, d0, b_main))
    t_main = max(least_bytes(n_main) / PEAK_BYTES * 1e3,
                 t_tensor * n_main / n)
    log(f"time fused_steady [{B}x{n_main}x{P}] (a main-path chunk): "
        f"kernel_ms {ms_main:.3f}, bound {t_main:.3f} ms "
        f"({t_main / ms_main:.0%}); three TF32 passes "
        f"{t_3tf32 * n_main / n:.3f} ms "
        f"({t_3tf32 * n_main / n / ms_main:.0%})")
    return dict(ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                bound_ms=bound_ms, bound_by=bound_by)


def golden_frames(path):
    """The frames of a golden stream, as a list of byte strings."""
    from ac3acm_tpu_torch.host.parse import syncinfo
    es = open(path, "rb").read()
    frames, pos = [], 0
    while pos + 7 <= len(es):
        size = syncinfo(es[pos:pos + 7])[0]
        assert size
        frames.append(es[pos:pos + size])
        pos += size
    return frames


def lane_streams(batch, nframes, path=GOLDEN, rotate=True):
    """Per-lane byte streams of golden frames; with rotate, lane i starts
    at frame i mod n (distinct lanes).  A stream whose frames lean on the
    state of the frame before (the coupling hazard stream) cannot start
    mid-stream: rotate=False gives every lane the stream from frame 0."""
    base = golden_frames(path)
    n = len(base)
    rots = [b"".join(base[i:] + base[:i]) * (nframes // n + 1)
            for i in range(n if rotate else 1)]
    return [rots[i % len(rots)][: nframes * len(base[0]) + 7]
            for i in range(batch)]


def decode(streams, compact, fused, counter=None):
    """One BatchedDecoder run; -> (chunks of device PCM, launches per
    chunk of counter() (default: the fused kernel's), seconds from the
    first parse to the last chunk on device)."""
    from ac3acm_tpu_torch import tables as T
    from ac3acm_tpu_torch.ops import fused_steady as FS
    from ac3acm_tpu_torch.parallel.pipeline import BatchedDecoder
    counter = counter or (lambda: FS.launches)
    dec = BatchedDecoder(len(streams), T.A52_STEREO | T.A52_ADJUST_LEVEL,
                         bias=384.0, emit_int16=True, parser="native",
                         compact_h2d=compact, fused=fused)
    for i, s in enumerate(streams):
        dec.feed(i, s)
    torch.cuda.synchronize()
    chunks, counts = [], []
    t0 = time.perf_counter()
    for _ in range(NCHUNKS):
        before = counter()
        r = dec.decode_available(max_frames=CHUNK_FRAMES)
        assert r is not None, "main path ran dry"
        pcm, valid = r
        assert valid.all() and pcm.shape == (len(streams), CHUNK_FRAMES * 6,
                                             2, 256), pcm.shape
        counts.append(counter() - before)
        chunks.append(pcm)
    torch.cuda.synchronize()
    return chunks, counts, time.perf_counter() - t0


def golden_i16(path):
    """The reference decoder's committed float output (bias 0) of a
    golden stream as int16 PCM [blocks, 2, 256]."""
    oracle = np.load(path + ".stereo_float.npy")
    return np.clip(np.round(oracle.reshape(-1, 2, 256).astype(np.float64)
                            * 32768.0), -32768, 32767)


def phase_main_path():
    """Fast mode; -> (K1 launches, the plain path's f32 chunks,
    x-realtime by compact_h2d)."""
    from ac3acm_tpu_torch import tables as T
    from ac3acm_tpu_torch.host.native import DenseBatchParser
    from ac3acm_tpu_torch.ops import fused_steady as FS
    streams = lane_streams(MAIN_BATCH, CHUNK_FRAMES * NCHUNKS)
    want = golden_i16(GOLDEN)                               # [48, 2, 256]
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
    plain_f32, rt = None, {}
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
        rt[compact] = blocks * 256 / 48000.0 / dt
        if not compact:
            plain_f32 = plain
        del plain, fused
    return launches, plain_f32, rt


# the raw-H2D gathers: port entry, kernel name in the report, the line of
# the TPU kernel's pallas_call in ac3acm_tpu/ops/bitgather.py
GATHER_KERNELS = (("extract_fields", "bitgather_fields (K2)", 247),
                  ("extract_fields_shared", "bitgather_shared (K3)", 306),
                  ("extract_i16_table", "bitgather_i16 (K4)", 142))
FLAGS_51_TO_20 = 2 | 32                       # A52_STEREO | A52_ADJUST_LEVEL


def gather_counts():
    from ac3acm_tpu_torch.ops import bitgather as BG
    return {"extract_fields": BG.launches_fields,
            "extract_fields_shared": BG.launches_shared,
            "extract_i16_table": BG.launches_i16}


def zero_gather_counts():
    from ac3acm_tpu_torch.ops import bitgather as BG
    BG.launches_fields = BG.launches_shared = BG.launches_i16 = 0


def raw_decoder(streams):
    from ac3acm_tpu_torch.parallel.pipeline import BatchedDecoder
    dec = BatchedDecoder(len(streams), FLAGS_51_TO_20, bias=384.0,
                         emit_int16=True, parser="raw")
    for i, s in enumerate(streams):
        dec.feed(i, s)
    return dec


def record_gathers(fn):
    """Run fn() with every gather entry recording its arguments (each call
    still launches its kernel); -> [(entry, args, kwargs)] in call
    order."""
    from ac3acm_tpu_torch.ops import bitgather as BG
    orig = {e: getattr(BG, e) for e, _, _ in GATHER_KERNELS}
    calls = []

    def wrap(entry):
        def call(*args, **kw):
            calls.append((entry, args, kw))
            return orig[entry](*args, **kw)
        return call

    for e in orig:
        setattr(BG, e, wrap(e))
    try:
        fn()
    finally:
        for e, f in orig.items():
            setattr(BG, e, f)
    return calls


# least bytes per slot each gather must move: its index at the narrowest
# type that holds it, and the int16 result.  A bit offset within one
# frame (at most 3,840 B, so < 32,768 bits) fits int16 and a width
# (0..16) int8; an orbit entry (65,535 of them) fits uint16
LEAST_SLOT_BYTES = {"extract_fields": 2 + 1 + 2,
                    "extract_fields_shared": 2 + 2,
                    "extract_i16_table": 2 + 2}


def gather_bound(entry, args):
    """-> (least bytes the call must move, bytes its wire moves, its wire
    per slot, bound ms): every slot at LEAST_SLOT_BYTES and each
    data/table byte once; the wire counts offsets, widths and results at
    their tensors' dtypes."""
    data, offsets = args[0], args[1]
    slots = offsets.numel()
    table = data.numel() * data.element_size()
    nbytes = slots * LEAST_SLOT_BYTES[entry] + table
    per_slot = offsets.element_size() + 2 + sum(
        a.element_size() for a in args[2:] if a is not None)
    return (nbytes, table + slots * per_slot, per_slot,
            nbytes / PEAK_BYTES * 1e3)


def field_table_i16(table):
    """The int16 entries a byte table holds as big-endian 16-bit fields."""
    pairs = table.view(-1, 2).to(torch.int32)
    return ((pairs[:, 0] << 8) | pairs[:, 1]).to(torch.int16)


def check_gather_calls(calls, tag, errs, wires):
    """Each recorded gather call (record_gathers) launched again and held
    to its plain version bitwise; the worst |diff| of each entry goes into
    errs, the wire dtypes into wires."""
    from ac3acm_tpu_torch.ops import bitgather as BG
    for i, (entry, args, kw) in enumerate(calls):
        got = getattr(BG, entry)(*args, **kw)
        want = getattr(BG, entry + "_ref")(*args, **kw)
        torch.cuda.synchronize()
        diff = (got.to(torch.int32) - want.to(torch.int32)).abs()
        mism, err = int((diff != 0).sum()), int(diff.max())
        errs[entry] = max(errs.get(entry, 0), err)
        wire = "/".join(str(a.dtype).replace("torch.", "")
                        for a in args[1:] if a is not None)
        wires.setdefault(entry, set()).add(wire)
        log(f"check {entry} {tag} call {i} offsets "
            f"{tuple(args[1].shape)} ({wire}{kw or ''}): {mism} "
            f"mismatches vs plain")
        assert mism == 0, (entry, tag, i, mism)
        del got, want, diff


def phase_raw_gathers():
    """Every gather of the raw unpack against its plain version, bitwise,
    at the raw paths' shapes; times of the K2 mantissa, K3 and K4 calls."""
    from ac3acm_tpu_torch.ops import bitgather as BG
    plain = {"extract_fields": BG.extract_fields_ref,
             "extract_fields_shared": BG.extract_fields_shared_ref,
             "extract_i16_table": BG.extract_i16_table_ref}
    timed, errs = {}, {e: 0 for e, _, _ in GATHER_KERNELS}
    wires = {}
    for tag, path, batch, nframes, rotate in (
            ("main", GOLDEN, MAIN_BATCH, RAW_CHUNK_FRAMES, True),
            ("coupling", CPL_GOLDEN, CPL_BATCH, CPL_CHUNK_FRAMES, False)):
        # one step of the decoder itself, its gathers' arguments recorded
        dec = raw_decoder(lane_streams(batch, nframes, path, rotate))
        calls = record_gathers(
            lambda: dec.decode_available(max_frames=nframes))
        del dec
        check_gather_calls(calls, tag, errs, wires)
        # time the largest call of each entry on its path
        for entry in {e for e, _, _ in calls}:
            args, kw = max(((a, k) for e, a, k in calls if e == entry),
                           key=lambda ak: ak[0][1].numel())
            if entry in timed or (entry == "extract_fields"
                                  and tag != "main"):
                continue
            nbytes, wire, per_slot, bound_ms = gather_bound(entry, args)
            ms = cuda_ms(lambda: getattr(BG, entry)(*args, **kw))
            plain_ms = cuda_ms(lambda: plain[entry](*args, **kw))
            library_ms = None
            if entry == "extract_i16_table":
                tab, idx = args           # same int32 indices, one call
                library_ms = cuda_ms(
                    lambda: torch.index_select(tab, 0, idx.view(-1)))
            elif entry == "extract_fields_shared":
                # the same function as one library call: the orbit as
                # int16 entries, indexed by the same int32 ordinals
                assert kw == {"unit": 16}, kw
                tab = field_table_i16(args[0])
                idx = args[1].view(-1)
                assert torch.equal(torch.index_select(tab, 0, idx),
                                   getattr(BG, entry)(*args, **kw).view(-1))
                library_ms = cuda_ms(lambda: torch.index_select(tab, 0, idx))
                del tab, idx
            timed[entry] = dict(ms=ms, plain_ms=plain_ms,
                                library_ms=library_ms, bound_ms=bound_ms,
                                bound_by="bytes")
            lib = "" if library_ms is None else \
                f" library_ms(torch.index_select) {library_ms:.3f}"
            log(f"time {entry} {tag} offsets {tuple(args[1].shape)}: "
                f"kernel_ms {ms:.3f} plain_ms {plain_ms:.3f}{lib} bound_ms "
                f"{bound_ms:.3f} = {nbytes} B (least, "
                f"{LEAST_SLOT_BYTES[entry]} B a slot) / 3.35e12 B/s -> "
                f"bytes; its wire ({per_slot} B a slot) moves {wire} B; "
                f"{nbytes / (ms * 1e-3) / 1e12:.2f} TB/s of the least bytes, "
                f"{wire / (ms * 1e-3) / 1e12:.2f} TB/s of its wire")
            if entry == "extract_fields":
                # the same slots on the int32 wire, for the record
                wide = (args[0], args[1].to(torch.int32),
                        args[2].to(torch.int32))
                _, wire32, per32, _ = gather_bound(entry, wide)
                ms32 = cuda_ms(lambda: BG.extract_fields(*wide))
                log(f"time {entry} {tag} offsets {tuple(args[1].shape)} on "
                    f"the int32 wire ({per32} B a slot, {wire32} B): kernel_ms "
                    f"{ms32:.3f}, {wire32 / (ms32 * 1e-3) / 1e12:.2f} TB/s "
                    f"of its wire")
                del wide
        del calls
        torch.cuda.empty_cache()
    for entry in timed:
        timed[entry]["max_abs_err"] = errs[entry]
    log("gather wires (offsets/widths): " + "; ".join(
        f"{e} {sorted(w)}" for e, w in wires.items()))
    return timed


def phase_raw_main(native_plain):
    """BatchedDecoder(parser="raw") on the main path's lanes; -> (the
    gathers' launch counts over its run, its int16 PCM [lanes, blocks, 2,
    256] on the card)."""
    from ac3acm_tpu_torch.host.native import (DenseBatchParser,
                                              SideinfoBatchParser)
    from ac3acm_tpu_torch.parallel.pipeline import StageClock
    dev = torch.device("cuda")
    nframes = RAW_CHUNK_FRAMES * NCHUNKS
    streams = lane_streams(MAIN_BATCH, nframes)
    blocks = MAIN_BATCH * nframes * 6
    rt = lambda dt: blocks * 256 / 48000.0 / dt
    # the host half alone: one native side-info parse of the same chunks
    parser = SideinfoBatchParser(MAIN_BATCH)
    pos = [0] * MAIN_BATCH
    t0 = time.perf_counter()
    for _ in range(NCHUNKS):
        r = parser.parse(list(zip(streams, pos)), RAW_CHUNK_FRAMES,
                         FLAGS_51_TO_20, 1.0, 384.0)
        pos = [p + int(c) for p, c in zip(pos, r["consumed"])]
    dt_parse = time.perf_counter() - t0
    del parser, r
    log(f"raw path: host side-info parse alone ({os.cpu_count()} CPUs): "
        f"{dt_parse:.3f} s -> {rt(dt_parse):.0f}x realtime")

    dec = raw_decoder(streams)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_gather_counts()                      # the raw main path's own run
    chunks, counts = [], []
    t0 = time.perf_counter()
    for _ in range(NCHUNKS):
        before = gather_counts()
        r = dec.decode_available(max_frames=RAW_CHUNK_FRAMES)
        assert r is not None, "raw path ran dry"
        pcm, valid = r
        assert valid.all() and pcm.shape == (MAIN_BATCH, RAW_CHUNK_FRAMES * 6,
                                             2, 256), pcm.shape
        counts.append({e: n - before[e] for e, n in gather_counts().items()})
        chunks.append(pcm)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = gather_counts()
    peak = torch.cuda.max_memory_allocated()
    for c in counts:
        assert c["extract_fields"] >= 1 and c["extract_i16_table"] >= 1, \
            f"a gather skipped a chunk: launches per chunk {counts}"
    assert peak <= PEAK_MEM_LIMIT, f"peak device memory {peak} B"
    raw = torch.cat(chunks, dim=1)
    del chunks, dec
    nat = torch.cat(native_plain, dim=1)[:, :raw.shape[1]]
    err = max_lsb(raw, nat)
    del nat
    assert err <= 1, f"raw vs native plain path: {err} LSB"
    want = golden_i16(GOLDEN)
    oerr = int(np.abs(raw[0, :48].cpu().numpy() - want).max())
    assert oerr <= 1, f"raw lane 0 vs reference oracle: {oerr} LSB"

    # the first chunk again, stage by stage (host clock, synchronized):
    # its dequantized planes vs the native dense parser's, and where a
    # chunk's time goes
    dec = raw_decoder(streams)
    clock = StageClock(dev)
    dec.decode_available(max_frames=RAW_CHUNK_FRAMES, clock=clock)
    blk, h2d = clock.kept["blocks"], clock.kept["h2d_bytes"]
    del dec
    log(f"raw path, one {RAW_CHUNK_FRAMES}-frame chunk by stage: " + ", ".join(
        f"{name} {sec:.3f} s" for name, sec in clock.seconds.items()))
    dense = DenseBatchParser(MAIN_BATCH).parse(
        streams, RAW_CHUNK_FRAMES, FLAGS_51_TO_20, 1.0, 384.0)["freq_full"]
    want_f = torch.from_numpy(dense).to(dev)
    del dense
    fmism = int((blk["freq"] != want_f).sum())
    bmism = int((blk["freq"].view(torch.int32)
                 != want_f.view(torch.int32)).sum())
    del blk, want_f
    per_frame = h2d / (MAIN_BATCH * RAW_CHUNK_FRAMES)
    log(f"raw path: {MAIN_BATCH} lanes x {NCHUNKS} chunks x "
        f"{RAW_CHUNK_FRAMES} frames per chunk; gather launches per chunk "
        f"{counts}; first chunk's freq vs the dense parser's freq_full: "
        f"{fmism} values / {bmism} bit patterns differ; PCM vs native "
        f"plain path max {err} LSB; lane 0 vs oracle max {oerr} LSB; "
        f"{dt:.3f} s -> {rt(dt):.0f}x realtime; H2D {per_frame:.1f} B per "
        f"frame (frame bytes + side info); peak device memory "
        f"{peak / 1e9:.2f} GB")
    assert fmism == 0 and bmism == 0
    return launches, raw


def phase_raw_k1(raw_pcm):
    """raw_batched_pipeline(pallas=True) -- the raw chunk unpacked, premixed
    on the card (premix_blocks_device) and decoded by K1 -- beside
    pallas=False (the plain fast steady tail) on the same chunks: the
    main path's lanes, chunks as BatchedDecoder(parser="raw") assembles
    them, already on the card.  Every chunk's PCM within PCM_LSB_TOL of
    the plain tail's and of phase_raw_main's decoder (raw_pcm), the carry
    after the last chunk by value, every K1 call held to its plain
    version, K1 once a chunk; x-realtime of the device half of both
    routes and the device time of each tail alone.  -> (K1 launches on
    the route's run, max |diff| of the recorded K1 calls in LSB)."""
    from ac3acm_tpu_torch.models.decoder import (_pipeline_steady,
                                                 premix_blocks_device)
    from ac3acm_tpu_torch.ops import fused_steady as FS
    from ac3acm_tpu_torch.ops.filterbank import convert_to_int16
    from ac3acm_tpu_torch.ops.unpack_device import (init_unpack_carry,
                                                    prune_raw_meta)
    from ac3acm_tpu_torch.parallel import pipeline as PL
    dev = torch.device("cuda")
    nframes = RAW_CHUNK_FRAMES * NCHUNKS
    dec = raw_decoder(lane_streams(MAIN_BATCH, nframes))
    on = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    chunks = []
    for _ in range(NCHUNKS):
        fmt, fu8, meta, ok = dec._raw_chunk(RAW_CHUNK_FRAMES)
        assert ok.all()
        meta = prune_raw_meta(meta)
        plan = dec._raw_plan(fmt, meta)
        assert plan["steady"] and plan["long_only"], plan
        bias = np.full((MAIN_BATCH, 6 * RAW_CHUNK_FRAMES), 384.0, np.float32)
        chunks.append((plan, on(fu8), {k: on(v) for k, v in meta.items()},
                       on(bias)))
    del dec
    audio_s = MAIN_BATCH * nframes * 1536 / 48000.0

    def route(pallas):
        carry = (init_unpack_carry(MAIN_BATCH, dev),
                 PL.init_batched_carry(MAIN_BATCH, device=dev))
        pcms = []
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for plan, fu8, meta, bias in chunks:
            fn = PL.raw_batched_pipeline(fmt, None, True, pallas=pallas,
                                         exact=None if pallas else False,
                                         **plan)
            carry, pcm = fn(carry, fu8, dict(meta), bias)
            pcms.append(pcm)
        torch.cuda.synchronize()
        return carry, pcms, audio_s / (time.perf_counter() - t0)

    plain_carry, plain, _ = route(False)
    with record_steady() as calls:
        FS.launches = 0                       # the route's own run
        carry, fused, _ = route(True)
        launches = FS.launches
    assert launches == NCHUNKS and len(calls) == NCHUNKS, (launches,
                                                           len(calls))
    assert all(k == "K1" for k, _ in calls), [k for k, _ in calls]
    worst = check_steady_calls(calls, "raw K1 tail")["K1"]
    del calls
    errs = [max_lsb(a, b) for a, b in zip(fused, plain)]
    derr = max_lsb(torch.cat(fused, dim=1), raw_pcm)
    assert max(errs) <= FS.PCM_LSB_TOL and derr <= FS.PCM_LSB_TOL, \
        (errs, derr)
    (u, (d, m)), (pu, (pd, pm)) = carry, plain_carry
    cerr = float((d - pd).abs().max())
    assert cerr <= FS.CARRY_ATOL and torch.equal(m, pm), cerr
    for k in u:
        assert torch.equal(u[k], pu[k]), k
    del fused, plain, carry, plain_carry
    # x-realtime of the device half, the two routes in turns
    rt = {True: [], False: []}
    for pallas in (False, True, True, False):
        rt[pallas].append(route(pallas)[2])
    # the tails alone on the first chunk's unpacked blocks (CUDA events)
    plan, fu8, meta, bias = chunks[0]
    clock = PL.StageClock(dev)
    carry0 = (init_unpack_carry(MAIN_BATCH, dev),
              PL.init_batched_carry(MAIN_BATCH, device=dev))
    PL.raw_batched_pipeline(fmt, None, True, exact=False, **plan)(
        carry0, fu8, dict(meta), bias, clock=clock)
    blocks = clock.kept.pop("blocks")
    dcarry = carry0[1]
    k1_tail = PL._fused_run(fmt)
    ms_k1 = cuda_ms(lambda: k1_tail(dcarry,
                                    premix_blocks_device(fmt, blocks)))
    ms_premix = cuda_ms(lambda: premix_blocks_device(fmt, blocks))
    ms_plain = cuda_ms(lambda: convert_to_int16(_pipeline_steady(
        fmt, dcarry, blocks, long_only=True, exact=False)[1]))
    del blocks, chunks
    xrt = {k: float(np.mean(v)) for k, v in rt.items()}
    log(f"raw K1 tail: raw_batched_pipeline(pallas=True) on {MAIN_BATCH} "
        f"lanes x {NCHUNKS} chunks x {RAW_CHUNK_FRAMES} frames; K1 launches "
        f"{launches} (one a chunk); K1 route vs plain tail per chunk "
        f"{errs} LSB, vs BatchedDecoder(parser=\"raw\") max {derr} LSB; "
        f"delay carry max |diff| {cerr:.3g}; recorded K1 calls vs plain "
        f"max {worst} LSB; device half (chunks on the card), x-realtime in "
        f"turns plain, K1, K1, plain: K1 route "
        f"{', '.join(f'{v:.0f}x' for v in rt[True])} (mean "
        f"{xrt[True]:.0f}x), plain tail "
        f"{', '.join(f'{v:.0f}x' for v in rt[False])} (mean "
        f"{xrt[False]:.0f}x); tail alone at a chunk (CUDA events, median of "
        f"7): premix + K1 {ms_k1:.3f} ms (the premix alone "
        f"{ms_premix:.3f} ms), plain steady tail + int16 {ms_plain:.3f} ms")
    return launches, worst


def phase_raw_coupling():
    """BatchedDecoder(parser="raw") on coupled lanes; -> the shared-table
    gather's launches over the run."""
    from ac3acm_tpu_torch.ops import bitgather as BG
    streams = lane_streams(CPL_BATCH, CPL_CHUNK_FRAMES * CPL_NCHUNKS,
                           CPL_GOLDEN, rotate=False)
    dec = raw_decoder(streams)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_gather_counts()                      # the coupling path's own run
    chunks, counts = [], []
    t0 = time.perf_counter()
    for _ in range(CPL_NCHUNKS):
        before = BG.launches_shared
        pcm, valid = dec.decode_available(max_frames=CPL_CHUNK_FRAMES)
        assert valid.all()
        counts.append(BG.launches_shared - before)
        chunks.append(pcm)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    assert all(c >= 1 for c in counts), \
        f"shared-table gather skipped a chunk: {counts}"
    peak = torch.cuda.max_memory_allocated()
    assert peak <= PEAK_MEM_LIMIT, f"peak device memory {peak} B"
    # the oracle is one pass of the stream decoded from frame 0
    want = golden_i16(CPL_GOLDEN)
    lane0 = chunks[0][0].cpu().numpy().astype(np.int64)
    oerr = int(np.abs(lane0[:len(want)] - want).max())
    audio_s = CPL_BATCH * CPL_NCHUNKS * CPL_CHUNK_FRAMES * 1536 / 48000.0
    log(f"coupling path: {CPL_BATCH} lanes x {CPL_NCHUNKS} chunks x "
        f"{CPL_CHUNK_FRAMES} frames of cpl51_hazard; shared-table launches "
        f"per chunk {counts}; lane 0 vs oracle max {oerr} LSB; {dt:.3f} s "
        f"-> {audio_s / dt:.0f}x realtime; peak device memory "
        f"{peak / 1e9:.2f} GB")
    assert oerr <= 1, f"coupling lane 0 vs reference oracle: {oerr} LSB"
    launches = BG.launches_shared
    del chunks, dec
    # the first chunk again, stage by stage
    from ac3acm_tpu_torch.parallel.pipeline import StageClock
    dec = raw_decoder(streams)
    clock = StageClock(torch.device("cuda"))
    dec.decode_available(max_frames=CPL_CHUNK_FRAMES, clock=clock)
    del dec
    clock.kept.clear()
    log(f"coupling path, one {CPL_CHUNK_FRAMES}-frame chunk by stage: "
        + ", ".join(f"{name} {sec:.3f} s"
                    for name, sec in clock.seconds.items()))
    return launches


def max_lsb(a, b):
    return int((a.to(torch.int32) - b.to(torch.int32)).abs().max())


def phase_ref_main(fast_plain, fast_rt):
    """The native main path with the package default ACCURACY="reference";
    -> (B1F launches over its run, its int16 chunks of the f32 run)."""
    from ac3acm_tpu_torch.models import decoder as PD
    from ac3acm_tpu_torch.ops import fused_steady as FS
    from ac3acm_tpu_torch.ops import fused_steady_exact as FE
    from ac3acm_tpu_torch.ops import imdct_exact as IE
    from ac3acm_tpu_torch.parallel.pipeline import BatchedDecoder
    assert PD.ACCURACY == "reference" and PD.default_exact()
    streams = lane_streams(MAIN_BATCH, CHUNK_FRAMES * NCHUNKS)
    blocks = MAIN_BATCH * CHUNK_FRAMES * NCHUNKS * 6
    launches, ref_f32 = 0, None
    for compact in (False, True):
        # the reference path's own run
        FS.launches = IE.launches = FE.launches = 0
        chunks, counts, dt = decode(streams, compact, fused=None,
                                    counter=lambda: FE.launches)
        assert FS.launches == 0, "the fused kernel ran in reference mode"
        assert IE.launches == 0, "B1 ran on a steady premixed chunk"
        assert all(c >= 1 for c in counts), \
            f"B1F skipped a chunk: launches per chunk {counts}"
        launches += FE.launches
        err = max(max_lsb(a, b) for a, b in zip(chunks, fast_plain))
        assert err <= 1, f"reference vs fast mode: {err} LSB"
        # the compact wire quantizes the planes to 16-bit block-float
        # mantissas: within 1 LSB of the f32 wire, not bit-exact
        vs_f32 = "" if ref_f32 is None else \
            f"; vs the f32 wire max {max(map(max_lsb, chunks, ref_f32))} LSB"
        if ref_f32 is None:
            ref_f32 = chunks
        rt = blocks * 256 / 48000.0 / dt
        log(f"reference main path compact_h2d={compact}: {MAIN_BATCH} lanes "
            f"x {NCHUNKS} chunks x {CHUNK_FRAMES} frames; B1F launches per "
            f"chunk {counts}, B1 0, K1 0; vs fast-mode PCM max {err} "
            f"LSB{vs_f32}; {dt:.3f} s -> {rt:.0f}x realtime (fast mode "
            f"{fast_rt[compact]:.0f}x in this run)")
    # float output at bias 0: every lane that starts at frame 0 against the
    # reference decoder's committed output, bit for bit
    oracle = np.load(GOLDEN + ".stereo_float.npy")            # [48, 512]
    dec = BatchedDecoder(256, FLAGS_51_TO_20, bias=0.0)
    for i, s in enumerate(lane_streams(256, 8)):
        dec.feed(i, s)
    before = FE.launches, IE.launches
    pcm, valid = dec.decode_available(max_frames=8)
    assert valid.all() and pcm.dtype == torch.float32
    assert (FE.launches - before[0], IE.launches - before[1]) == (1, 0), \
        "the float run did not go through B1F alone"
    lanes = pcm[::8].reshape(32, 48, 512).cpu().numpy()       # frame-0 lanes
    oerr = float(np.abs(lanes.astype(np.float64) - oracle).max())
    log(f"reference main path, 256 lanes x 8 frames, float at bias 0: the "
        f"32 lanes that start at frame 0 vs the reference decoder's output "
        f"max |diff| {oerr} (one B1F launch, f32 out)")
    assert oerr == 0.0
    return launches, ref_f32


def phase_ref_raw(ref_native):
    """parser="raw" on the main path's lanes in reference mode: int16 PCM
    equal to the reference native path's; -> B1F launches over its run."""
    from ac3acm_tpu_torch.models import decoder as PD
    from ac3acm_tpu_torch.ops import fused_steady_exact as FE
    from ac3acm_tpu_torch.ops import imdct_exact as IE
    from ac3acm_tpu_torch.parallel.pipeline import StageClock
    assert PD.ACCURACY == "reference"
    nframes = RAW_CHUNK_FRAMES * NCHUNKS
    streams = lane_streams(MAIN_BATCH, nframes)
    dec = raw_decoder(streams)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    IE.launches = FE.launches = 0             # the raw reference run's own
    chunks, counts = [], []
    t0 = time.perf_counter()
    for _ in range(NCHUNKS):
        before = FE.launches
        pcm, valid = dec.decode_available(max_frames=RAW_CHUNK_FRAMES)
        assert valid.all()
        counts.append(FE.launches - before)
        chunks.append(pcm)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    launches = FE.launches
    assert all(c >= 1 for c in counts), f"B1F skipped a chunk: {counts}"
    assert IE.launches == 0, "B1 ran on a steady raw chunk"
    err = max(max_lsb(a, b) for a, b in zip(chunks, ref_native))
    del chunks, dec
    rt = MAIN_BATCH * nframes * 1536 / 48000.0 / dt
    log(f"reference raw path: {MAIN_BATCH} lanes x {NCHUNKS} chunks x "
        f"{RAW_CHUNK_FRAMES} frames; B1F launches per chunk {counts}, B1 0; "
        f"PCM vs "
        f"the reference native path max {err} LSB; {dt:.3f} s -> {rt:.0f}x "
        f"realtime; peak device memory {peak / 1e9:.2f} GB")
    assert err == 0, f"raw vs native reference PCM: {err} LSB"
    assert peak <= PEAK_MEM_LIMIT, f"peak device memory {peak} B"
    dec = raw_decoder(streams)
    clock = StageClock(torch.device("cuda"))
    dec.decode_available(max_frames=RAW_CHUNK_FRAMES, clock=clock)
    del dec
    clock.kept.clear()
    log(f"reference raw path, one {RAW_CHUNK_FRAMES}-frame chunk by stage: "
        + ", ".join(f"{name} {sec:.3f} s"
                    for name, sec in clock.seconds.items()))
    return launches


@contextlib.contextmanager
def count_bodies():
    """Counts of the decode bodies the pipelines run inside the block:
    {"scan": _pipeline_body runs, "steady": _pipeline_steady runs}."""
    from ac3acm_tpu_torch.parallel import pipeline as P
    orig = {"scan": P._pipeline_body, "steady": P._pipeline_steady}
    runs = {k: 0 for k in orig}

    def wrap(key):
        def call(*args, **kw):
            runs[key] += 1
            return orig[key](*args, **kw)
        return call

    P._pipeline_body, P._pipeline_steady = wrap("scan"), wrap("steady")
    try:
        yield runs
    finally:
        P._pipeline_body, P._pipeline_steady = orig["scan"], orig["steady"]


def phase_general():
    """The coupling/short-block stream, every chunk through the block
    scan: both parsers in reference mode, the native one in fast mode;
    -> B1's launches over the reference runs (B1 on every chunk, B1F on
    none)."""
    from ac3acm_tpu_torch.models import decoder as PD
    from ac3acm_tpu_torch.ops import fused_steady_exact as FE
    from ac3acm_tpu_torch.ops import imdct_exact as IE
    from ac3acm_tpu_torch.parallel.pipeline import BatchedDecoder
    assert PD.ACCURACY == "reference"
    streams = lane_streams(GEN_BATCH, GEN_CHUNK_FRAMES * GEN_NCHUNKS,
                           SPEC_GOLDEN, rotate=False)
    outs, b1_launches = {}, 0
    IE.launches = FE.launches = 0             # the block scan's own runs
    for mode, parser in (("reference", "native"), ("reference", "raw"),
                         ("fast", "native")):
        with accuracy(mode), count_bodies() as runs:
            dec = BatchedDecoder(GEN_BATCH, FLAGS_51_TO_20, bias=0.0,
                                 parser=parser)
            for i, s in enumerate(streams):
                dec.feed(i, s)
            torch.cuda.synchronize()
            chunks, b1 = [], []
            t0 = time.perf_counter()
            for _ in range(GEN_NCHUNKS):
                before = IE.launches
                pcm, valid = dec.decode_available(max_frames=GEN_CHUNK_FRAMES)
                assert valid.all()
                b1.append(IE.launches - before)
                chunks.append(pcm)
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            del dec
        outs[mode, parser] = torch.cat(chunks, dim=1)
        del chunks
        assert runs == {"scan": GEN_NCHUNKS, "steady": 0}, runs
        if mode == "reference":
            assert all(c >= 1 for c in b1), f"B1 skipped a chunk: {b1}"
            b1_launches += sum(b1)
        else:
            assert sum(b1) == 0, b1
        assert FE.launches == 0, "B1F ran on a block-scan chunk"
        rt = GEN_BATCH * GEN_NCHUNKS * GEN_CHUNK_FRAMES * 1536 / 48000.0 / dt
        log(f"general decode {mode} parser={parser}: {GEN_BATCH} lanes x "
            f"{GEN_NCHUNKS} chunks x {GEN_CHUNK_FRAMES} frames of "
            f"spec_cpl51_hazard; block-scan runs {runs['scan']}, steady "
            f"runs {runs['steady']}, B1 launches per chunk {b1}, B1F 0; "
            f"{dt:.3f} s -> "
            f"{rt:.0f}x realtime")
    ref = outs["reference", "native"]
    oracle = np.load(SPEC_GOLDEN + ".stereo_float.npy")       # 4 frames
    lane0 = ref[0, :len(oracle)].reshape(-1, 512).cpu().numpy()
    oerr = float(np.abs(lane0.astype(np.float64) - oracle).max())
    raw_same = torch.equal(outs["reference", "raw"], ref)
    fast_err = float((outs["fast", "native"] - ref).abs().max()) * 32768.0
    log(f"general decode: lane 0 vs the reference decoder's output max "
        f"|diff| {oerr}; raw == native {raw_same}; fast vs reference max "
        f"{fast_err:.4f} LSB")
    assert oerr == 0.0 and raw_same and fast_err <= 1.0
    return b1_launches


def phase_mixed():
    """Lanes of three formats, some switching mid-stream, in reference
    mode: every lane equals its stream decoded in a homogeneous batch."""
    from ac3acm_tpu_torch.models import decoder as PD
    from ac3acm_tpu_torch.ops import fused_steady_exact as FE
    from ac3acm_tpu_torch.ops import imdct_exact as IE
    from ac3acm_tpu_torch.parallel.pipeline import BatchedDecoder
    assert PD.ACCURACY == "reference"
    nfr = MIX_CHUNK_FRAMES * MIX_NCHUNKS

    def cycle(fr, n):
        return b"".join(fr[j % len(fr)] for j in range(n))

    b51, st, mono = (golden_frames(p)
                     for p in (GOLDEN, STEREO_GOLDEN, MONO_GOLDEN))
    kinds = [cycle(b51, nfr), cycle(st, nfr), cycle(mono, nfr),
             cycle(b51, 3) + cycle(st, nfr - 3)]       # switch at frame 3
    kind = np.arange(MIX_BATCH) % 3
    kind[::48] = 3                                     # some 5.1 lanes switch

    def run(feeds):
        dec = BatchedDecoder(len(feeds), FLAGS_51_TO_20, bias=0.0)
        for i, s in enumerate(feeds):
            dec.feed(i, s)
        chunks = []
        for _ in range(MIX_NCHUNKS):
            pcm, valid = dec.decode_available(max_frames=MIX_CHUNK_FRAMES)
            assert valid.all()
            chunks.append(pcm)
        return torch.cat(chunks, dim=1)

    torch.cuda.synchronize()
    before = IE.launches, FE.launches
    t0 = time.perf_counter()
    mixed = run([kinds[k] for k in kind])
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    b1, b1f = IE.launches - before[0], FE.launches - before[1]
    # 5.1 -> 2.0 and 2.0 buckets are premixed (B1F); mono -> 2.0 is an
    # upmix, whose steady body runs B1
    assert b1 >= MIX_NCHUNKS and b1f >= MIX_NCHUNKS, (b1, b1f)
    same = []
    for k, feed in enumerate(kinds):
        want = run([feed] * 8)[0]
        lanes = torch.from_numpy(np.flatnonzero(kind == k)).to(mixed.device)
        same.append(bool((mixed[lanes] == want).all()))
    rt = MIX_BATCH * nfr * 1536 / 48000.0 / dt
    log(f"mixed formats: {MIX_BATCH} lanes (5.1 / 2.0 / 1.0 cycling, "
        f"{int((kind == 3).sum())} lanes switching 5.1 -> 2.0 at frame 3) x "
        f"{MIX_NCHUNKS} chunks x {MIX_CHUNK_FRAMES} frames, reference mode; "
        f"B1 launches {b1}, B1F {b1f}; each kind equal to its homogeneous "
        f"batch "
        f"{same}; {dt:.3f} s -> {rt:.0f}x realtime")
    assert all(same)


# ---------------------------------------------------------------------------
# The Python parser and the single-stream decode.  The Python parser walks
# every coefficient in Python on the host (tens of ms a frame; its
# side-info-only form a few), so these phases are sized by host time:
# one stream of SINGLE_FRAMES frames (16 s of audio), format-switch
# streams of 2 x SWITCH_FRAMES frames, PY_BATCH lanes of the python
# parsers, PY_MIX_BATCH lanes of mixed formats, PY_CPL_BATCH coupled lanes.
# ---------------------------------------------------------------------------

SINGLE_FRAMES, SWITCH_FRAMES, STREAM_FRAMES = 512, 24, 32
PY_BATCH, PY_NCHUNKS, PY_CHUNK_FRAMES = 64, 2, 4
PY_MIX_BATCH, PY_CPL_BATCH = 48, 4


def cycle(frames, n):
    return b"".join(frames[j % len(frames)] for j in range(n))


@contextlib.contextmanager
def record_b1():
    """The arguments of every split_fb_exact call the decode bodies make
    (each call still launches B1, once), cloned on the card."""
    from ac3acm_tpu_torch.models import decoder as PD
    orig = PD.split_fb_exact
    calls = []

    def call(coeffs, blksw=None):
        calls.append((coeffs.clone(),
                      None if blksw is None else blksw.clone()))
        return orig(coeffs, blksw)

    PD.split_fb_exact = call
    try:
        yield calls
    finally:
        PD.split_fb_exact = orig


def check_b1_calls(calls):
    """B1 against its plain version on recorded arguments, by value;
    -> (shapes, max |diff|)."""
    from ac3acm_tpu_torch.ops import imdct_exact as IE
    shapes, worst = set(), 0.0
    for x, blk in calls:
        z, d = IE.split_fb_exact(x, blk)
        zr, dr = IE.split_fb_exact_ref(x, blk)
        torch.cuda.synchronize()
        worst = max(worst, float((z - zr).abs().max()),
                    float((d - dr).abs().max()))
        assert torch.equal(z, zr) and torch.equal(d, dr), tuple(x.shape)
        shapes.add(tuple(x.shape[:-1]) + ("short" if blk is not None
                                          and bool(blk.any()) else "long",))
    return sorted(shapes), worst


@contextlib.contextmanager
def record_steady():
    """The arguments of every fused steady call batched_pipeline makes,
    B1F (fused_steady_exact) and K1 (fused_steady), cloned on the card
    (each call still launches its kernel, once) -> [(kernel, args)]."""
    from ac3acm_tpu_torch.parallel import pipeline as PL
    orig = {"B1F": PL.fused_steady_exact, "K1": PL.fused_steady}
    names = {"B1F": "fused_steady_exact", "K1": "fused_steady"}
    calls = []

    def wrap(kernel):
        def call(*args):
            calls.append((kernel, tuple(
                a.clone() if isinstance(a, torch.Tensor) else a
                for a in args)))
            return orig[kernel](*args)
        return call

    for k, name in names.items():
        setattr(PL, name, wrap(k))
    try:
        yield calls
    finally:
        for k, name in names.items():
            setattr(PL, name, orig[k])


def check_steady_calls(calls, tag):
    """Recorded B1F and K1 calls launched again and held to their plain
    versions: B1F int16 bitwise, f32 PCM and the carry by value; K1's PCM
    within PCM_LSB_TOL and its carry within CARRY_ATOL.  -> {kernel: max
    |kernel - plain| of the PCM (K1 in LSB)}."""
    from ac3acm_tpu_torch.ops import fused_steady as FS
    from ac3acm_tpu_torch.ops import fused_steady_exact as FE
    worst, shapes = {}, set()
    for kernel, args in calls:
        if kernel == "B1F":
            pcm, dl = FE.fused_steady_exact(*args)
            pr, dr = FE.fused_steady_exact_ref(*args)
        else:
            pcm, dl = FS.fused_steady(*args)
            pr, dr = FS.fused_steady_ref(*args)
        torch.cuda.synchronize()
        err = float((pcm.double() - pr.double()).abs().max())
        cerr = float((dl - dr).abs().max())
        if kernel == "B1F":
            ok = torch.equal(pcm, pr) and torch.equal(dl, dr)
            err = max(err, cerr)
        else:
            ok = err <= FS.PCM_LSB_TOL and cerr <= FS.CARRY_ATOL
        assert ok, (tag, kernel, tuple(args[0].shape), err, cerr)
        worst[kernel] = max(worst.get(kernel, 0.0), err)
        shapes.add((kernel, tuple(args[0].shape), str(pcm.dtype)[6:]))
    log(f"check {tag}: {len(calls)} recorded fused steady calls "
        f"{sorted(shapes)} against their plain versions (B1F int16 "
        f"bitwise, f32 and carry by value; K1 within {FS.PCM_LSB_TOL} LSB): "
        f"max |diff| {worst}")
    return worst


def kernel_counts():
    from ac3acm_tpu_torch.ops import fixed_chain as FC
    from ac3acm_tpu_torch.ops import fused_steady as FS
    from ac3acm_tpu_torch.ops import fused_steady_exact as FE
    from ac3acm_tpu_torch.ops import imdct_exact as IE
    from ac3acm_tpu_torch.ops import pack_device as PD
    from ac3acm_tpu_torch.ops import exponents as EX
    from ac3acm_tpu_torch.ops import quantize as QZ
    from ac3acm_tpu_torch.ops import snr_search as SS
    from ac3acm_tpu_torch.ops import window_mdct as WM
    return {"B1": IE.launches, "B1F": FE.launches, "K1": FS.launches,
            "B1Q": IE.launches_fixed, "B1QS": FC.launches_fixed_chain,
            "E1": SS.launches_snr_search, "P1": PD.launches_pack,
            "X1": EX.launches_exponents, "Q1": QZ.launches_quantize,
            "M1": WM.launches_window_mdct,
            **{k: v for k, v in gather_counts().items()}}


def zero_kernel_counts():
    from ac3acm_tpu_torch.ops import fixed_chain as FC
    from ac3acm_tpu_torch.ops import fused_steady as FS
    from ac3acm_tpu_torch.ops import fused_steady_exact as FE
    from ac3acm_tpu_torch.ops import imdct_exact as IE
    from ac3acm_tpu_torch.ops import pack_device as PD
    from ac3acm_tpu_torch.ops import exponents as EX
    from ac3acm_tpu_torch.ops import quantize as QZ
    from ac3acm_tpu_torch.ops import snr_search as SS
    from ac3acm_tpu_torch.ops import window_mdct as WM
    IE.launches = FE.launches = FS.launches = IE.launches_fixed = 0
    FC.launches_fixed_chain = SS.launches_snr_search = 0
    PD.launches_pack = EX.launches_exponents = QZ.launches_quantize = 0
    WM.launches_window_mdct = 0
    zero_gather_counts()


def single_stream(es, flags=FLAGS_51_TO_20, bias=0.0, drc=None):
    """One Decoder() run (the package default, reference mode) over es,
    its counts set to 0 just before; -> (pcm, NativeDecoder's pcm of the
    same stream, seconds, kernel counts, B1 calls recorded)."""
    from ac3acm_tpu_torch.host.native import NativeDecoder
    from ac3acm_tpu_torch.models.decoder import Decoder
    dec, nat = Decoder(), NativeDecoder()
    if drc == "off":
        dec.set_drc_enabled(False)
        nat.set_drc_enabled(False)
    elif drc is not None:
        dec.dynrng(drc)
        nat.set_dynrng_call(drc)
    torch.cuda.synchronize()
    with record_b1() as calls:
        zero_kernel_counts()
        t0 = time.perf_counter()
        pcm, _ = dec.decode_stream(es, flags, 1.0, bias)   # numpy: synced
        dt = time.perf_counter() - t0
        counts = kernel_counts()
    want = nat.decode_stream(es, flags, 1.0, bias)
    return pcm, want, dt, counts, calls


def decode_form(form, frames_bytes):
    """The Decoder's work over a one-format stream, in one of two forms:
    "per frame" (one block_pipeline call a frame, the JAX package's
    Decoder) or "grouped" (one call for the whole run of frames).  -> (PCM,
    host parse seconds, the rest in seconds: stacking, copies, device)."""
    from ac3acm_tpu_torch.host.parse import A52Parser
    from ac3acm_tpu_torch.models import decoder as PD
    parser, carry = A52Parser(), PD.init_carry()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    frames = [parser.decode_frame(fb, FLAGS_51_TO_20, 1.0, 0.0)
              for fb in frames_bytes]
    t1 = time.perf_counter()
    fmt = PD.frame_format(frames[0])
    assert all(PD.frame_format(f) == fmt for f in frames)
    if form == "grouped":
        carry, pcm = PD.block_pipeline(fmt)(carry, PD._stack_blocks(frames))
    else:
        outs = []
        for f in frames:
            carry, out = PD.block_pipeline(fmt)(carry, PD._stack_blocks([f]))
            outs.append(out)
        pcm = torch.cat(outs)
    pcm = pcm.cpu().numpy()
    return pcm, t1 - t0, time.perf_counter() - t1


def two_forms(b51, want):
    """The 16 s stream decoded per frame and grouped, in the order grouped,
    per frame, per frame, grouped, each equal to the Decoder's PCM; logs
    each run's x-realtime and its split."""
    audio_s = SINGLE_FRAMES * 1536 / 48000.0
    es = [b51[j % len(b51)] for j in range(SINGLE_FRAMES)]
    for form in ("grouped", "per frame", "per frame", "grouped"):
        pcm, parse_s, rest_s = decode_form(form, es)
        assert np.array_equal(pcm, want), form
        log(f"single stream, {form}: {SINGLE_FRAMES} frames "
            f"{parse_s + rest_s:.3f} s -> "
            f"{audio_s / (parse_s + rest_s):.2f}x realtime; host parse "
            f"{parse_s:.3f} s, the rest (stacking, copies, device) "
            f"{rest_s:.3f} s; == the Decoder's PCM True")


def phase_single():
    """Decoder() in the package default reference mode on the card (one
    block_pipeline call a frame, B1 on every frame): a 16 s stream of the
    5.1 golden frames, then streams that switch 5.1 -> 2.0 mid-stream with
    DRC off and with a DRC callback; then the 16 s stream timed per frame
    against one call for the whole run.  -> (B1 launches
    over the runs, max |B1 - plain| on the Decoder's own shapes)."""
    from ac3acm_tpu_torch.models import decoder as PD
    assert PD.ACCURACY == "reference"
    b51, st, cpl = (golden_frames(p) for p in (GOLDEN, STEREO_GOLDEN,
                                                 CPL_GOLDEN))
    es = cycle(b51, SINGLE_FRAMES)
    pcm, want, dt, counts, calls = single_stream(es)
    pcm_16s = pcm
    oracle = np.load(GOLDEN + ".stereo_float.npy")             # 8 frames
    oerr = float(np.abs(pcm[:48].reshape(48, 512).astype(np.float64)
                        - oracle).max())
    same = pcm.shape == want.shape and np.array_equal(pcm, want)
    audio_s = SINGLE_FRAMES * 1536 / 48000.0
    log(f"single stream: Decoder() reference mode, {SINGLE_FRAMES} frames "
        f"of bench_51_448 ({audio_s:.3f} s of audio): {dt:.3f} s -> "
        f"{audio_s / dt:.2f}x realtime; launches B1 {counts['B1']}, B1F "
        f"{counts['B1F']}, K1 {counts['K1']}; first 8 frames vs the "
        f"reference decoder's output max |diff| {oerr}; whole stream == "
        f"NativeDecoder {same}")
    assert oerr == 0.0 and same
    assert counts["B1"] >= SINGLE_FRAMES, counts        # every frame
    assert counts["B1F"] == counts["K1"] == 0, counts
    b1 = counts["B1"]
    b1_calls = calls
    switch = cycle(b51, SWITCH_FRAMES) + cycle(st, SWITCH_FRAMES)
    for tag, stream, drc in (
            ("DRC off", switch, "off"),
            ("DRC callback", b"".join(cpl) + switch,
             lambda r: r * np.float32(0.5) + np.float32(0.125))):
        pcm, want, dt, counts, calls = single_stream(stream, drc=drc)
        same = pcm.shape == want.shape and np.array_equal(pcm, want)
        nfr = len(pcm) // 6
        log(f"single stream, 5.1 -> 2.0 mid-stream, {tag}: {nfr} frames, "
            f"{dt:.3f} s -> {nfr * 1536 / 48000.0 / dt:.1f}x realtime; "
            f"launches B1 {counts['B1']}, B1F {counts['B1F']}, K1 "
            f"{counts['K1']}; == NativeDecoder {same}")
        assert same, tag
        assert counts["B1"] >= nfr, counts
        assert counts["B1F"] == counts["K1"] == 0, counts
        b1 += counts["B1"]
        b1_calls += calls
    shapes, worst = check_b1_calls(b1_calls)
    log(f"single stream: B1 on the Decoder's {len(b1_calls)} calls (rows "
        f"{shapes}) equal to its plain version, max |diff| {worst}")
    two_forms(b51, pcm_16s)
    return b1, worst


def phase_stream_layer():
    """Ac3ToPcmStream (exact and fast) fed in uneven pieces against the
    one-shot call, exact int16 against NativeDecoder through the same
    conversion; the a52 API against NativeDecoder.  -> B1 launches of the
    exact runs."""
    from ac3acm_tpu_torch import a52
    from ac3acm_tpu_torch.host.native import NativeDecoder
    from ac3acm_tpu_torch.io.stream import Ac3ToPcmStream
    b51, st = golden_frames(GOLDEN), golden_frames(STEREO_GOLDEN)
    es = cycle(b51, STREAM_FRAMES) + cycle(st, STREAM_FRAMES)
    nat = NativeDecoder().decode_stream(es, FLAGS_51_TO_20, 1.0, 384.0)
    nat_i16 = np.clip(np.round((nat.astype(np.float64) - 384.0) * 32768.0),
                      -32768, 32767).astype(np.int16)
    nat_i16 = nat_i16.transpose(0, 2, 1).reshape(-1, 2)
    b1 = 0
    for exact in (True, False):
        zero_kernel_counts()
        t0 = time.perf_counter()
        whole = Ac3ToPcmStream(2, exact=exact).convert(es)
        dt = time.perf_counter() - t0
        counts = kernel_counts()
        dec = Ac3ToPcmStream(2, exact=exact)
        parts = np.concatenate([dec.convert(es[:7]), dec.convert(es[7:1007]),
                                dec.convert(es[1007:])])
        same = np.array_equal(parts, whole)
        vs_native = np.array_equal(whole, nat_i16) if exact else \
            int(np.abs(whole.astype(np.int32) - nat_i16).max())
        log(f"stream layer Ac3ToPcmStream(exact={exact}): {2 * STREAM_FRAMES}"
            f" frames (5.1 then 2.0) {dt:.3f} s -> "
            f"{2 * STREAM_FRAMES * 1536 / 48000.0 / dt:.1f}x realtime; "
            f"pieces of 7 B, 1,000 B and the rest == one shot {same}; "
            + (f"int16 == NativeDecoder's through the same conversion "
               f"{vs_native}" if exact else
               f"vs NativeDecoder max {vs_native} LSB")
            + f"; launches B1 {counts['B1']}, B1F {counts['B1F']}, "
            f"K1 {counts['K1']}")
        assert same and whole.shape == nat_i16.shape
        if exact:
            assert vs_native is True and counts["B1"] >= 2, counts
            b1 += counts["B1"]
        else:
            assert vs_native <= 1 and counts["B1"] == 0, counts
        assert counts["B1F"] == counts["K1"] == 0, counts
    st_ = a52.a52_init(0)
    blocks, pos = [], 0
    while pos + 7 <= len(es):
        size = a52.a52_syncinfo(es[pos:pos + 7])[0]
        assert a52.a52_frame(st_, es[pos:pos + size], FLAGS_51_TO_20, 1.0,
                             384.0) == 0
        for _ in range(6):
            assert a52.a52_block(st_) == 0
            blocks.append(a52.a52_samples(st_).copy())
        pos += size
    a52.a52_free(st_)
    same = np.array_equal(np.stack(blocks), nat)
    log(f"stream layer a52_frame/a52_block/a52_samples over the stream == "
        f"NativeDecoder {same}")
    assert same
    return b1


def batched_run(parser, streams, flags=FLAGS_51_TO_20, bias=384.0,
                emit_int16=True, nchunks=PY_NCHUNKS,
                chunk_frames=PY_CHUNK_FRAMES, spy=None):
    """One BatchedDecoder run, its kernel counts set to 0 just before;
    -> (PCM of every chunk [L, blocks, nch, 256], launches per chunk,
    seconds)."""
    from ac3acm_tpu_torch.parallel.pipeline import BatchedDecoder
    dec = BatchedDecoder(len(streams), flags, bias=bias,
                         emit_int16=emit_int16, parser=parser)
    if spy is not None:
        orig = dec._raw_dispatch
        dec._raw_dispatch = lambda *a: spy(parser, *a) or orig(*a)
    for i, s in enumerate(streams):
        dec.feed(i, s)
    torch.cuda.synchronize()
    zero_kernel_counts()
    chunks, counts = [], []
    t0 = time.perf_counter()
    for _ in range(nchunks):
        before = kernel_counts()
        pcm, valid = dec.decode_available(max_frames=chunk_frames)
        assert valid.all(), parser
        counts.append({k: v - before[k] for k, v in kernel_counts().items()})
        chunks.append(pcm)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    return torch.cat(chunks, dim=1), counts, dt


def phase_python():
    """BatchedDecoder(parser="python") against parser="native" on the same
    lanes: reference int16 and float (B1F on every chunk), fast int16 (K1
    on every chunk), and a mixed-format batch (B1F or B1 on every chunk);
    every B1F, K1 and B1 call of the python runs held to its plain version.
    -> {kernel: max |kernel - plain|}."""
    from ac3acm_tpu_torch.models import decoder as PD
    nfr = PY_NCHUNKS * PY_CHUNK_FRAMES
    streams = lane_streams(PY_BATCH, nfr)
    audio_s = PY_BATCH * nfr * 1536 / 48000.0
    worst = {"B1F": 0.0, "K1": 0.0, "B1": 0.0}
    for mode, emit, kernel in (("reference", True, "B1F"),
                               ("reference", False, "B1F"),
                               ("fast", True, "K1")):
        with accuracy(mode):
            with record_steady() as calls:
                py, counts, dt = batched_run("python", streams,
                                             emit_int16=emit)
            nat, _, dt_n = batched_run("native", streams, emit_int16=emit)
        same = torch.equal(py, nat)
        per = [c[kernel] for c in counts]
        log(f"python parser, {mode} {'int16' if emit else 'float'}: "
            f"{PY_BATCH} lanes x {PY_NCHUNKS} chunks x {PY_CHUNK_FRAMES} "
            f"frames {dt:.3f} s -> {audio_s / dt:.1f}x realtime (native "
            f"{audio_s / dt_n:.0f}x); {kernel} launches per chunk {per}; "
            f"== parser='native' {same}")
        assert same and all(c >= 1 for c in per), (mode, emit, per)
        if mode == "reference":
            assert all(c["K1"] == 0 and c["B1"] == 0 for c in counts)
        else:
            assert all(c["B1F"] == 0 and c["B1"] == 0 for c in counts)
        assert len(calls) == sum(per), (len(calls), per)
        for k, v in check_steady_calls(
                calls, f"python parser {mode} "
                f"{'int16' if emit else 'float'}").items():
            worst[k] = max(worst[k], v)
        del calls
    assert PD.ACCURACY == "reference"
    b51, st, mono = (golden_frames(p)
                     for p in (GOLDEN, STEREO_GOLDEN, MONO_GOLDEN))
    kinds = [cycle(b51, nfr), cycle(st, nfr), cycle(mono, nfr),
             cycle(b51, 3) + cycle(st, nfr - 3)]
    kind = np.arange(PY_MIX_BATCH) % 3
    kind[::12] = 3
    feeds = [kinds[k] for k in kind]
    with record_steady() as calls, record_b1() as b1_calls:
        py, counts, dt = batched_run("python", feeds, bias=0.0,
                                     emit_int16=False)
    nat, _, _ = batched_run("native", feeds, bias=0.0, emit_int16=False)
    same = torch.equal(py, nat)
    log(f"python parser, mixed formats: {PY_MIX_BATCH} lanes (5.1 / 2.0 / "
        f"1.0, {int((kind == 3).sum())} switching 5.1 -> 2.0 at frame 3) x "
        f"{PY_NCHUNKS} chunks x {PY_CHUNK_FRAMES} frames, reference float; "
        f"launches per chunk B1 {[c['B1'] for c in counts]}, B1F "
        f"{[c['B1F'] for c in counts]}, K1 {[c['K1'] for c in counts]}; "
        f"== parser='native' {same}; {dt:.3f} s")
    assert same
    assert all(c["B1F"] + c["B1"] >= 1 and c["K1"] == 0 for c in counts), \
        counts
    assert len(calls) == sum(c["B1F"] for c in counts)
    worst["B1F"] = max(worst["B1F"],
                       check_steady_calls(calls, "python parser mixed")
                       .get("B1F", 0.0))
    shapes, err = check_b1_calls(b1_calls)
    worst["B1"] = max(worst["B1"], err)
    log(f"python parser, mixed formats: B1 on its {len(b1_calls)} calls "
        f"(rows {shapes}) equal to its plain version, max |diff| {err}")
    return worst


def phase_raw_py():
    """BatchedDecoder(parser="raw_py") against parser="raw": meta, frame
    bytes and int16 bitwise, K2 and K4 on every chunk; then coupled lanes
    (K3); every gather and B1F call of the raw_py runs held to its plain
    version.  -> {kernel or gather entry: max |kernel - plain|}."""
    seen = {}

    def spy(parser, fmt, fu8, meta, valid, clock=None):
        seen.setdefault(parser, []).append((fmt, fu8, meta))

    nfr = PY_NCHUNKS * PY_CHUNK_FRAMES
    errs, wires = {}, {}
    for tag, streams, want in (
            ("main", lane_streams(PY_BATCH, nfr),
             ("extract_fields", "extract_i16_table")),
            ("coupling", lane_streams(PY_CPL_BATCH, nfr, CPL_GOLDEN,
                                      rotate=False),
             ("extract_fields", "extract_fields_shared"))):
        seen.clear()
        out = {}
        with record_steady() as steady:
            gathers = record_gathers(lambda: out.update(
                run=batched_run("raw_py", streams, spy=spy)))
        py, counts, dt = out["run"]
        raw, _, dt_r = batched_run("raw", streams, spy=spy)
        same_pcm = torch.equal(py, raw)
        same_meta = len(seen["raw"]) == len(seen["raw_py"]) == PY_NCHUNKS
        for (f1, u1, m1), (f2, u2, m2) in zip(seen["raw"], seen["raw_py"]):
            same_meta &= f1 == f2 and np.array_equal(u1, u2) \
                and m1.keys() == m2.keys() and all(
                    m1[k].dtype == m2[k].dtype and np.array_equal(m1[k], m2[k])
                    for k in m1)
        per = {k: [c[k] for c in counts] for k in want}
        audio_s = len(streams) * nfr * 1536 / 48000.0
        log(f"raw_py, {tag}: {len(streams)} lanes x {PY_NCHUNKS} chunks x "
            f"{PY_CHUNK_FRAMES} frames {dt:.3f} s -> {audio_s / dt:.1f}x "
            f"realtime (raw {audio_s / dt_r:.0f}x); launches per chunk "
            f"{per}; meta and frame bytes == parser='raw' {same_meta}; "
            f"int16 == parser='raw' {same_pcm}")
        assert same_pcm and same_meta
        assert all(c >= 1 for v in per.values() for c in v), per
        assert len(gathers) == sum(sum(c[k] for c in counts)
                                   for k, _, _ in GATHER_KERNELS)
        check_gather_calls(gathers, f"raw_py {tag}", errs, wires)
        for k, v in check_steady_calls(steady, f"raw_py {tag}").items():
            errs[k] = max(errs.get(k, 0.0), v)
        del gathers, steady
    return errs


# ---------------------------------------------------------------------------
# the encoder and the transcode (ROADMAP A9 + A10)
# ---------------------------------------------------------------------------

# encoder digests: (channels, sample rate, kbit/s); lanes x frames, encoded
# in two calls of half the frames each (the carry crosses a call)
ENC_DIGEST_CONFIGS = ((2, 48000, 192), (6, 48000, 640), (1, 32000, 96),
                      (2, 44100, 128), (5, 48000, 448), (2, 24000, 96))
DIGEST_LANES, DIGEST_FRAMES = 8, 4
# sha256 of each config's lanes' bytes in lane order, from the JAX
# package's BatchedEncoder on the same PCM (tests/test_torch_pack.py
# recomputes every one)
ENC_DIGESTS = {
    (2, 48000, 192):
        "c2e5ca62a1e2f560230365c9c90cd632e7a1ff603ec6d9ee551da09f58fc3fdb",
    (6, 48000, 640):
        "b27234b407259919929944a30769ee472342688f823c039a4f445a207fee128c",
    (1, 32000, 96):
        "bfb2a9c4d517e7f61341a917b9636bdb565a07ec6dcd3dc5ad2756097a79d58f",
    (2, 44100, 128):
        "68769ccf28e51dd85ede40b687ef6dd921673eef3f793013d2ece9cb98c5048c",
    (5, 48000, 448):
        "8cfb21b6962ee49fb08fd1fc584fc638eb1c84fe2b3a91ca16354d061651ff4d",
    (2, 24000, 96):
        "d8552fdd8874411f48736fd3f72e760ee8d4af6b77e5a552c326654b1552e4c4",
}
# the JAX benchmark's configs 3 and 4 (bench.py:bench_encode, 1024 and 512
# lanes there) at the H100's memory: lanes, frames, channels, kbit/s
ENC_MAIN = (("config 3", 4096, 8, 2, 192), ("config 4", 2048, 8, 6, 640))
ENC_SINGLE_FRAMES = 512
# transcode (config 5, bench.py:bench_config5; 1024 x 4 frames there):
# lanes, chunks, frames per chunk; the coupled raw batch's lanes
TC_BATCH, TC_NCHUNKS, TC_CHUNK_FRAMES = 4096, 2, 4
TC_CPL_BATCH = 256
# sha256 of the first 8 lanes' re-encoded bytes (reference mode, native
# parser), from the JAX package's Transcoder (tests/test_torch_transcode.py)
TC_DIGEST = ("edb3f6e9b6fc932dbdeed9350fce642750f143c17b125085ebfcdf9e080a6edf")
TC_DIGEST_LANES = 8
# encoder stages in the order frame_core and pack_frames_device mark them
ENC_STAGES = ("block layout", "window + normalize + MDCT",
              "exponents + strategy + coding",
              "masking curve + SNR search + bap", "quantize", "csnr carry",
              "pack")


def mixed_pcm(nch, nframes, seed, lanes=1):
    """Seeded PCM [lanes, nframes*1536, nch] int16 (PCG64, the same on
    every machine) mixing tones, noise, silence and full-scale segments:
    exponent reuse, every strategy, grouped mantissas and overrange
    exponents all occur."""
    rng = np.random.default_rng(seed)
    n = nframes * 1536
    t = np.arange(n)[None, :, None]
    f = rng.uniform(40, 9000, (lanes, 1, nch))
    x = 0.5 * np.sin(2 * np.pi * f * t / 48000 + rng.uniform(0, 6, f.shape))
    x += rng.choice([0.0, 0.02, 0.3], (lanes, 1, nch)) \
        * rng.standard_normal((lanes, n, nch))
    x *= 20000
    seg = rng.integers(0, 4, (lanes, n // 256 + 1, 1))
    seg = np.repeat(seg, 256, axis=1)[:, :n]
    x = np.where(seg == 0, 0.0, x)                                # silence
    sq = np.where((t // 37) % 2 == 0, 32767.0, -32768.0)
    x = np.where(seg == 1, np.broadcast_to(sq, x.shape), x)       # full scale
    return np.clip(np.round(x), -32768, 32767).astype(np.int16)


def encode_digest(make_encoder, config):
    """sha256 of DIGEST_LANES lanes x DIGEST_FRAMES frames of mixed_pcm
    through make_encoder(lanes, rate, bit/s, channels).encode_frames, in
    two calls; -> (hex digest, the lanes' bytes)."""
    import hashlib
    nch, freq, kbps = config
    pcm = mixed_pcm(nch, DIGEST_FRAMES, nch * 7 + kbps + freq // 1000,
                    DIGEST_LANES)
    enc = make_encoder(DIGEST_LANES, freq, kbps * 1000, nch)
    half = DIGEST_FRAMES // 2 * 1536
    outs = [a + b for a, b in zip(enc.encode_frames(pcm[:, :half]),
                                  enc.encode_frames(pcm[:, half:]))]
    return hashlib.sha256(b"".join(outs)).hexdigest(), outs


def tc_chunks(lanes, path=GOLDEN, rotate=True):
    """Per chunk, per lane, the bytes of TC_CHUNK_FRAMES golden frames;
    with rotate, lane i starts at frame i mod n."""
    base = golden_frames(path)
    n = len(base)
    nfr = TC_NCHUNKS * TC_CHUNK_FRAMES
    per = [[base[((i % n if rotate else 0) + j) % n] for j in range(nfr)]
           for i in range(lanes)]
    return [[b"".join(fr[k * TC_CHUNK_FRAMES:(k + 1) * TC_CHUNK_FRAMES])
             for fr in per] for k in range(TC_NCHUNKS)]


def transcode_run(tc, chunks):
    """chunks (tc_chunks) through tc.step_frames; -> each lane's bytes."""
    outs = [b""] * len(chunks[0])
    for data in chunks:
        outs = [a + b for a, b in zip(outs, tc.step_frames(
            data, TC_CHUNK_FRAMES))]
    return outs


def tc_digest(outs):
    import hashlib
    return hashlib.sha256(b"".join(outs[:TC_DIGEST_LANES])).hexdigest()


class EventClock:
    """mark(name) records a CUDA event and the peak of device memory
    allocated since the mark before (the allocator's own count: no
    synchronize needed); ms() sums the time between each mark and the one
    before under the later mark's name, peak holds the largest peak by
    that name."""

    def __init__(self):
        self.peak = {}
        torch.cuda.reset_peak_memory_stats()
        self.events = [(None, self._event())]

    @staticmethod
    def _event():
        e = torch.cuda.Event(enable_timing=True)
        e.record()
        return e

    def mark(self, name):
        self.events.append((name, self._event()))
        self.peak[name] = max(self.peak.get(name, 0),
                              torch.cuda.max_memory_allocated())
        torch.cuda.reset_peak_memory_stats()

    def ms(self):
        torch.cuda.synchronize()
        out = {}
        for (_, a), (name, b) in zip(self.events, self.events[1:]):
            out[name] = out.get(name, 0.0) + a.elapsed_time(b)
        return out


class OpClock:
    """Counts the ATen ops dispatched between marks (each is a kernel
    launch or two at most, or none for a view), by the later mark's name."""

    def __init__(self):
        from torch.utils._python_dispatch import TorchDispatchMode
        clock = self

        class Count(TorchDispatchMode):
            def __torch_dispatch__(self, func, types, args=(), kwargs=None):
                clock.n += 1
                return func(*args, **(kwargs or {}))

        self.n, self.by, self.mode = 0, {}, Count()

    def mark(self, name):
        self.by[name] = self.by.get(name, 0) + self.n
        self.n = 0


def e1_least_bytes(rows, nb):
    """The least bytes of E1's function (the masking curve, the search and
    the bap) for `rows` lane-frames with live bins nb [ch]: on the live
    bins only (bins < nb, which are all it reads) an exponent a byte in
    and a class a byte out, avail in and M, fstar out (int32), and nb,
    is_lfe and hth once."""
    live = 6 * sum(max(0, min(int(n), 256)) for n in nb)
    return rows * (2 * live + 3 * 4) + len(nb) * 5 + 50 * 4


def stage_least_bytes(rows, nb, pack_bytes, quant_bytes):
    """Least bytes each encoder stage must move for `rows` lane-frames
    with live bins nb [ch]: its inputs read once and its outputs written
    once at the narrowest type that holds them, per (block, channel):
    samples int16, a coefficient int32 (up to 2^17), an exponent or the
    normalize's shift a byte;
    the fused curve + search + bap as e1_least_bytes prices it; the
    quantizer quant_bytes, q1_least_bytes (Q1's own bound) summed over
    the run's quantize calls; the pack pack_bytes, pack_least_bytes (P1's
    own bound) summed over the run's pack calls."""
    bc = rows * 6 * len(nb)
    s16, c32, b8 = 256 * 2, 256 * 4, 256
    return {
        "block layout": 2 * bc * s16,
        "window + normalize + MDCT": bc * (2 * s16 + c32 + 1),
        "exponents + strategy + coding": bc * (c32 + b8),
        "masking curve + SNR search + bap": e1_least_bytes(rows, nb),
        "quantize": quant_bytes,
        "csnr carry": 0,
        "pack": pack_bytes,
    }


# E1 (the masking curve + SNR search + bap) on crafted cases: the live
# bins of each channel (the encoder's 223 a full-band channel and 7 the
# LFE, for 1 to 6 channels with the last one the LFE or not, then edges:
# bins past 252, none, 32-bin group boundaries) with the LFE flag of the
# masking curve; each layout's hearing threshold is that of sample rate
# E1_LAYOUTS index mod 3 (fscod); the budget kinds each case's rows get
# (e1_budgets), rows a kind
E1_LAYOUTS = tuple(((223,) * (n - lfe) + (7,) * lfe, bool(lfe))
                   for n in range(1, 7) for lfe in (0, 1)) + (
    ((256,), False), ((253, 0), False), ((224, 225, 32, 33, 1, 7), True))
E1_KINDS = ("free", "none", "neg_fine", "coarse_tie", "fine_tie", "f15",
            "ceiling", "random")
E1_ROWS_A_KIND = 4
# the last channel's bins 0..6 on rows 2 mod 4: band 4 sets lowcomp to 384
# (a step of +256 to band 5), band 5 keeps it, and band 6, which a full-band
# channel lowers to 320 against a dead bin 7, keeps it on the LFE
E1_LFE_EXPS = (12, 10, 12, 10, 12, 10, 5)
# E1's design, per row: each of the 13 passes (12 candidates, then the
# bap) takes E1_SLOT_OPS integer instructions a live 32-bin slot (the
# exponent's and the entry's shared loads, the multiply-add, the max, the
# cost word's shared load, the add) and E1_BAND_OPS a threshold entry (51
# a block and channel, a lane's share rounded up to the warp: the
# subtract, the max, the and, the shift, the subtract from 4 ((3072 -
# floor) >> 5), the store); the prologue E1_FOLD_OPS a fold step of the
# band psd (the byte's load, the psd's shift and subtract, the subtract,
# abs, shift and min, LATAB's load, the max and the add) and E1_CURVE_OPS
# a band of the excitation and curve.  The function's own least work: one
# class a live bin (E1_CLASS_OPS: the subtract, the shift, two clamps, the
# table read), the log-add a fold step (E1_LOGADD_OPS: subtract, abs,
# shift, min, the table read, max, add) and E1_CURVE_OPS a band
E1_SLOT_OPS, E1_BAND_OPS, E1_FOLD_OPS, E1_CURVE_OPS = 6, 6, 10, 16
E1_CLASS_OPS, E1_LOGADD_OPS = 5, 7


def e1_exp(rng, rows, nb):
    """enc_exp [rows, 6, ch, 256] uint8: on the live bins even rows a
    per-channel level with +-4 of noise and a tilt, odd rows exponents
    uniform in [0, 24], rows 2 mod 4 E1_LFE_EXPS in the last channel's
    first bins; the dead bins any byte."""
    nb = np.asarray(nb)
    ch = len(nb)
    level = rng.integers(0, 25, (rows, 1, ch, 1))
    tilt = np.arange(256) // rng.integers(16, 64, (rows, 1, ch, 1))
    exp = np.clip(level + tilt + rng.integers(-4, 5, (rows, 6, ch, 256)),
                  0, 24)
    exp[1::2] = rng.integers(0, 25, exp[1::2].shape)
    exp[2::4, :, -1, :len(E1_LFE_EXPS)] = E1_LFE_EXPS
    live = np.arange(256) < nb[:, None]
    return np.where(live, exp, rng.integers(0, 256, exp.shape)).astype(
        np.uint8)


def e1_psd(exp, nb):
    """psd int32 of enc_exp (numpy): 3072 - 128 * exponent on the live
    bins, 0 past them (the frame core's)."""
    live = np.arange(256) < np.asarray(nb)[:, None]
    return np.where(live, 3072 - 128 * exp.astype(np.int32), 0).astype(
        np.int32)


def e1_grouped_bits(bap, nb, per="block"):
    """bap [rows, 6, ch, 256] -> mantissa bits [rows] (int64) with the
    grouped classes' ceilings taken per block after the channel sum (the
    encoder's, ac3enc.cpp:764-810), or per (block, channel) or per frame
    (the two granularities a kernel could get wrong)."""
    from ac3acm_tpu_torch import tables as T
    nb = np.asarray(nb)
    live = np.arange(256) < nb[:, None]
    nk = np.stack([((bap == k) & live).sum(-1) for k in range(16)],
                  -1).astype(np.int64)                     # [rows,6,ch,16]
    nk = {"block": nk.sum(2), "channel": nk, "frame": nk.sum((1, 2))}[per]
    k = np.arange(16)
    lin = np.where(k == 3, 3, np.where(k >= 5, T.BAP_BITS[k], 0))
    bits = (5 * ((nk[..., 1] + 2) // 3) + 7 * ((nk[..., 2] + 2) // 3)
            + 7 * ((nk[..., 4] + 1) // 2) + (nk * lin).sum(-1))
    return bits.reshape(len(bap), -1).sum(-1)


def e1_budgets(rng, nb, bap_at):
    """avail int32 [rows] for E1_ROWS_A_KIND rows of each of E1_KINDS, in
    that order; bap_at(snro int32 [rows]) -> that offset's bap (numpy):

      free        2^30: M = 63, fstar = 15
      none        -1: nothing fits, M = -1 and fstar = 0
      neg_fine    the bits at (c = -1, f in 1..15): M = -1 when (0, 0)
                  does not fit, the fine search at c = -1 still finds f
      coarse_tie  the bits at (c, 0): an exact tie, fstar = 0 when (c, 1)
                  costs more
      fine_tie    the bits at (c, f in 1..14): an exact tie in the fine pass
      f15         the bits at (c, 15): fstar = 15 when (c + 1, 0) costs more
      ceiling     even rows the bits at (c, 0), where ceilings taken per
                  (block, channel) overshoot; odd rows at (c, 0) with the
                  ceilings taken per frame, which the per-block count
                  overshoots
      random      uniform between the bits at (-1, 0) and at (63, 15)"""
    n = E1_ROWS_A_KIND * len(E1_KINDS)
    kind = np.repeat(np.arange(len(E1_KINDS)), E1_ROWS_A_KIND)
    c = rng.integers(0, 64, n)
    f = rng.integers(1, 15, n)

    def bits(c, f, per="block"):
        snro = ((np.broadcast_to(c, (n,)) - 15) * 16 + f) * 4
        return e1_grouped_bits(bap_at(snro.astype(np.int32)), nb, per)

    low, high = bits(-1, 0), bits(63, 15)
    by = {"free": np.full(n, 1 << 30), "none": np.full(n, -1),
          "neg_fine": bits(-1, f), "coarse_tie": bits(c, 0),
          "fine_tie": bits(c, f), "f15": bits(c, 15),
          "ceiling": np.where(np.arange(n) % 2 == 0, bits(c, 0),
                              bits(c, 0, "frame")),
          "random": rng.integers(low, high + 1)}
    return np.choose(kind, [by[k] for k in E1_KINDS]).astype(np.int32)


def e1_consts(nb, lfe, fscod, dev, halfratecod=0):
    """(nb int32 [ch], is_lfe bool [ch], hth int32 [50], halfratecod)
    for snr_search on dev; the last channel the LFE if lfe."""
    from ac3acm_tpu_torch import tables as T
    is_lfe = torch.zeros(len(nb), dtype=torch.bool, device=dev)
    is_lfe[-1] = lfe
    return (torch.tensor(nb, dtype=torch.int32, device=dev), is_lfe,
            torch.as_tensor(T.HTH[:, fscod].astype(np.int32), device=dev),
            halfratecod)


def e1_case(nb, lfe, fscod, seed, dev, halfratecod=0):
    """One crafted E1 case on dev: snr_search's arguments (enc_exp, avail,
    nb, is_lfe, hth, halfratecod), the rows E1_ROWS_A_KIND of each budget kind
    in E1_KINDS' order, the budgets priced on the plain curve."""
    from ac3acm_tpu_torch.ops import alloc as AL
    from ac3acm_tpu_torch.ops.snr_search import FLOOR, masking
    rng = np.random.default_rng(seed)
    exp = torch.from_numpy(e1_exp(rng, E1_ROWS_A_KIND * len(E1_KINDS),
                                  nb)).to(dev)
    consts = e1_consts(nb, lfe, fscod, dev, halfratecod)
    psd, mask = masking(exp, *consts)
    ends = consts[0].expand(psd.shape[:3])

    def bap_at(snro):
        s = torch.from_numpy(snro).to(dev)[:, None, None, None]
        return AL.bap_from_mask(psd, mask, s, FLOOR, torch.zeros_like(ends),
                                ends).cpu().numpy()

    avail = torch.from_numpy(e1_budgets(rng, nb, bap_at)).to(dev)
    return (exp, avail) + consts


def e1_same(call):
    """One recorded snr_search call (its six arguments, then (M, fstar,
    bap)) against mask_search_ref on the same inputs and device, bitwise
    -> max |diff| (0)."""
    from ac3acm_tpu_torch.ops.snr_search import mask_search_ref
    *args, got = call
    want = mask_search_ref(*args)
    err = max(int((g.long() - w.long()).abs().max()) if g.numel() else 0
              for g, w in zip(got, want))
    assert all(torch.equal(g, w) for g, w in zip(got, want)), err
    return float(err)


# the eager steps the encoder must not take on the card: the allocator's
# (E1's plain version, in ops.alloc), the exponent stage's (X1's, in
# ops.exponents), the quantizer's (Q1's, in ops.quantize) and the window,
# normalize and MDCT (M1's, in ops.mdct and where ops.window_mdct binds
# them)
E1_EAGER = ("band_psd", "excitation", "masking_curve", "bits_for_snro",
            "bap_from_mask")
X1_EAGER = ("extract_exponents", "strategy", "encode_exponents",
            "encode_exp_static")
Q1_EAGER = ("quantize_ref",)
M1_EAGER = ("window_norm_block", "mdct512", "_fft128")
CORE_EAGER = E1_EAGER + X1_EAGER + Q1_EAGER + M1_EAGER


@contextlib.contextmanager
def core_watch(record=False):
    """While active: the frame core's calls, M1's, E1's, X1's and Q1's
    launches, and the calls of the eager steps (CORE_EAGER: E1_EAGER in
    ops.alloc, X1_EAGER in ops.exponents, Q1_EAGER in ops.quantize,
    M1_EAGER in ops.mdct and ops.window_mdct) made inside a frame core (a
    raw decode allocates its own bits, outside it); with record, every
    window_mdct ("m1_calls": prev, cur, then the outputs as they came out,
    before X1 zeroes coefficients in place), snr_search ("calls"),
    exponents ("x1_calls": the coefficients as they came in, then the
    outputs and the coefficients after) and quantize ("q1_calls": its four
    tensors, then its codes, whose dtype says the width asked for) call's
    arguments and outputs, cloned.  Yields a dict that holds them (the
    launches when the block ends)."""
    from ac3acm_tpu_torch.models import encoder as PE
    from ac3acm_tpu_torch.ops import alloc as AL
    from ac3acm_tpu_torch.ops import exponents as EX
    from ac3acm_tpu_torch.ops import mdct as PM
    from ac3acm_tpu_torch.ops import quantize as QZ
    from ac3acm_tpu_torch.ops import snr_search as SS
    from ac3acm_tpu_torch.ops import window_mdct as WM
    eager = [(AL, k) for k in E1_EAGER] + [(EX, k) for k in X1_EAGER]
    eager += [(QZ, k) for k in Q1_EAGER] + [(PM, k) for k in M1_EAGER]
    eager += [(WM, k) for k in M1_EAGER if hasattr(WM, k)]
    w = dict(core=0, calls=[], x1_calls=[], q1_calls=[], m1_calls=[],
             **{k: 0 for k in CORE_EAGER})
    orig = dict(frame_core=PE.frame_core, snr_search=PE.snr_search,
                exponents=PE.exponents, window_mdct=PE.window_mdct,
                quantize=QZ.quantize)
    orig_eager = [getattr(m, k) for m, k in eager]
    inside = [False]

    def core(*a, **k):
        w["core"] += 1
        inside[0] = True
        try:
            return orig["frame_core"](*a, **k)
        finally:
            inside[0] = False

    def counted(key, fn):
        def call(*a, **k):
            w[key] += inside[0]
            return fn(*a, **k)
        return call

    def clones(ts):
        return tuple(t.clone() if torch.is_tensor(t) else t for t in ts)

    def m1(prev, cur):
        out = orig["window_mdct"](prev, cur)
        if record:
            w["m1_calls"].append(clones((prev, cur)) + (clones(out),))
        return out

    def search(*args):
        out = orig["snr_search"](*args)
        if record:
            w["calls"].append(clones(args) + (clones(out),))
        return out

    def exps(coef, *rest):
        before = coef.clone() if record else None
        out = orig["exponents"](coef, *rest)
        if record:
            w["x1_calls"].append((before,) + clones(rest)
                                 + (clones(out + (coef,)),))
        return out

    def quant(*args, **kw):
        out = orig["quantize"](*args, **kw)
        if record:
            w["q1_calls"].append(clones(args) + (out.clone(),))
        return out

    PE.frame_core, PE.snr_search, PE.exponents = core, search, exps
    PE.window_mdct = m1
    QZ.quantize = quant
    for (m, k), fn in zip(eager, orig_eager):
        setattr(m, k, counted(k, fn))
    before = {"M1": WM.launches_window_mdct, "E1": SS.launches_snr_search,
              "X1": EX.launches_exponents, "Q1": QZ.launches_quantize}
    try:
        yield w
    finally:
        for k, fn in orig.items():
            setattr(QZ if k == "quantize" else PE, k, fn)
        for (m, k), fn in zip(eager, orig_eager):
            setattr(m, k, fn)
        w["launches"] = {"M1": WM.launches_window_mdct - before["M1"],
                         "E1": SS.launches_snr_search - before["E1"],
                         "X1": EX.launches_exponents - before["X1"],
                         "Q1": QZ.launches_quantize - before["Q1"]}


def core_assert(w, tag):
    """Every core call of a watched run launched M1, E1, X1 and Q1 once
    each, and no frame core took an eager step -> the launches by
    kernel."""
    assert w["core"] >= 1 and all(
        n == w["core"] for n in w["launches"].values()), (
        tag, w["core"], w["launches"])
    assert not any(w[k] for k in CORE_EAGER), (tag, w)
    return w["launches"]


def e1_bound(enc_exp, nb):
    """E1 on enc_exp [N, 6, ch, 256]'s rows with live bins nb [ch]:
    (bound_ms, "bytes" | "operations", the design's floor ms).  The
    function's least bytes (e1_least_bytes); its least operations
    (E1_CLASS_OPS a live bin, E1_LOGADD_OPS a fold step, E1_CURVE_OPS a
    band) at the card's issue rate; the design's
    floor, its prologue and 13 passes (E1_FOLD_OPS, E1_CURVE_OPS,
    E1_SLOT_OPS, E1_BAND_OPS) at the same rate: a model of the design,
    not a measurement, so it stays on E1's log line and out of the kernels
    line."""
    from ac3acm_tpu_torch import tables as T
    N, _, ch, _ = enc_exp.shape
    nb = [int(n) for n in nb.tolist()]
    live = 6 * sum(max(0, min(n, 256)) for n in nb)
    # a fold step a live bin that is not its band's first
    folds = 6 * sum(max(0, min(int(f) + int(s), n) - int(f) - 1)
                    for n in nb for f, s in zip(T.BNDTAB[:50], T.BNDSZ[:50]))
    bands = 6 * ch * 50
    slots = 6 * sum(-(-max(0, min(n, 256)) // 32) * 32 for n in nb)
    entries = 6 * 32 * -(-ch * 51 // 32)
    t_bytes = e1_least_bytes(N, nb) / PEAK_BYTES * 1e3
    ops = N * (live * E1_CLASS_OPS + folds * E1_LOGADD_OPS
               + bands * E1_CURVE_OPS)
    t_ops = ops / PEAK_ISSUE * 1e3
    floor = N * (folds * E1_FOLD_OPS + bands * E1_CURVE_OPS
                 + 13 * (slots * E1_SLOT_OPS + entries * E1_BAND_OPS))
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops
            else "operations", floor / PEAK_ISSUE * 1e3)


def e1_times(call):
    """E1 and its plain version on one recorded core call's inputs:
    kernel_ms (device time, median of 7 after 2 warm-ups), plain_ms, the
    bound and the design's floor.  No PyTorch call computes the curve and
    the search: library_ms is null."""
    from ac3acm_tpu_torch.ops import snr_search as SS
    args = call[:6]
    ms = device_ms(lambda: SS.snr_search(*args))
    plain_ms = cuda_ms(lambda: SS.mask_search_ref(*args), warmup=1, reps=3)
    bound_ms, bound_by, floor_ms = e1_bound(args[0], args[2])
    return dict(ms=ms, plain_ms=plain_ms, library_ms=None, bound_ms=bound_ms,
                bound_by=bound_by, design_floor_ms=floor_ms)


def phase_check_e1(dev):
    """E1 (csrc/snr_search.cu) against its plain version BITWISE (M,
    fstar, bap) on the crafted cases (every layout of E1_LAYOUTS, every
    budget kind, the three sample rates' hearing thresholds; the 5.1
    layout again at halfratecod 1 and 2, the half-rate decays), twice each
    (the same bytes); one row, a ragged 1,000-row call, budgets near
    INT32_MIN and a call of no rows; bad inputs raise.  -> max |diff|."""
    from ac3acm_tpu_torch.ops import snr_search as SS
    worst, seen = 0.0, {}
    half = len(E1_LAYOUTS) - 4                      # 5.1 with the LFE
    cases = [(nb, lfe, i % 3, 1300 + i, 0)
             for i, (nb, lfe) in enumerate(E1_LAYOUTS)]
    cases += [(*E1_LAYOUTS[half], 0, 1400 + hr, hr) for hr in (1, 2)]
    for nb, lfe, fscod, seed, hr in cases:
        args = e1_case(nb, lfe, fscod, seed, dev, hr)
        if hr:
            # the half-rate decays do reach the curve of these rows
            full = SS.masking(*args[:1], *args[2:5], 0)[1]
            assert not torch.equal(SS.masking(*args[:1], *args[2:])[1],
                                   full), hr
        out = SS.snr_search(*args)
        worst = max(worst, e1_same(args + (out,)))
        again = SS.snr_search(*args)
        assert all(torch.equal(a, b) for a, b in zip(out, again)), nb
        M, fstar = (t.cpu().numpy().reshape(len(E1_KINDS), -1)
                    for t in out[:2])
        for k, name in enumerate(E1_KINDS):
            seen.setdefault(name, set()).update(
                zip(M[k].tolist(), fstar[k].tolist()))
    assert (63, 15) in seen["free"] and seen["none"] == {(-1, 0)}, seen
    assert any(m == -1 and f > 0 for m, f in seen["neg_fine"]), seen
    rng = np.random.default_rng(13)
    nb = (223, 223, 223, 7)
    consts = e1_consts(nb, True, 0, dev)
    for rows in (1, 1000):
        exp = torch.from_numpy(e1_exp(rng, rows, nb)).to(dev)
        avail = torch.from_numpy(rng.integers(0, 60000, rows).astype(
            np.int32)).to(dev)
        args = (exp, avail) + consts
        worst = max(worst, e1_same(args + (SS.snr_search(*args),)))
    # budgets within 3,000 of INT32_MIN: avail - bits wraps in int32
    near = torch.from_numpy((np.iinfo(np.int32).min + rng.integers(
        0, 3000, len(avail))).astype(np.int32)).to(dev)
    out = SS.snr_search(exp, near, *consts)
    worst = max(worst, e1_same((exp, near) + consts + (out,)))
    assert bool((out[0] > -1).any()), "no budget near INT32_MIN wrapped"
    before = SS.launches_snr_search
    M, fstar, bap = SS.snr_search(exp[:0], avail[:0], *consts)
    assert M.shape == (0,) and bap.shape == (0, 6, 4, 256)
    assert SS.launches_snr_search == before, "a call of no rows launched"
    flat = torch.zeros(exp.numel() + 16, dtype=torch.uint8, device=dev)
    for i, bad, err in (
            (0, exp.to(torch.int32), TypeError),
            (0, exp.transpose(0, 1).contiguous().transpose(0, 1), ValueError),
            (0, flat[1:1 + exp.numel()].view(exp.shape), ValueError),
            (0, exp[..., :255].contiguous(), ValueError),
            (1, avail[:-1], ValueError),
            (2, consts[0].cpu(), ValueError),
            (2, consts[0][:3], ValueError),
            (3, consts[1].to(torch.int32), TypeError),
            (4, consts[2][:49], ValueError),
            (5, 3, ValueError)):
        bad_args = list(args)
        bad_args[i] = bad
        try:
            SS.snr_search(*bad_args)
            raise AssertionError(f"bad argument {i} was accepted")
        except err:
            pass
    log(f"check snr_search (E1): {len(E1_LAYOUTS)} crafted layouts x "
        f"{len(E1_KINDS)} budget kinds x {E1_ROWS_A_KIND} rows at the three "
        f"sample rates' thresholds, and 5.1 at halfratecod 1 and 2 (each "
        f"launched twice, the same bytes), "
        f"one row, 1,000 rows and 1,000 budgets near INT32_MIN (wrapping), "
        f"equal to the plain version (masking + snr_search_ref) bitwise in "
        f"M, fstar and bap, max |diff| {worst}; (M, fstar) reached: free "
        f"{sorted(seen['free'])[:3]}, none {sorted(seen['none'])}, M = -1 "
        f"with a fine fit "
        f"{sorted(p for p in seen['neg_fine'] if p[0] == -1)[:3]}, f15 "
        f"{sorted(p for p in seen['f15'] if p[1] == 15)[:3]}; no rows: no "
        f"launch; a wrong dtype, a strided, an unaligned, a narrow, a "
        f"short, a CPU input, a short threshold and halfratecod 3 raise")
    return worst


# P1 (csrc/pack.cu, the device frame packer) on crafted fields: the
# configs (channels, sample rate, kbit/s): 1 to 6 channels, the LFE, the
# three sample rates, a half rate, the largest frame (3,840 bytes); the
# field kinds each config's rows get (p1_fields), P1_ROWS_A_KIND rows a
# kind
P1_CONFIGS = ((1, 48000, 64), (1, 32000, 96), (2, 48000, 192),
              (2, 44100, 128), (3, 44100, 256), (4, 48000, 384),
              (5, 32000, 448), (6, 48000, 640), (6, 32000, 640),
              (2, 24000, 96))
P1_KINDS = ("random", "grouped", "d15", "d25", "d45", "reuse", "fill",
            "dense", "edge", "overrun")
P1_ROWS_A_KIND = 3
# pack_frames_device's arguments after cfg, as the encoder's fields name
# them
P1_KEYS = ("bap", "qmant", "enc_exp", "strat", "csnroffst", "fsnroffst")
# the bits of each ungrouped class, and the codes a grouped member takes
P1_CLASS_BITS = {3: 3, **{c: c - 1 for c in range(5, 14)}, 14: 14, 15: 16}
P1_GROUP_LEVELS = {1: 3, 2: 5, 4: 11}


def p1_bits(cfg, f):
    """Each row's bit count (the plain version's token lengths summed)."""
    from ac3acm_tpu_torch.ops.pack_device import tokens
    lens, _ = tokens(cfg, *(torch.from_numpy(f[k]) for k in P1_KEYS))
    return lens.sum(dim=1).numpy()


def p1_fields(cfg, kind, rng, rows=P1_ROWS_A_KIND):
    """Crafted frame fields of one kind, numpy, keyed as P1_KEYS: dead bins
    (past nb) any byte or word; on the live bins exponents in [0, 24], a
    grouped class's codes in its range, an ungrouped class's any int32
    (masked to its bits).  Kinds: "random" every class and strategy (the
    LFE's D15 or reuse; block 0 never reused) and offsets any int32;
    "grouped" only classes 0, 1, 2 and 4 (groups straddle channels, a
    block's last group is incomplete); "d15", "d25", "d45" that strategy
    on every full-band channel of every block; "reuse" blocks 1-5 reused;
    "fill" a frame filled to its last payload bit; "overrun" a frame past
    its size; "dense" block 2 with a class on every live bin of every
    channel (14s and 15s first, then 1s until it fits: 14- and 16-bit
    tokens straddle words, every chunk is coded); "edge" 14s and 15s on the
    17 bins that end each channel's live bins (P1's 16-bin chunk that
    straddles the last live bin), dead bins 15.  All but "overrun" fit
    their frame."""
    nch, total = cfg.channels, cfg.frame_size * 2
    nb = np.asarray(cfg.nb_coefs)
    shape = (rows, 6, nch, 256)
    live = np.broadcast_to(np.arange(256) < nb[:, None], shape)
    cap = 8 * (total - 2)
    if kind == "grouped":
        cls = rng.choice([0, 1, 2, 4], shape, p=[0.1, 0.3, 0.3, 0.3])
    elif kind == "dense":
        cls = np.zeros(shape, np.int64)
        cls[:, 2] = rng.choice([14, 15, 1, 2, 4, 3, 9], (rows, nch, 256),
                               p=[0.3, 0.3, 0.1, 0.1, 0.1, 0.05, 0.05])
    elif kind == "edge":
        k = np.arange(256)
        near = (k >= nb[:, None] - 17) & (k < nb[:, None])
        cls = np.where(near, rng.choice([14, 15], shape), 0)
    else:
        dense = {"overrun": 1.0, "fill": 0.15}.get(
            kind, min(1.0, 0.6 * cap / (7.5 * live[0].sum())))
        cls = np.where(rng.random(shape) < dense,
                       rng.integers(1, 16, shape), 0)
    if kind == "overrun":
        cls = np.where(rng.random(shape) < 0.9, 15, cls)
    strat = rng.integers(0, 4, (rows, 6, nch))
    strat[:, 0] = rng.integers(1, 4, (rows, nch))
    if kind in ("d15", "d25", "d45"):
        strat[:] = {"d15": 1, "d25": 2, "d45": 3}[kind]
    if kind == "reuse":
        strat[:, 1:] = 0
    if cfg.lfe:
        strat[..., -1] = np.minimum(strat[..., -1], 1)
        strat[:, 0, -1] = 1
    f = dict(strat=strat.astype(np.int32),
             csnroffst=rng.integers(0, 64, rows).astype(np.int32),
             fsnroffst=rng.integers(0, 16, rows).astype(np.int32))
    if kind == "random":
        f["csnroffst"] = rng.integers(-2**31, 2**31, rows).astype(np.int32)
        f["fsnroffst"] = rng.integers(-2**31, 2**31, rows).astype(np.int32)

    def make(cls):
        code = rng.integers(-2**31, 2**31, shape)
        for c, levels in P1_GROUP_LEVELS.items():
            code = np.where(cls == c, rng.integers(0, levels, shape), code)
        dead = 15 if kind == "edge" else rng.integers(-128, 128, shape)
        f["bap"] = np.where(live, cls, dead).astype(np.int8)
        f["qmant"] = np.where(live, code, rng.integers(-2**31, 2**31, shape)
                              ).astype(np.int32)

    f["enc_exp"] = np.where(live, rng.integers(0, 25, shape),
                            rng.integers(0, 256, shape)).astype(np.uint8)
    make(np.zeros_like(cls))
    side = p1_bits(cfg, f)
    for blk in range(5, 0, -1):
        # the side info of a low rate's frame leaves room for mantissas
        # only with reused exponents: the last blocks first
        heavy = side > cap // 2
        f["strat"][heavy, blk] = 0
        side = p1_bits(cfg, f)
    make(cls)
    bits = p1_bits(cfg, f)
    while kind != "overrun" and (bits > cap).any():
        # thin the rows that overrun: drop a fifth of their classes (a
        # dense block's to class 1)
        over = (bits > cap)[:, None, None, None] & (rng.random(shape) < 0.2)
        if kind == "dense":
            cls = np.where(over & (cls != 1) & (cls != 0), 1, cls)
        else:
            cls = np.where(over, 0, cls)
        make(cls)
        bits = p1_bits(cfg, f)
    if kind == "fill":
        for r in range(rows):
            need = cap - int(bits[r])
            free = [tuple(i) for i in np.argwhere(live[r] & (cls[r] == 0))]
            rng.shuffle(free)
            put = []
            while need:
                if need in (1, 2):
                    # one 16-bit class back to 0 makes it 17 or 18
                    cls[(r,) + put.pop()] = 0
                    need += 16
                    continue
                if need >= 19 or need == 16:
                    c = 15
                elif need in (13, 15, 17):
                    c = 3
                elif need == 18:
                    c = 5
                else:
                    c = next(k for k, b in P1_CLASS_BITS.items()
                             if b == need)
                at = free.pop()
                cls[(r,) + at] = c
                if c == 15:
                    put.append(at)
                need -= P1_CLASS_BITS[c]
        make(cls)
        bits = p1_bits(cfg, f)
        assert (bits == cap).all(), (bits, cap)
    assert (bits > cap).all() if kind == "overrun" else (bits <= cap).all()
    return f


def p1_case(config, seed):
    """Every kind of p1_fields for config (channels, rate, kbit/s), rows
    stacked in P1_KINDS order: -> (cfg, fields)."""
    from ac3acm_tpu_torch.models.encoder import make_config
    nch, freq, kbps = config
    cfg = make_config(freq, kbps * 1000, nch)
    rng = np.random.default_rng(seed)
    parts = [p1_fields(cfg, kind, rng) for kind in P1_KINDS]
    return cfg, {k: np.concatenate([p[k] for p in parts]) for k in P1_KEYS}


# P1's least integer work: a live bin's class to its length, the mask,
# the offset's add, the shift and the or (P1_BIN_OPS); a CRC step a frame
# byte (P1_CRC_OPS: the table's read, the xor, the shift)
P1_BIN_OPS, P1_CRC_OPS = 5, 3


def pack_least_bytes(cfg, bap, strat):
    """The least bytes of the pack's function (P1's bound and the stage
    table's "pack" row) on one call's own fields (bap [..., 6, ch, 256],
    strat [..., 6, ch], any device): in, a live bin's class a byte and,
    where the class is not 0, its code at 16 bits (its narrowest; class 0
    carries no code); the exponents each (block, channel) codes, a byte
    each: 1 + 3 ng for its strategy's ng groups (a D15, D25 or D45 group
    codes three), none where it reuses; the strategies (int32) and the two
    offsets (int32); out, the frame's bytes."""
    from ac3acm_tpu_torch.ops.pack_device import _ngroups
    nch, dev = cfg.channels, bap.device
    nb = [max(0, min(int(n), 256)) for n in cfg.nb_coefs]
    bap = bap.reshape(-1, 6, nch, 256)
    rows = bap.shape[0]
    live = (torch.arange(256, device=dev)
            < torch.tensor(nb, device=dev)[:, None])
    coded = int(((bap != 0) & live).sum())
    ng = torch.tensor([[0] + [max(_ngroups(n, gs), 0) for gs in (1, 2, 4)]
                       for n in nb], device=dev)
    s = strat.reshape(-1, 6, nch).long()
    exps = int(torch.where(s > 0, 1 + 3 * ng[torch.arange(nch, device=dev),
                                             s], 0).sum())
    fixed = 6 * sum(nb) + 6 * nch * 4 + 8 + cfg.frame_size * 2
    return rows * fixed + 2 * coded + exps


def p1_bound(cfg, bap, strat):
    """P1 on one call's fields: (bound_ms, "bytes" | "operations"):
    pack_least_bytes at the card's memory rate against P1_BIN_OPS a live
    bin and P1_CRC_OPS a frame byte at its issue rate."""
    rows = bap.numel() // (6 * cfg.channels * 256)
    total = cfg.frame_size * 2
    live = 6 * sum(int(n) for n in cfg.nb_coefs)
    t_bytes = pack_least_bytes(cfg, bap, strat) / PEAK_BYTES * 1e3
    t_ops = rows * (live * P1_BIN_OPS + total * P1_CRC_OPS) / PEAK_ISSUE * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def p1_other_codes(args):
    """pack_frames_device's six fields with the codes in the other width:
    int16 codes widened as unsigned to int32, int32 ones cut to int16."""
    from ac3acm_tpu_torch.ops.quantize import code_bits
    q = args[1]
    return [args[0], code_bits(q) if q.dtype == torch.int16
            else as_int16(q)] + list(args[2:])


def p1_same(call):
    """One recorded pack_frames_device call (cfg, its six fields, then its
    frames) against pack_frames_ref on the same inputs and device, byte
    for byte, and against P1 given the codes in the other width (int32
    beside the device-pack path's int16) -> 0.0."""
    from ac3acm_tpu_torch.ops import pack_device as PD
    cfg, *args, got = call
    for tag, want in (
            ("pack_frames_ref", PD.pack_frames_ref(cfg, *args)),
            ("P1 on the other code width",
             PD.pack_frames_device(cfg, *p1_other_codes(args)))):
        if not torch.equal(got, want):
            bad = (got != want).reshape(-1, got.shape[-1]).any(-1)
            raise AssertionError(f"P1 ({args[1].dtype} codes) != {tag} on "
                                 f"{int(bad.sum())} of {bad.numel()} "
                                 f"frames, first {int(bad.nonzero()[0])}")
    return 0.0


@contextlib.contextmanager
def p1_watch(record=False):
    """While active: the pack_frames_device calls (the encoder imports it
    from its module at each call) and P1's launches; with record, each
    call's cfg, fields and frames, cloned.  Yields a dict that holds them
    (launches when the block ends)."""
    from ac3acm_tpu_torch.ops import pack_device as PD
    w = dict(n=0, calls=[])
    orig = PD.pack_frames_device

    def pack(*a, **k):
        out = orig(*a, **k)
        w["n"] += 1
        if record:
            w["calls"].append((a[0],) + tuple(t.clone() for t in a[1:7])
                              + (out.clone(),))
        return out

    PD.pack_frames_device = pack
    before = PD.launches_pack
    try:
        yield w
    finally:
        PD.pack_frames_device = orig
        w["launches"] = PD.launches_pack - before


def p1_frames(call):
    """The frames of one recorded pack_frames_device call (every leading
    axis of its fields)."""
    cfg, bap = call[0], call[1]
    return bap.numel() // (6 * cfg.channels * 256)


def p1_times(call):
    """P1 and its plain version on one recorded call's inputs: ms (device
    time, median of 7 after 2 warm-ups) on its codes as recorded (the
    device-pack path's int16), ms_int32 on the same codes as int32 (JAX's
    calling form), plain_ms (the eager chain), the bound; codes names the
    width ms times (int16 since it reads them; before, ms was int32, which
    ms_int32 continues).  No PyTorch call packs frames: library_ms is
    null."""
    from ac3acm_tpu_torch.ops import pack_device as PD
    cfg, *args, _ = call
    a16, a32 = ((args, p1_other_codes(args)) if args[1].dtype == torch.int16
                else (p1_other_codes(args), args))
    ms = device_ms(lambda: PD.pack_frames_device(cfg, *a16))
    ms_int32 = device_ms(lambda: PD.pack_frames_device(cfg, *a32))
    plain_ms = cuda_ms(lambda: PD.pack_frames_ref(cfg, *args), warmup=1,
                       reps=3)
    bound_ms, bound_by = p1_bound(cfg, args[0], args[3])
    return dict(ms=ms, ms_int32=ms_int32, codes="int16", plain_ms=plain_ms,
                library_ms=None, bound_ms=bound_ms, bound_by=bound_by)


def phase_check_p1(dev):
    """P1 (csrc/pack.cu) against its plain version and the native packer
    BYTE FOR BYTE on the crafted cases (every config of P1_CONFIGS x every
    kind of P1_KINDS, the overrun frames included), with int32 codes and
    with their int16 form (half of them negative as int16), each launched
    twice (the same bytes, in both widths); leading axes [2, n/2]; a call
    of no frames (no launch); bad inputs raise.  -> max |diff| (0)."""
    from ac3acm_tpu_torch.host import pack as PK
    from ac3acm_tpu_torch.ops import pack_device as PD
    frames = 0
    for i, config in enumerate(P1_CONFIGS):
        cfg, f = p1_case(config, 1500 + i)
        args = [torch.from_numpy(f[k]).to(dev) for k in P1_KEYS]
        before = PD.launches_pack
        out = PD.pack_frames_device(cfg, *args)
        again = PD.pack_frames_device(cfg, *args)
        assert PD.launches_pack == before + 2, config
        assert torch.equal(out, again), config
        p1_same((cfg, *args, out))
        native = PK.pack_frames_native(cfg, f)
        assert [r.tobytes() for r in out.cpu().numpy()] == native, config
        a16 = p1_other_codes(args)
        assert a16[1].dtype == torch.int16 and bool((a16[1] < 0).any())
        before = PD.launches_pack
        out16 = PD.pack_frames_device(cfg, *a16)
        again16 = PD.pack_frames_device(cfg, *a16)
        assert PD.launches_pack == before + 2, config
        assert torch.equal(out16, out) and torch.equal(again16, out), config
        p1_same((cfg, *a16, out16))
        frames += out.shape[0]
    two = PD.pack_frames_device(cfg, *(a.reshape((2, -1) + a.shape[1:])
                                       for a in args))
    assert torch.equal(two.reshape(out.shape), out)
    before = PD.launches_pack
    none = PD.pack_frames_device(cfg, *(a[:0] for a in args))
    assert none.shape == (0, cfg.frame_size * 2)
    assert PD.launches_pack == before, "a call of no frames launched"
    bap, qmant, exps, strat, csnr, fsnr = args
    flat = torch.zeros(exps.numel() + 16, dtype=torch.uint8, device=dev)
    for i, bad, err in (
            (0, bap.to(torch.int32), TypeError),
            (1, qmant.to(torch.int64), TypeError),
            (1, qmant.to(torch.int8), TypeError),
            (2, exps.to(torch.int32), TypeError),
            (3, strat.to(torch.int64), TypeError),
            (4, csnr.to(torch.int64), TypeError),
            (5, fsnr.to(torch.int16), TypeError),
            (0, bap.transpose(0, 1).contiguous().transpose(0, 1), ValueError),
            (2, flat[1:1 + exps.numel()].view(exps.shape), ValueError),
            (1, torch.zeros(qmant.numel() + 8, dtype=torch.int16,
                            device=dev)[1:1 + qmant.numel()].view(
                                qmant.shape), ValueError),
            (1, qmant[..., :255].contiguous(), ValueError),
            (3, strat[:-1], ValueError),
            (4, csnr[:-1], ValueError),
            (2, exps.cpu(), ValueError)):
        bad_args = list(args)
        bad_args[i] = bad
        try:
            PD.pack_frames_device(cfg, *bad_args)
            raise AssertionError(f"bad argument {i} was accepted")
        except err:
            pass
    # the walk's edges: 1 frame, a CTA's frames - 1 (its last warp idle)
    # and + 1 (a second CTA with one frame), on the fill, dense and edge
    # rows (then from the first again); the CTA's warps from the kernel's
    # own cta_warps (fewer for 5.1's 3,840-byte frames)
    walk_warps = {}
    for config in ((2, 48000, 192), (6, 48000, 640), (5, 32000, 448),
                   (6, 32000, 640)):
        c_cfg, c_f = p1_case(config, 1500 + P1_CONFIGS.index(config))
        r0 = P1_KINDS.index("fill") * P1_ROWS_A_KIND
        warps = walk_warps[config] = PD.cta_warps(c_cfg)
        for n in (1, warps - 1, warps + 1):
            sub = {k: np.ascontiguousarray(np.take(v, np.arange(r0, r0 + n),
                                                   axis=0, mode="wrap"))
                   for k, v in c_f.items()}
            c_args = [torch.from_numpy(sub[k]).to(dev) for k in P1_KEYS]
            before = PD.launches_pack
            c_out = PD.pack_frames_device(c_cfg, *c_args)
            assert PD.launches_pack == before + 1
            p1_same((c_cfg, *c_args, c_out))
            c16 = p1_other_codes(c_args)
            p1_same((c_cfg, *c16, PD.pack_frames_device(c_cfg, *c16)))
            assert [r.tobytes() for r in c_out.cpu().numpy()] == \
                PK.pack_frames_native(c_cfg, sub), (config, n)
    # 3,840-byte 5.1 frames are the ones whose CTA takes fewer warps
    assert walk_warps[6, 32000, 640] < walk_warps[6, 48000, 640], walk_warps
    from ac3acm_tpu_torch.models.encoder import make_config
    resident = {label: PD.resident_frames(make_config(48000, kbps * 1000,
                                                      nch))
                for label, _, _, nch, kbps in ENC_MAIN}
    log(f"P1 walk: 1 frame, a CTA's warps - 1 and + 1 (warps a CTA, a "
        f"frame each: " + ", ".join(f"{c} {w}" for c, w in walk_warps.items())
        + f") equal to pack_frames_ref and the native packer; frames "
        f"resident an SM: " + ", ".join(f"{k} {v}"
                                        for k, v in resident.items()))
    log(f"check pack_frames (P1): {len(P1_CONFIGS)} configs (1-6 channels, "
        f"32 / 44.1 / 48 / 24 kHz, frames of 256-3,840 bytes) x "
        f"{len(P1_KINDS)} field kinds {P1_KINDS} x {P1_ROWS_A_KIND} frames "
        f"= {frames} frames, int32 codes and their int16 form, each "
        f"launched twice (the same bytes in both widths), equal to "
        f"pack_frames_ref and to the native packer byte for byte (overrun "
        f"frames too); the walk's edges in both widths; [2, n/2] leading "
        f"axes; no frames: no launch; a wrong dtype (each of the six, and "
        f"int8 codes), a strided, an unaligned (int16 codes too), a "
        f"narrow, a short, a CPU input raise")
    return 0.0


# X1 (csrc/exponents.cu, the exponent stage) on crafted rows: every
# channel count with and without the LFE (then the last channel), the
# encoder's 223 live bins; the row kinds of each layout (x1_case) and
# their rows: "pattern" one row a new-block pattern of blocks 1-5 (all 32
# in every channel), "silence" all-zero blocks and channels, "overrange"
# coefficients whose raw exponent is >= 24, "extreme" |c| near 2^17 and
# 2^31 and the smallest ones
X1_LAYOUTS = tuple((n, bool(lfe)) for n in range(1, 7) for lfe in (0, 1))
X1_NB = 223
X1_KINDS = (("pattern", 32), ("silence", 4), ("overrange", 4),
            ("extreme", 4))
# the least integer work a bin of X1's function (the raw exponent: abs,
# count of leading zeros, two adds, the clamp's compare and select; its
# |diff|: subtract, abs, add; the fold's min; the coded byte's select)
# and of Q1's a coefficient of a class other than 0 (the exponents'
# subtract; the symmetric form's abs, range check, shift, multiply, two
# shifts, add and sign select; the asymmetric one's count, range checks,
# shift, add, shift, compare, select and mask; the class select)
X1_BIN_OPS, Q1_BIN_OPS = 12, 16


def x1_walk(rng, prev, target, lo):
    """A block's raw exponents [256]: prev moved bin by bin, each bin one
    way only and within [lo, 24], until sum |new - prev| == target."""
    up = 24 - prev >= prev - lo
    room = np.where(up, 24 - prev, prev - lo)
    assert room.sum() >= target, (room.sum(), target)
    step = np.zeros(256, np.int64)
    left = int(target)
    while left:
        # a pass over the bins in a random order, up to 8 a bin
        order = rng.permutation(256)
        cap = np.minimum(room[order], rng.integers(1, 9, 256))
        take = np.clip(left - (np.cumsum(cap) - cap), 0, cap)
        step[order] += take
        room[order] -= take
        left -= int(take.sum())
    return prev + np.where(up, step, -step)


def x1_from_exps(rng, E, es, over):
    """Coefficients whose raw exponents are E (int, [..., 256]) at
    exp_samples es [...] (>= 0 where over): E = 24 gives 0, or where over
    a coefficient that overranges (log2 |c| below es); else |c| in
    [2^L, 2^(L+1)) with L = 23 + es - E, any sign."""
    es = es[..., None]
    L = 23 + es - E
    live = E < 24
    assert ((L[live] >= 0) & (L[live] <= 30)).all()
    L_over = np.floor(rng.random(E.shape) * np.maximum(es, 1)).astype(
        np.int64)
    L = np.where(live, L, L_over)
    mag = (1 << L) + np.floor(rng.random(E.shape) * (1 << L)).astype(np.int64)
    sign = np.where(rng.random(E.shape) < 0.5, -1, 1)
    return np.where(live | (over & (E == 24)), sign * mag, 0)


def x1_rows(rng, kind, rows, nch):
    """Crafted rows of one kind: (coef [rows, 6, nch, 256] int32,
    exp_samples [rows, 6, nch] int32), numpy (see X1_KINDS)."""
    shape = (rows, 6, nch, 256)
    if kind == "pattern":
        E = np.zeros(shape, np.int64)
        es = np.zeros(shape[:3], np.int64)
        for r in range(rows):
            for c in range(nch):
                pat = (r + 5 * c) % 32
                e0 = int(rng.integers(0, 6))         # keeps [e0 - 7, 24]
                lo = e0 - 7
                es[r, :, c] = e0
                E[r, 0, c] = rng.integers(lo, 25, 256)
                if r % 4 == 1:                   # dead bins 223..228 low
                    E[r, 0, c, 223:229] = lo
                for b in range(1, 6):
                    edge = (r + b + c) % 3
                    if pat >> (b - 1) & 1:
                        target = 1001 if edge == 0 else rng.integers(1001,
                                                                     2001)
                    else:
                        target = (1000, 0)[edge] if edge < 2 \
                            else rng.integers(0, 1001)
                    E[r, b, c] = x1_walk(rng, E[r, b - 1, c], target, lo)
        over = (es[..., None] >= 1) & (rng.random(shape) < 0.5)
        coef = x1_from_exps(rng, E, es, over)
        return coef.astype(np.int32), es.astype(np.int32)
    es = rng.integers(-9, 6, shape[:3])
    if kind == "overrange":
        es = rng.integers(1, 6, shape[:3])
    L = rng.integers(0, 31, shape)
    if kind == "overrange":
        # half the bins below the block's es: the raw exponent >= 24
        low = np.floor(rng.random(shape) * es[..., None]).astype(np.int64)
        L = np.where(rng.random(shape) < 0.5, low, L)
    if kind == "extreme":
        L = rng.choice([0, 1, 16, 17, 29, 30], shape)
    mag = (1 << L) + np.floor(rng.random(shape) * (1 << L)).astype(np.int64)
    coef = np.where(rng.random(shape) < 0.5, -mag, mag)
    if kind == "extreme":
        edge = np.array([2**31 - 1, -(2**31 - 1), 1 << 17, -(1 << 17),
                         (1 << 17) - 1, 1 - (1 << 17), 1, -1])
        coef[..., :8] = edge
    if kind == "silence":
        coef[rng.random(shape[:3]) < 0.4] = 0            # zero blocks
        coef[0, :, 0] = 0                                # a silent channel
        coef[rng.random(shape) < 0.1] = 0
    return coef.astype(np.int32), es.astype(np.int32)


def x1_case(nch, lfe, seed):
    """One crafted X1 case, numpy: (coef [R, 6, nch, 256] int32, its rows
    X1_KINDS' kinds in order, exp_samples [R, 6, nch] int32, X1_NB, lfe)."""
    rng = np.random.default_rng(seed)
    parts = [x1_rows(rng, kind, rows, nch) for kind, rows in X1_KINDS]
    return (np.concatenate([p[0] for p in parts]),
            np.concatenate([p[1] for p in parts]), X1_NB, lfe)


def x1_same(call):
    """One recorded exponents call (coef before it, exp_samples, nb, lfe,
    then (enc_exp, strat, exp_bits, coef after it)) against exponents_ref
    on the same inputs and device, bitwise -> max |diff| (0)."""
    from ac3acm_tpu_torch.ops.exponents import exponents_ref
    coef, es, nb, lfe, got = call
    after = coef.clone()
    want = exponents_ref(after, es, nb, lfe) + (after,)
    names = ("enc_exp", "strat", "exp_bits", "coef")
    for name, g, w in zip(names, got, want):
        if not torch.equal(g, w):
            raise AssertionError(
                f"X1 != exponents_ref in {name}: max |diff| "
                f"{int((g.long() - w.long()).abs().max())}")
    return 0.0


def as_int16(q):
    """int32 codes -> their low 16 bits as int16 (Q1's 16-bit form), by
    arithmetic that no cast's overflow rule touches."""
    return (((q.long() + 0x8000) & 0xFFFF) - 0x8000).to(torch.int16)


def q1_same(call):
    """One recorded quantize call (coef, enc_exp, global_exp, bap, then
    its codes, int16 or int32) against quantize_ref in that width on the
    same inputs and device, bitwise; then Q1 in the other width on the
    same inputs against quantize_ref in that one -> max |diff| (0).  An
    int16 code is compared by its 16 bits (code_bits), never widened with
    its sign."""
    from ac3acm_tpu_torch.ops import quantize as QZ
    *args, got = call
    other = torch.int32 if got.dtype == torch.int16 else torch.int16
    for codes, g in ((got.dtype, got),
                     (other, QZ.quantize(*args, codes=other))):
        want = QZ.quantize_ref(*args, codes=codes)
        if g.dtype != codes or not torch.equal(g, want):
            a, b = ((QZ.code_bits(t) if codes == torch.int16 else t).long()
                    for t in (g, want))
            raise AssertionError(
                f"Q1 != quantize_ref ({codes} codes): max |diff| "
                f"{int((a - b).abs().max())} on {int((a != b).sum())} codes")
    return 0.0


def x1_bound(coef, nb, lfe):
    """X1 on coef [N, 6, ch, 256]'s rows: (bound_ms, "bytes" |
    "operations"): stage_least_bytes' exponent row (a coefficient in as
    int32, a coded exponent out a byte) at the card's memory rate against
    X1_BIN_OPS a bin at its issue rate."""
    N, _, ch, _ = coef.shape
    nbs = (nb,) * (ch - int(lfe)) + (7,) * int(lfe)
    t_bytes = stage_least_bytes(N, nbs, 0, 0)[
        "exponents + strategy + coding"] / PEAK_BYTES * 1e3
    t_ops = N * 6 * ch * 256 * X1_BIN_OPS / PEAK_ISSUE * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def q1_least_bytes(bap):
    """The least bytes of the quantizer's function (Q1's bound and the
    stage table's "quantize" row) on one call's own classes (bap [..., K],
    any device): every bin's class in (a byte) and code out (16 bits, its
    narrowest); where the class is not 0, the coefficient (int32) and its
    exponent (a byte) in (a class-0 code is 0 whatever they are); a
    (block, channel)'s global exponent (int32) where one of its classes
    is not 0."""
    coded = bap != 0
    return (3 * bap.numel() + 5 * int(coded.sum())
            + 4 * int(coded.any(dim=-1).sum()))


def q1_bound(bap):
    """Q1 on one call's classes bap [N, 6, ch, 256]: (bound_ms, "bytes" |
    "operations"): q1_least_bytes at the card's memory rate against
    Q1_BIN_OPS a coefficient whose class is not 0 at its issue rate."""
    t_bytes = q1_least_bytes(bap) / PEAK_BYTES * 1e3
    t_ops = int((bap != 0).sum()) * Q1_BIN_OPS / PEAK_ISSUE * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def x1_times(call):
    """X1 and its plain version on one recorded core call's inputs: ms
    (device time, median of 7 after 2 warm-ups), plain_ms, the bound.  The
    calls run on the coefficients as X1 left them (its overrange ones
    already zeroed, so every call does the same work).  No PyTorch call
    computes the stage: library_ms is null."""
    from ac3acm_tpu_torch.ops import exponents as EX
    coef, es, nb, lfe, got = call
    coef = got[3].clone()
    ms = device_ms(lambda: EX.exponents(coef, es, nb, lfe))
    plain_ms = cuda_ms(lambda: EX.exponents_ref(coef, es, nb, lfe),
                       warmup=1, reps=3)
    bound_ms, bound_by = x1_bound(coef, nb, lfe)
    return dict(ms=ms, plain_ms=plain_ms, library_ms=None, bound_ms=bound_ms,
                bound_by=bound_by)


def q1_times(call):
    """Q1 and its plain version on one recorded core call's inputs: ms
    (device time, median of 7 after 2 warm-ups) with int16 codes (the
    device-pack path's form), ms_int32 with int32 codes (the public
    functions' form), plain_ms (int16), the bound; codes names the width
    ms and plain_ms time (int16 since Q1's redesign; the first design's ms
    was int32, which ms_int32 continues).  No PyTorch call quantizes by
    class: library_ms is null."""
    from ac3acm_tpu_torch.ops import quantize as QZ
    args = call[:4]
    ms = device_ms(lambda: QZ.quantize(*args, codes=torch.int16))
    ms_int32 = device_ms(lambda: QZ.quantize(*args, codes=torch.int32))
    plain_ms = cuda_ms(lambda: QZ.quantize_ref(*args, codes=torch.int16),
                       warmup=1, reps=3)
    bound_ms, bound_by = q1_bound(args[3])
    return dict(ms=ms, ms_int32=ms_int32, codes="int16", plain_ms=plain_ms,
                library_ms=None, bound_ms=bound_ms, bound_by=bound_by)


def x1_patterns(strat, lfe):
    """The new-block patterns of blocks 1-5 (bit b - 1 set where block b
    starts a run) of the full-band channels' strategies [R, 6, ch]."""
    s = strat[:, 1:, :strat.shape[2] - int(lfe)]
    bits = (s != 0).astype(np.int64) << np.arange(5)[None, :, None]
    return set(bits.sum(1).ravel().tolist())


def phase_check_x1(dev):
    """X1 (csrc/exponents.cu) against its plain version BITWISE (the 256
    coded bytes of every block and channel, strat, exp_bits and the zeroed
    coefficients) on the crafted rows of every layout of X1_LAYOUTS (1 to
    6 channels, with and without the LFE), twice each (the same bytes);
    every new-block pattern of blocks 1-5 in every full-band channel; one
    row, none (no launch); bad inputs raise.  -> max |diff| (0)."""
    from ac3acm_tpu_torch.ops import exponents as EX
    rows = 0
    for i, (nch, lfe) in enumerate(X1_LAYOUTS):
        coef_np, es_np, nb, lfe = x1_case(nch, lfe, 1600 + i)
        coef = torch.from_numpy(coef_np).to(dev)
        es = torch.from_numpy(es_np).to(dev)
        before = EX.launches_exponents
        work = coef.clone()
        out = EX.exponents(work, es, nb, lfe)
        x1_same((coef, es, nb, lfe, out + (work,)))
        again = coef.clone()
        out2 = EX.exponents(again, es, nb, lfe)
        assert EX.launches_exponents == before + 2, (nch, lfe)
        assert all(torch.equal(a, b) for a, b in zip(out + (work,),
                                                     out2 + (again,)))
        if nch > int(lfe):
            pats = x1_patterns(out[1][:X1_KINDS[0][1]].cpu().numpy(), lfe)
            assert pats == set(range(32)), (nch, lfe, sorted(pats))
        assert int(out[0].min()) >= -16 and int(out[0].max()) <= 24
        rows += coef.shape[0]
    one = coef[:1].clone()
    x1_same((coef[:1], es[:1], nb, lfe,
             EX.exponents(one, es[:1].contiguous(), nb, lfe) + (one,)))
    # more rows than the resident CTAs: each CTA walks two or three rows
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    walk = {}
    for i, layout in enumerate(X1_LAYOUTS):
        if layout not in ((2, False), (6, True), (3, True)):
            continue
        w_coef, w_es, w_nb, w_lfe = x1_case(*layout, 1600 + i)
        ctas = sms * EX.resident_ctas(layout[0])
        n = 2 * ctas + 1
        reps = -(-n // w_coef.shape[0])
        t_coef = torch.from_numpy(np.tile(w_coef, (reps, 1, 1, 1))[:n]
                                  ).to(dev)
        t_es = torch.from_numpy(np.tile(w_es, (reps, 1, 1))[:n]).to(dev)
        work = t_coef.clone()
        x1_same((t_coef, t_es, w_nb, w_lfe,
                 EX.exponents(work, t_es, w_nb, w_lfe) + (work,)))
        walk[layout] = (n, ctas)
    before = EX.launches_exponents
    enc, strat, bits = EX.exponents(coef[:0], es[:0], nb, lfe)
    assert enc.shape == (0, 6, nch, 256) and bits.shape == (0,)
    assert EX.launches_exponents == before, "a call of no rows launched"
    flat = torch.zeros(coef.numel() + 4, dtype=torch.int32, device=dev)
    for i, bad, err in (
            (0, coef.to(torch.int64), TypeError),
            (1, es.to(torch.int16), TypeError),
            (0, coef.transpose(0, 1).contiguous().transpose(0, 1),
             ValueError),
            (0, flat[1:1 + coef.numel()].view(coef.shape), ValueError),
            (0, coef[..., :255].contiguous(), ValueError),
            (1, es[:-1], ValueError),
            (1, es.cpu(), ValueError),
            (2, 256, ValueError),
            (2, 0, ValueError),
            (2, 222, ValueError),
            (2, 255, ValueError),
            (3, 1, TypeError)):
        args = [coef.clone(), es, nb, lfe]
        args[i] = bad
        try:
            EX.exponents(*args)
            raise AssertionError(f"bad argument {i} was accepted")
        except err:
            pass
    log(f"check exponents (X1): {len(X1_LAYOUTS)} layouts (1-6 channels, "
        f"with and without the LFE) x {sum(r for _, r in X1_KINDS)} crafted "
        f"rows ({', '.join(f'{k} {r}' for k, r in X1_KINDS)}) = {rows} "
        f"rows, each launched twice (the same bytes), equal to "
        f"exponents_ref bitwise in the 256 coded bytes, strat, exp_bits and "
        f"the zeroed coefficients; all 32 new-block patterns of blocks 1-5 "
        f"in every full-band channel, diff sums of exactly 1000 and 1001; "
        f"coded exponents in [-16, 24]; one row; "
        + "; ".join(f"{k}: {n} rows over {c} resident CTAs"
                    for k, (n, c) in walk.items())
        + f"; no rows: no launch; a "
        f"wrong dtype, a strided, an unaligned, a narrow, a short, a CPU "
        f"input, nb 0, 222, 255 and 256 (the kernel takes 223) and a "
        f"non-bool lfe raise")
    return 0.0


def q1_case(seed):
    """Crafted quantizer inputs, numpy: (coef [R, 16 * 64] int32, enc_exp
    int32, global_exp [R] int32, bap int8): a row per exponent difference
    e = enc_exp - global_exp from -21 to 33 (a third of its bins at
    another e in [-21, 33]), every class 0-15 on every row, coefficients
    random in +-2^17 and at the edges (0, +-1, the powers of two up to
    2^30, INT32_MAX, INT32_MIN), saturating ones; on every other row,
    runs of class 0 (an aligned 64-bin one, a ragged one of 13 bins)
    whose coefficients and exponents Q1 does not read; global_exp in
    [-9, 5] so that enc_exp fits a byte."""
    rng = np.random.default_rng(seed)
    e = np.arange(-21, 34)
    R, K = len(e), 16 * 64
    coef = rng.integers(-(1 << 17), 1 << 17, (R, K))
    edge = np.array([0, 1, -1, 2**31 - 1, -2**31, 1 << 30, -(1 << 30),
                     (1 << 17) - 1, -(1 << 17), 65535, -65536, 3, -3,
                     1 << 20, -(1 << 20), 1 << 24])
    coef[:, :16] = edge
    coef[:, 16:32] = edge[::-1]
    coef[:, 32:256] = rng.integers(-2**31, 2**31, (R, 224))
    gexp = rng.integers(-9, 6, R)
    diff = np.broadcast_to(e[:, None], (R, K)).copy()
    diff[:, ::3] = rng.integers(-21, 34, diff[:, ::3].shape)
    bap = np.tile(np.arange(16), (R, 64))
    bap[::2, 512:576] = 0
    bap[::2, 701:714] = 0
    return (coef.astype(np.int32), (diff + gexp[:, None]).astype(np.int32),
            gexp.astype(np.int32), bap.astype(np.int8))


def phase_check_q1(dev):
    """Q1 (csrc/quantize.cu) against its plain version BITWISE in both
    code widths (int16, the low 16 bits the device-pack path hands the
    packer; int32, JAX's values) on the crafted cases of q1_case (every
    class, e from -21 to 33, the edges of int32, saturation, class-15
    codes from 32,768 up) with the exponents as int8 and as int32 (the JAX
    form), twice each (the same codes); at a frame core's layout
    [R, 6, ch, 256] (more chunks than one pass of the full grid are
    walked at every recorded core call, which q1_same holds); the public
    quantize on JAX's inputs (int32 classes, ragged rows padded to 16
    bins, strided and unaligned tensors), int32 codes; no coefficients
    (no launch); bad inputs raise.  -> max |diff| (0)."""
    from ac3acm_tpu_torch.models import encoder as PE
    from ac3acm_tpu_torch.ops import quantize as QZ
    coef, enc, gexp, bap = (torch.from_numpy(a).to(dev)
                            for a in q1_case(1700))
    widths = (torch.int16, torch.int32)
    q = torch.tensor([1] * 6 + [c - 1 for c in range(6, 14)] + [14, 16],
                     device=dev)[bap.long()]
    top = (torch.ones_like(q) << (q - 1)) - 1
    sat = high = 0
    for enc_t in (enc.to(torch.int8), enc):
        assert torch.equal(enc_t.to(torch.int32), enc)
        for codes in widths:
            before = QZ.launches_quantize
            out = QZ.quantize(coef, enc_t, gexp, bap, codes=codes)
            again = QZ.quantize(coef, enc_t, gexp, bap, codes=codes)
            assert QZ.launches_quantize == before + 2
            assert out.dtype == codes and torch.equal(out, again)
            q1_same((coef, enc_t, gexp, bap, out))
            # an asymmetric code at its ceiling m - 1: the saturation ran;
            # class-15 codes from 32,768 up: negative as int16
            wide = QZ.code_bits(out)
            sat += int(((bap >= 6) & (wide == top)).sum())
            high += int(((bap == 15) & (wide >= 32768)).sum())
    assert sat > 0, "no code saturated"
    assert high > 0, "no class-15 code from 32,768 up"
    frame = tuple(t[:48].reshape(48, 16, 64).reshape(-1, 6, 2, 256)
                  for t in (coef, enc.to(torch.int8), bap))
    g = gexp[:48, None].expand(48, 4).reshape(-1, 6, 2).contiguous()
    # rows of 1,008 bins: 3,465 chunks, the last warp's partly past them
    rag = [t[:, :1008].contiguous() for t in (coef, enc.to(torch.int8), bap)]
    for codes in widths:
        q1_same((rag[0], rag[1], gexp, rag[2],
                 QZ.quantize(rag[0], rag[1], gexp, rag[2], codes=codes)))
        q1_same(frame[:1] + (frame[1], g, frame[2], QZ.quantize(
            frame[0], frame[1], g, frame[2], codes=codes)))
    # the public quantize on JAX's inputs, brought to Q1's contract (rows
    # padded to 16 bins): int32 classes, ragged rows (strided views), an
    # unaligned coef and a strided enc_exp; int32 codes, one launch each
    spare = torch.zeros(coef.numel() + 4, dtype=torch.int32, device=dev)
    odd = spare[1:1 + coef.numel()].view(coef.shape)
    odd.copy_(coef)
    for args in ((coef, enc, gexp, bap.to(torch.int32)),
                 (coef[:, :1021], enc[:, :1021], gexp, bap[:, :1021]),
                 (coef[:, :1012], enc[:, :1012], gexp, bap[:, :1012]),
                 (odd, enc.t().contiguous().t(), gexp, bap)):
        before = QZ.launches_quantize
        got = PE.quantize(*args)
        assert QZ.launches_quantize == before + 1
        assert got.dtype == torch.int32
        assert torch.equal(got, QZ.quantize_ref(*args))
    before = QZ.launches_quantize
    for codes in widths:
        none = QZ.quantize(coef[:0], enc[:0], gexp[:0], bap[:0], codes=codes)
        assert none.shape == (0, coef.shape[1]) and none.dtype == codes
    assert QZ.launches_quantize == before, "no coefficients launched"
    flat = torch.zeros(coef.numel() + 4, dtype=torch.int32, device=dev)
    e8 = torch.zeros(coef.numel() + 16, dtype=torch.int8, device=dev)
    for i, bad, err in (
            (0, coef.to(torch.int64), TypeError),
            (1, enc.to(torch.int16), TypeError),
            (2, gexp.to(torch.int64), TypeError),
            (3, bap.to(torch.int32), TypeError),
            (0, coef.t().contiguous().t(), ValueError),
            (0, flat[1:1 + coef.numel()].view(coef.shape), ValueError),
            (1, e8[4:4 + coef.numel()].view(coef.shape), ValueError),
            (0, coef[:, :1012].contiguous(), ValueError),
            (1, enc[:, :-4].contiguous(), ValueError),
            (2, gexp[:-1], ValueError),
            (3, bap.cpu(), ValueError)):
        args = [coef, enc, gexp, bap]
        args[i] = bad
        try:
            QZ.quantize(*args)
            raise AssertionError(f"bad argument {i} was accepted")
        except err:
            pass
    for codes in (torch.int64, torch.int8, torch.uint16):
        try:
            QZ.quantize(coef, enc, gexp, bap, codes=codes)
            raise AssertionError(f"codes={codes} was accepted")
        except TypeError:
            pass
    log(f"check quantize (Q1): {coef.shape[0]} rows x {coef.shape[1]} "
        f"coefficients (every class 0-15, e = enc_exp - global_exp from -21 "
        f"to 33, INT32_MIN/MAX and the powers of two), exponents int8 and "
        f"int32, int16 and int32 codes, each launched twice (the same "
        f"codes), equal to quantize_ref bitwise in each width; {sat} "
        f"saturated asymmetric codes, {high} class-15 codes from 32,768 up; "
        f"the frame core's [R, 6, 2, 256] layout; runs of class 0; rows of "
        f"1,008 bins (a last warp partly past the chunks); the public "
        f"quantize (int32 codes) on int32 classes, ragged "
        f"rows of 1,021 and 1,012 bins, an unaligned and a strided input; "
        f"no coefficients: no launch; a wrong dtype (each of the four, and "
        f"codes int64, int8, uint16), a strided, an unaligned (4 bytes off "
        f"too), a row of 1,012 bins, a short and a CPU input raise")
    return 0.0


# M1 (csrc/window_mdct.cu: the window, the block-float normalize and the
# MDCT) on crafted rows: every channel count, row counts 1, 3 and 4,097
# (one transform to a partial CTA of eight warps and the grid-stride
# loop's tail), each case's transforms starting with the edge block pairs
# of m1_edges (rotated by the case's seed), the rest noise at four scales;
# with wide, a third of the transforms int32 well outside int16
M1_CHANNELS = tuple(range(1, 7))
M1_ROWS = (1, 3, 4097)
# the least integer work of one transform of M1's function, counted from
# ops/mdct.py: the window 512 x (multiply, shift, wrap); the normalize's
# |x| and OR, then its shift and wrap, 512 x 4; the rotation's negate and
# wrap of 128 x 2 samples; the pre-rotation 128 x (two subtracts, a
# negate, two shifts, two multiplies and two multiply-adds, two shifts,
# two wraps); the FFT's 448 butterflies x (four adds, four shifts, four
# wraps) and its 289 twiddled ones x (two multiplies, two multiply-adds,
# two shifts), pass 1's 32 negates; the post-rotation 128 x (two
# multiplies, two multiply-adds, two shifts)
M1_TRANSFORM_OPS = (512 * 3 + 512 * 4 + 128 * 2 * 2 + 128 * 13
                    + 448 * 12 + 289 * 6 + 32 + 128 * 6)
# the static instruction count of M1's kernel in this build's SASS
# (phase_build counts it): its loop body runs once a transform a warp
M1_SASS = {}
# B1F's SASS on its pair steps' paths, by output form (phase_build,
# b1f_pair_paths): the design's model on B1F's log line
B1F_SASS = {}


def m1_edges():
    """Edge (prev, cur) block pairs, numpy int32 [E, 2, 256]: +-32767 and
    32767 / -32768 square waves (enc_extremes'), silence, single impulses
    at 0, 100 and 255 of each sign in either block, a -32768 DC, blocks of
    +-1 (the largest shift, 14), DC at +-2^k (k = 1..15, 2^15 clipped to
    32767), noise at four scales, and a back sample
    just outside int16 (46634 at cur[128], windowed by w[127] = 23025 to
    32768, which wraps to -32768 at x[384], where the rotation negates it
    and -(-32768) wraps back)."""
    rng = np.random.default_rng(17)
    i = np.arange(256)
    sq = np.where(i % 32 < 16, 32767, -32767)
    sq8 = np.where(i % 8 < 4, 32767, -32768)
    zero = np.zeros(256, np.int64)
    pairs = [(sq, sq8), (sq8, sq), (zero, zero), (sq8, zero), (zero, sq8),
             (np.full(256, -32768), np.full(256, -32768)),
             (np.where(i % 2, 1, -1), np.where(i % 3, -1, 1))]
    for at in (0, 100, 255):
        for val in (32767, -32768):
            imp = zero.copy()
            imp[at] = val
            pairs += [(imp, zero), (zero, imp)]
    for scale in (10.0, 300.0, 8000.0, 30000.0):
        pairs.append(tuple((rng.standard_normal(256) * scale).round()
                           for _ in range(2)))
    for k in range(1, 16):               # DC at 2^k: every shift 0..13
        pairs.append((np.full(256, 1 << k), np.full(256, -(1 << k))))
    wrap = zero.copy()
    wrap[128] = 46634
    pairs.append((zero, wrap))
    pairs.append((sq, wrap + sq8 * (i != 128)))
    out = np.clip(np.array(pairs, np.int64), -32768, 32767)
    out[-2:, 1, 128] = 46634
    return out.astype(np.int32)


def m1_case(nch, rows, seed, wide=False):
    """Crafted M1 inputs, numpy: (prev, cur) int32 [rows, 6, nch, 256]; the
    transforms start with m1_edges' pairs rotated by seed, the rest noise
    at four scales (int16); with wide, every third transform's samples
    are int32 over the whole range (products wrap)."""
    rng = np.random.default_rng(seed)
    n = rows * 6 * nch
    edges = m1_edges()
    e = np.roll(edges, -(seed % len(edges)), axis=0)[:n]
    scale = rng.choice([10.0, 300.0, 8000.0, 30000.0], (n, 2, 1))
    x = np.clip((rng.standard_normal((n, 2, 256)) * scale).round(),
                -32768, 32767).astype(np.int64)
    x[:len(e)] = e
    if wide:
        x[::3] = rng.integers(-2**31, 2**31, (len(x[::3]), 2, 256))
        x[::3, :, :4] = [2**31 - 1, -2**31, 1 << 16, -(1 << 16)]
    x = x.astype(np.int32).reshape(rows, 6, nch, 2, 256)
    return (np.ascontiguousarray(x[..., 0, :]),
            np.ascontiguousarray(x[..., 1, :]))


def m1_same(call):
    """One recorded window_mdct call (prev, cur, then (coef,
    exp_samples)) against window_mdct_ref on the same inputs and device,
    bitwise -> max |diff| (0)."""
    from ac3acm_tpu_torch.ops.window_mdct import window_mdct_ref
    prev, cur, got = call
    want = window_mdct_ref(prev, cur)
    for name, g, w in zip(("coef", "exp_samples"), got, want):
        if not torch.equal(g, w):
            raise AssertionError(
                f"M1 != window_mdct_ref in {name}: max |diff| "
                f"{int((g.long() - w.long()).abs().max())} on "
                f"{int((g != w).sum())} values")
    return 0.0


def m1_bound(cur):
    """M1 on cur [N, 6, ch, 256]'s transforms: (bound_ms, "bytes" |
    "operations", the design's model ms).  stage_least_bytes' row (the
    two blocks in as int16, a coefficient out as int32, the shift a byte)
    at the card's memory rate against M1_TRANSFORM_OPS a transform at its
    issue rate; the model, the kernel's static SASS count (M1_SASS, its
    loop body once a transform) issued by each of a warp's 32 lanes at the
    same rate: a model of the design, not a measurement, so it stays on
    M1's log line and out of the kernels line."""
    N, _, ch, _ = cur.shape
    n = N * 6 * ch
    t_bytes = stage_least_bytes(N, (0,) * ch, 0, 0)[
        "window + normalize + MDCT"] / PEAK_BYTES * 1e3
    t_ops = n * M1_TRANSFORM_OPS / PEAK_ISSUE * 1e3
    model = n * 32 * M1_SASS.get("window_mdct_kernel", 0) / PEAK_ISSUE * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops
            else "operations", model)


def m1_times(call):
    """M1 and its plain version on one recorded core call's inputs: ms
    (device time, median of 7 after 2 warm-ups), plain_ms, the bound and
    the design's model.  No PyTorch call computes the truncating int16
    FFT: library_ms is null."""
    from ac3acm_tpu_torch.ops import window_mdct as WM
    prev, cur, _ = call
    ms = device_ms(lambda: WM.window_mdct(prev, cur))
    plain_ms = cuda_ms(lambda: WM.window_mdct_ref(prev, cur), warmup=1,
                       reps=3)
    bound_ms, bound_by, model_ms = m1_bound(cur)
    return dict(ms=ms, plain_ms=plain_ms, library_ms=None, bound_ms=bound_ms,
                bound_by=bound_by, model_ms=model_ms)


def phase_check_m1(dev):
    """M1 (csrc/window_mdct.cu) against its plain version BITWISE (coef
    and exp_samples) on the crafted cases of m1_case: 1 to 6 channels x
    1, 3 and 4,097 rows, twice each (the same values); rows of int32
    outside int16 (the products wrap as unsigned); no rows (no launch); bad
    inputs raise.  -> max |diff| (0)."""
    from ac3acm_tpu_torch.ops import window_mdct as WM
    transforms, shifts = 0, set()
    for nch in M1_CHANNELS:
        for rows in M1_ROWS:
            for wide in (False, True):
                prev, cur = (torch.from_numpy(a).to(dev) for a in m1_case(
                    nch, rows, 1800 + 10 * nch + rows, wide))
                before = WM.launches_window_mdct
                out = WM.window_mdct(prev, cur)
                again = WM.window_mdct(prev, cur)
                assert WM.launches_window_mdct == before + 2, (nch, rows)
                assert all(torch.equal(a, b) for a, b in zip(out, again))
                m1_same((prev, cur, out))
                transforms += prev.numel() // 256
                shifts |= set(out[1].unique().tolist())
    assert shifts == set(range(-9, 6)), sorted(shifts)
    before = WM.launches_window_mdct
    coef, es = WM.window_mdct(prev[:0], cur[:0])
    assert coef.shape == (0, 6, nch, 256) and es.shape == (0, 6, nch)
    assert WM.launches_window_mdct == before, "a call of no rows launched"
    flat = torch.zeros(cur.numel() + 4, dtype=torch.int32, device=dev)
    for i, bad, err in (
            (0, prev.to(torch.int64), TypeError),
            (1, cur.to(torch.int16), TypeError),
            (1, cur[:-1].contiguous(), ValueError),
            (0, prev[:, :5].contiguous(), ValueError),
            (1, cur[..., :255].contiguous(), ValueError),
            (0, prev.transpose(0, 1).contiguous().transpose(0, 1),
             ValueError),
            (1, flat[1:1 + cur.numel()].view(cur.shape), ValueError),
            (1, cur.cpu(), ValueError),
            (0, prev.to("meta"), ValueError)):
        args = [prev, cur]
        args[i] = bad
        try:
            WM.window_mdct(*args)
            raise AssertionError(f"bad argument {i} was accepted")
        except err:
            pass
    log(f"check window_mdct (M1): {len(M1_CHANNELS)} channel counts x rows "
        f"{M1_ROWS} x int16 and wide int32 samples = {transforms} "
        f"transforms, each case launched twice (the same values), equal to "
        f"window_mdct_ref bitwise in coef and exp_samples (every shift "
        f"{min(shifts)}..{max(shifts)}); the edge pairs (square waves, "
        f"silence, impulses at 0, 100, 255, -32768 at x[384]); no rows: no "
        f"launch; a wrong dtype, a short, a 5-block, a 255-bin, a strided, "
        f"an unaligned, a CPU and a meta input raise")
    return 0.0


def enc_extremes(seed=0):
    """Integer edge cases of the encoder's filterbank and quantizer, as
    numpy inputs: block pairs (full-scale +-32767 / -32768 square waves,
    silence, single impulses, noise at four scales), near-overrange
    coefficients, quantizer inputs whose shift counts run from -40 to 60,
    and av_log2 arguments at int32's edges."""
    rng = np.random.default_rng(seed)
    n = 32
    blocks = (rng.standard_normal((2, n, 256)) * rng.choice(
        [10.0, 300.0, 8000.0, 30000.0], (2, n, 1))).round()
    i = np.arange(256)
    blocks[:, 0] = np.where(i % 32 < 16, 32767, -32767)
    blocks[:, 1] = np.where(i % 8 < 4, 32767, -32768)
    blocks[:, 2:4] = 0
    blocks[0, 4, :] = 0
    blocks[0, 4, 100] = 32767
    blocks[1, 5, :] = 0
    blocks[1, 5, 0] = -32768
    blocks[:, 6] = blocks[::-1, 0]
    blocks = np.clip(blocks, -32768, 32767).astype(np.int32)
    coef = rng.integers(-(1 << 17), 1 << 17, (8, 256)).astype(np.int32)
    coef[0] = [1 << (k % 17) for k in range(256)]
    coef[1] = -coef[0]
    coef[2] = 0
    cexp = np.array([-9, -9, 0, 5, -3, 2, -9, 4], np.int32)
    shifts = np.arange(-40, 61, 4)
    qcoef = rng.integers(-(1 << 17), 1 << 17, (len(shifts), 16 * 64))
    qcoef[:, :11] = [0, 1, -1, 65535, -65536, 2**31 - 1, -2**31, 2**30,
                     -2**30, 32767, -32768]
    qenc = np.broadcast_to(24 + shifts[:, None], qcoef.shape).copy()
    qenc[:, ::3] = rng.integers(-10, 40, qenc[:, ::3].shape)
    log2 = np.concatenate([np.arange(0, 4096), 1 << np.arange(31),
                           (1 << np.arange(1, 32)) - 1,
                           rng.integers(0, 2**31 - 1, 4096)])
    return dict(last=blocks[0], cur=blocks[1], coef=coef, cexp=cexp,
                qcoef=qcoef.astype(np.int32), qenc=qenc.astype(np.int32),
                qgexp=np.where(shifts % 8, -9, 0).astype(np.int32),
                qbap=np.tile(np.arange(16, dtype=np.int8),
                             (len(shifts), 64)),
                log2=np.clip(log2, 0, 2**31 - 1).astype(np.int32))


def enc_extreme_outputs(d, device):
    """The port's encoder primitives on enc_extremes' inputs, on
    `device`; -> dict of numpy results."""
    from ac3acm_tpu_torch.models import encoder as PE
    from ac3acm_tpu_torch.ops import mdct as PM

    def t(a):
        return torch.from_numpy(a).to(device)

    x, v, s = PM.window_norm_block(t(d["last"]), t(d["cur"]))
    e, c = PM.extract_exponents(t(d["coef"]), t(d["cexp"]))
    out = dict(windowed=x, shift=v, exp_samples=s, mdct=PM.mdct512(x),
               exp=e, coef=c, av_log2=PM.av_log2(t(d["log2"])),
               quant=PE.quantize(t(d["qcoef"]), t(d["qenc"]), t(d["qgexp"]),
                                 t(d["qbap"])))
    return {k: v.cpu().numpy() for k, v in out.items()}


def phase_enc_extremes():
    """The encoder's integer primitives on the card equal their CPU runs
    (which tests/test_torch_mdct.py and tests/test_torch_window_mdct.py
    hold to the JAX package) on the edge cases of enc_extremes; M1 on the
    card against window_mdct_ref on the CPU."""
    from ac3acm_tpu_torch.ops import window_mdct as WM
    d = enc_extremes()
    card, cpu = enc_extreme_outputs(d, "cuda"), enc_extreme_outputs(d, "cpu")
    # M1 on the pair's rows tiled to [3, 6, 2, 256]
    pair = [torch.from_numpy(np.resize(d[k], (36, 256)).reshape(
        3, 6, 2, 256)) for k in ("last", "cur")]
    for outs, dev in ((card, "cuda"), (cpu, "cpu")):
        got = WM.window_mdct(*(p.to(dev) for p in pair))
        outs["window_mdct"], outs["window_mdct_shift"] = (
            g.cpu().numpy() for g in got)
    bad = [k for k in cpu if not np.array_equal(card[k], cpu[k])]
    e = d["qenc"] - d["qgexp"][:, None]
    log(f"encoder int semantics on the card == on the CPU for "
        f"{sorted(cpu)} (quantizer exponent differences {int(e.min())}.."
        f"{int(e.max())}): mismatches {bad}")
    assert not bad, bad


def encode_resident(enc, x, clock=None):
    """PCM [F, B, 1536, nch] int16 already on the card through
    BatchedEncoder enc's carry, encoded and packed there; -> (ok [F, B],
    frames [F, B, bytes]) on the card.  clock: see frame_core."""
    from ac3acm_tpu_torch.models.encoder import encode_pipeline_packed
    (enc.last, enc.csnr), ok, fr = encode_pipeline_packed(enc.cfg, clock)(
        x, enc.last, enc.csnr)
    return ok, fr


def phase_enc_digests():
    """Both pack modes on the card equal the JAX encoder's bytes in every
    digest config."""
    from ac3acm_tpu_torch.parallel.encode import BatchedEncoder
    for config in ENC_DIGEST_CONFIGS:
        got = {}
        for pack in ("device", "native"):
            got[pack], outs = encode_digest(
                lambda *a: BatchedEncoder(*a, pack=pack), config)
        nch, freq, kbps = config
        log(f"encoder digest {nch} ch {freq} Hz {kbps} kbit/s, "
            f"{DIGEST_LANES} lanes x {DIGEST_FRAMES} frames: device pack "
            f"{got['device'][:16]}, native pack {got['native'][:16]}, JAX "
            f"{ENC_DIGESTS[config][:16]}")
        assert got["device"] == got["native"] == ENC_DIGESTS[config], config


def enc_bench_pcm(channels, nframes, lanes):
    """bench.py:_encode_pcm's content (the golden 5.1 stream decoded to
    stereo by the native decoder, its rounding included, tiled per
    channel), lane i starting at frame i mod 8: [lanes, n, ch] int16."""
    from ac3acm_tpu_torch.host.native import NativeDecoder
    out = NativeDecoder().decode_stream(
        b"".join(golden_frames(GOLDEN) * 2), FLAGS_51_TO_20, 1.0, 384.0)
    pcm = np.clip(np.round(out - 384.0) * 32768.0 / 2, -20000, 20000)
    flat = pcm.transpose(0, 2, 1).reshape(-1, 2)
    need = (nframes + 8) * 1536
    flat = np.tile(flat, (need // flat.shape[0] + 1, 1))[:need]
    chans = np.stack([flat[:, i % 2] * (1.0 - 0.05 * i)
                      for i in range(channels)], -1).astype(np.int16)
    return np.stack([chans[(i % 8) * 1536:(i % 8 + nframes) * 1536]
                     for i in range(lanes)])


def phase_enc_main():
    """Configs 3 and 4: device pack == native pack on every frame;
    x-realtime end to end and on the device alone; peak memory; the stage
    table; the core's frame grouping both ways.  M1, E1, X1 and Q1 once a
    core call in the end-to-end runs and their eager steps never; P1 once a
    core call with pack="device", never with "native"; every M1, E1, X1,
    Q1 and P1 call of one device-alone run held to its plain version;
    their times at each core call's shape.  -> ({label: numbers}, M1's,
    E1's, X1's and Q1's launches in the end-to-end runs by kernel, E1's
    worst |diff|, {label: E1's times}, P1's launches there, {label: P1's
    times}, {label: X1's times}, {label: Q1's times}, {label: M1's
    times})."""
    from ac3acm_tpu_torch.host import pack as PK
    from ac3acm_tpu_torch.models import encoder as PE
    from ac3acm_tpu_torch.parallel.encode import BatchedEncoder
    report, e1_times_by, e1_err = {}, {}, 0.0
    core_launches = {"M1": 0, "E1": 0, "X1": 0, "Q1": 0}
    p1_times_by, p1_launches, x1_times_by, q1_times_by = {}, 0, {}, {}
    m1_times_by = {}
    for label, B, F, nch, kbps in ENC_MAIN:
        pcm = enc_bench_pcm(nch, F, B)
        audio_s = B * F * 1536 / 48000.0
        outs, dts = {}, {}
        for pack in ("device", "native"):
            enc = BatchedEncoder(B, 48000, kbps * 1000, nch, pack=pack)
            enc.encode_frames(pcm[:, :1536])            # warm-up, 1 frame
            enc = BatchedEncoder(B, 48000, kbps * 1000, nch, pack=pack)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            zero_kernel_counts()
            t0 = time.perf_counter()
            with core_watch() as watch:
                outs[pack] = enc.encode_frames(pcm)
            dts[pack] = time.perf_counter() - t0
            peak = torch.cuda.max_memory_allocated()
            for k, n in core_assert(watch, f"encode {label} pack={pack}"
                                    ).items():
                core_launches[k] += n
            p1 = kernel_counts()["P1"]
            assert p1 == (watch["core"] if pack == "device" else 0), (
                label, pack, p1, watch["core"])
            p1_launches += p1
            log(f"encode {label} pack={pack}: {B} lanes x {F} frames, "
                f"{nch} ch {kbps} kbit/s, int16 PCM on the host -> bytes on "
                f"the host: {dts[pack]:.3f} s -> {audio_s / dts[pack]:.0f}x "
                f"realtime; peak {peak / 1e9:.2f} GB; M1, E1, X1, Q1 launches "
                f"{watch['launches']} for {watch['core']} core calls, P1 "
                f"launches {p1}, eager steps in the core "
                f"{sum(watch[k] for k in CORE_EAGER)}")
            assert peak <= PEAK_MEM_LIMIT
        same = outs["device"] == outs["native"]
        nbytes = sum(map(len, outs["device"]))
        log(f"encode {label}: device pack == native pack on all "
            f"{B * F} frames: {same}")
        assert same and nbytes == B * F * 2 * PE.make_config(
            48000, kbps * 1000, nch).frame_size
        # the device alone: PCM resident, encode + pack, synchronized
        enc = BatchedEncoder(B, 48000, kbps * 1000, nch)
        cfg = enc.cfg
        x = torch.from_numpy(np.ascontiguousarray(
            pcm.reshape(B, F, 1536, nch).transpose(1, 0, 2, 3))).to(enc.device)

        def dev_run():
            enc.last.zero_()
            enc.csnr.fill_(40)
            return encode_resident(enc, x)

        with core_watch(record=True) as watch, p1_watch(record=True) as pw:
            ok, fr = dev_run()
        core_assert(watch, f"encode {label} device alone")
        assert pw["launches"] == pw["n"] == watch["core"], (label, pw["n"])
        assert bool(ok.all())
        want = np.stack([np.frombuffer(o, np.uint8).reshape(F, -1)
                         for o in outs["device"]], 1)
        assert np.array_equal(fr.cpu().numpy(), want)
        e1_err = max([e1_err] + [e1_same(c) for c in watch["calls"]])
        e1_times_by[label] = dict(e1_times(watch["calls"][0]),
                                  rows=watch["calls"][0][0].shape[0])
        t = e1_times_by[label]
        log(f"encode {label}: all {len(watch['calls'])} E1 calls of a "
            f"device-alone run equal to the plain version bitwise (M, "
            f"fstar, bap); time snr_search (E1) at a core call "
            f"[{t['rows']}, 6, {nch}, 256]: kernel_ms {t['ms']:.4f}; "
            f"plain_ms {t['plain_ms']:.3f}; bound_ms {t['bound_ms']:.4f} "
            f"-> {t['bound_by']} ({t['bound_ms'] / t['ms']:.2%} of the "
            f"kernel's time); the design's floor, a model and not a "
            f"measurement (its prologue's and 13 passes' counted integer "
            f"instructions at {PEAK_ISSUE:.4e}/s) "
            f"{t['design_floor_ms']:.4f} ms "
            f"({t['design_floor_ms'] / t['ms']:.2%}); library_ms null (no "
            f"PyTorch call computes the curve and the search)")
        assert not any(m1_same(c) for c in watch["m1_calls"])
        m1_times_by[label] = dict(m1_times(watch["m1_calls"][0]),
                                  rows=watch["m1_calls"][0][0].shape[0])
        t = m1_times_by[label]
        n = t["rows"] * 6 * nch
        log(f"encode {label}: all {len(watch['m1_calls'])} M1 calls of a "
            f"device-alone run equal to window_mdct_ref bitwise (coef, "
            f"exp_samples); time window_mdct (M1) at a core call "
            f"[{t['rows']}, 6, {nch}, 256] ({n} transforms): kernel_ms "
            f"{t['ms']:.4f}; plain_ms {t['plain_ms']:.3f}; bound_ms "
            f"{t['bound_ms']:.4f} -> {t['bound_by']} "
            f"({t['bound_ms'] / t['ms']:.2%} of the kernel's time; the "
            f"function's {M1_TRANSFORM_OPS} integer instructions a transform "
            f"at {PEAK_ISSUE:.4e}/s: {n * M1_TRANSFORM_OPS / PEAK_ISSUE * 1e3:.4f}"
            f" ms); the design's model, not a measurement (the kernel's "
            f"{M1_SASS.get('window_mdct_kernel', 0)} SASS instructions, its "
            f"loop body once a transform, issued by 32 lanes at the same "
            f"rate) {t['model_ms']:.4f} ms ({t['model_ms'] / t['ms']:.2%}); "
            f"library_ms null (no PyTorch call computes the truncating int16 "
            f"FFT)")
        assert not any(x1_same(c) for c in watch["x1_calls"])
        assert not any(q1_same(c) for c in watch["q1_calls"])
        x1_times_by[label] = dict(x1_times(watch["x1_calls"][0]),
                                  rows=watch["x1_calls"][0][0].shape[0])
        q1_times_by[label] = dict(q1_times(watch["q1_calls"][0]),
                                  rows=watch["q1_calls"][0][0].shape[0])
        assert all(c[-1].dtype == torch.int16 for c in watch["q1_calls"])
        for name, t in (("exponents (X1)", x1_times_by[label]),
                        ("quantize (Q1)", q1_times_by[label])):
            int32 = (f"; int32 codes (the public functions' form) "
                     f"{t['ms_int32']:.4f} ms "
                     f"({t['bound_ms'] / t['ms_int32']:.2%})"
                     if "ms_int32" in t else "")
            log(f"encode {label}: all {len(watch['x1_calls'])} X1 and "
                f"{len(watch['q1_calls'])} Q1 calls of a device-alone run "
                f"equal to their plain versions bitwise (Q1 in both code "
                f"widths); time {name} at a core call [{t['rows']}, 6, "
                f"{nch}, 256]: kernel_ms {t['ms']:.4f}"
                + (" (int16 codes, the device-pack path's form)"
                   if int32 else "")
                + f"; plain_ms {t['plain_ms']:.3f}; bound_ms "
                f"{t['bound_ms']:.4f} -> {t['bound_by']} "
                f"({t['bound_ms'] / t['ms']:.2%} of the kernel's time)"
                + int32 + "; library_ms null")
        assert all(c[2].dtype == torch.int16 for c in pw["calls"])
        assert not any(p1_same(c) for c in pw["calls"])
        p1_times_by[label] = dict(p1_times(pw["calls"][0]),
                                  rows=p1_frames(pw["calls"][0]))
        t = p1_times_by[label]
        log(f"encode {label}: all {len(pw['calls'])} P1 calls of a "
            f"device-alone run (int16 codes from Q1) equal to "
            f"pack_frames_ref and to P1 on the same codes as int32 byte for "
            f"byte; time pack_frames (P1) at a core call [{t['rows']}, 6, "
            f"{nch}, 256] -> [{t['rows']}, {cfg.frame_size * 2}]: kernel_ms "
            f"{t['ms']:.4f} (int16 codes); int32 codes {t['ms_int32']:.4f} "
            f"({t['ms'] / t['ms_int32'] - 1:+.2%}); plain_ms "
            f"{t['plain_ms']:.3f}; bound_ms {t['bound_ms']:.4f} -> "
            f"{t['bound_by']} ({t['bound_ms'] / t['ms']:.2%} of the "
            f"kernel's time); library_ms null (no PyTorch call packs "
            f"frames)")
        # the stage run below quantizes and packs these same fields
        pack_least = sum(pack_least_bytes(c[0], c[1], c[4])
                         for c in pw["calls"])
        quant_least = sum(q1_least_bytes(c[3]) for c in watch["q1_calls"])
        del watch, pw
        dev_ms = cuda_ms(dev_run, warmup=1, reps=3)
        groups = {}
        for rows in sorted({B, PE.CORE_ROWS, B * F}):
            old = PE.CORE_ROWS
            PE.CORE_ROWS = rows
            torch.cuda.reset_peak_memory_stats()
            try:
                groups[rows] = (cuda_ms(dev_run, warmup=1, reps=3),
                                torch.cuda.max_memory_allocated())
                ok, fr2 = dev_run()
                assert torch.equal(fr2, fr)
            finally:
                PE.CORE_ROWS = old
        log(f"encode {label} on the device alone (PCM resident, encode + "
            f"device pack, synchronized): {dev_ms:.3f} ms -> "
            f"{audio_s / (dev_ms * 1e-3):.0f}x realtime; frames a core "
            f"call: " + "; ".join(
                f"{min(F, max(1, r // B))} ({r} rows) {ms:.3f} ms, peak "
                f"{pk / 1e9:.2f} GB" for r, (ms, pk) in groups.items()))
        # stages: CUDA events and peaks, the run of least total of three,
        # each enqueued behind a held card (torch.cuda._sleep, about 10 ms)
        # so that the host's pace opens no gap between marks; op counts in
        # another run
        best = None
        for _ in range(3):
            enc.last.zero_()
            enc.csnr.fill_(40)
            torch.cuda.synchronize()
            torch.cuda._sleep(20_000_000)
            clock = EventClock()
            encode_resident(enc, x, clock)
            got = clock.ms()
            if best is None or sum(got.values()) < sum(best[1].values()):
                best = (clock, got)
        clock, ms = best
        ops = OpClock()
        enc.last.zero_()
        enc.csnr.fill_(40)
        with ops.mode:
            encode_resident(enc, x, ops)
        least = stage_least_bytes(B * F, cfg.nb_coefs, pack_least,
                                  quant_least)
        total_ms = sum(ms.values())
        for name in ENC_STAGES:
            b_ms = least[name] / PEAK_BYTES * 1e3
            log(f"encode {label} stage {name}: {ms.get(name, 0.0):.3f} ms, "
                f"{ops.by.get(name, 0)} ATen ops, least {least[name]} B -> "
                f"bound {b_ms:.3f} ms ({b_ms / max(ms.get(name, 1e-9), 1e-9):.1%}); "
                f"peak allocated {clock.peak.get(name, 0) / 1e9:.2f} GB")
        io_bytes = B * F * 1536 * nch * 2 + nbytes
        io_ms = io_bytes / PEAK_BYTES * 1e3
        log(f"encode {label} whole: stages {total_ms:.3f} ms (the least "
            f"of three runs behind a held card; the synchronized device-"
            f"alone run {dev_ms:.3f} ms), "
            f"{sum(ops.by.values())} ATen ops; least bytes {io_bytes} (int16 "
            f"PCM once + frames once) -> bound {io_ms:.3f} ms "
            f"({io_ms / dev_ms:.2%} of the device time)")
        # the host packer alone on the same fields
        (_, _), res = PE.encode_pipeline_multi(cfg)(
            x, torch.zeros_like(enc.last), torch.full_like(enc.csnr, 40))
        host = {k: v.cpu().numpy() for k, v in res.items()}
        t0 = time.perf_counter()
        PK.pack_frames_native(cfg, host)
        host_s = time.perf_counter() - t0
        log(f"encode {label}: host pack='native' alone ({os.cpu_count()} "
            f"CPUs) {host_s:.3f} s for {B * F} frames")
        report[label] = dict(e2e_device=audio_s / dts["device"],
                             e2e_native=audio_s / dts["native"],
                             device=audio_s / (dev_ms * 1e-3))
        del x, enc, outs, res, host, fr
        torch.cuda.empty_cache()
    return (report, core_launches, e1_err, e1_times_by, p1_launches,
            p1_times_by, x1_times_by, q1_times_by, m1_times_by)


def phase_p1_loud():
    """P1 on the fields of a loud encode: seeded full-scale white noise
    through BatchedEncoder (pack="device", int16 codes) at config 4's
    format (2,048 lanes x 8 frames of 5.1 at 640 kbit/s), where most live
    bins carry a class.  Every P1 call of the run held to pack_frames_ref
    and to P1 on int32 codes byte for byte; the first timed in both code
    widths beside its bound from its own fields (p1_bound), so a design
    that wins only on sparse content shows.  -> its times, the coded
    share of live bins."""
    from ac3acm_tpu_torch.parallel.encode import BatchedEncoder
    _, B, F, nch, kbps = ENC_MAIN[1]
    rng = np.random.default_rng(18)
    pcm = rng.integers(-32768, 32768, (B, F * 1536, nch), dtype=np.int16)
    enc = BatchedEncoder(B, 48000, kbps * 1000, nch, pack="device")
    with p1_watch(record=True) as pw:
        out = enc.encode_frames(pcm)
    assert pw["launches"] == pw["n"] >= 1, pw["n"]
    assert len(out) == B and all(len(o) == F * enc.cfg.frame_size * 2
                                 for o in out)
    assert all(c[2].dtype == torch.int16 for c in pw["calls"])
    assert not any(p1_same(c) for c in pw["calls"])
    call = pw["calls"][0]
    cfg, bap = call[0], call[1]
    live = (torch.arange(256, device=bap.device)
            < torch.tensor(cfg.nb_coefs, device=bap.device)[:, None])
    share = float(((bap != 0) & live).sum()) / float(
        live.sum() * bap.numel() // (nch * 256))
    t = dict(p1_times(call), rows=p1_frames(call), coded_share=share)
    log(f"P1 on loud content (full-scale white noise, {B} lanes x {F} "
        f"frames of {nch} ch at {kbps} kbit/s; {len(pw['calls'])} calls "
        f"equal to pack_frames_ref and to P1 on int32 codes byte for "
        f"byte): {share:.1%} of live bins carry a class; at a call of "
        f"{t['rows']} frames kernel_ms {t['ms']:.4f} (int16 codes); int32 "
        f"codes {t['ms_int32']:.4f} ({t['ms'] / t['ms_int32'] - 1:+.2%}); "
        f"plain_ms {t['plain_ms']:.3f}; bound_ms "
        f"{t['bound_ms']:.4f} -> {t['bound_by']} "
        f"({t['bound_ms'] / t['ms']:.2%} of the kernel's time)")
    del pw, call, bap, enc, out
    torch.cuda.empty_cache()
    return t


def wrapper_host_costs():
    """The host cost of X1's and P1's wrappers at the single Encoder's
    call (16 rows of 2.0 at 192 kbit/s; X1 on an Encoder call's own
    coefficients, P1 on p1_case's fields), and of the occupancy query
    (the shared-memory attribute and the occupancy calculator) that each
    launch function makes once a device (and frame size) and then
    remembers; logged."""
    from ac3acm_tpu_torch.models.encoder import Encoder
    from ac3acm_tpu_torch.ops import exponents as EX
    from ac3acm_tpu_torch.ops import pack_device as PD
    with core_watch(record=True) as rec:
        Encoder(48000, 192000, 2).encode(enc_bench_pcm(2, 16, 1)[0])
    coef, es, nb, lfe = rec["x1_calls"][0][:4]
    work = coef.clone()
    config = (2, 48000, 192)
    cfg, f = p1_case(config, 1500 + P1_CONFIGS.index(config))
    args = [torch.from_numpy(np.ascontiguousarray(f[k][:16])).cuda()
            for k in P1_KEYS]
    got = {"X1 wrapper": host_us(lambda: EX.exponents(work, es, nb, lfe)),
           "X1 query": host_us(lambda: EX.resident_ctas(2)),
           "P1 wrapper": host_us(lambda: PD.pack_frames_device(cfg, *args)),
           "P1 query": host_us(lambda: PD.resident_frames(cfg))}
    log(f"host cost at the single Encoder's call ({coef.shape[0]} rows of "
        f"2.0; mean of 200 calls, no synchronize): X1's wrapper "
        f"{got['X1 wrapper']:.1f} us a call, P1's {got['P1 wrapper']:.1f} "
        f"us; the occupancy query a launch makes once a device and then "
        f"remembers: X1 {got['X1 query']:.1f} us, P1 {got['P1 query']:.1f} "
        f"us")
    return got


def phase_enc_single():
    """Encoder over ENC_SINGLE_FRAMES frames; a 17-frame call equal to
    lane 0 of a BatchedEncoder; PcmToAc3Stream (ragged feeds) and the a52
    encode API equal to Encoder; a round trip through Decoder()."""
    from ac3acm_tpu_torch import a52
    from ac3acm_tpu_torch import tables as T
    from ac3acm_tpu_torch.io.stream import Ac3Format, PcmToAc3Stream
    from ac3acm_tpu_torch.models.decoder import Decoder
    from ac3acm_tpu_torch.models.encoder import Encoder
    from ac3acm_tpu_torch.parallel.encode import BatchedEncoder
    pcm = enc_bench_pcm(2, ENC_SINGLE_FRAMES, 1)[0]
    Encoder(48000, 192000, 2).encode(pcm[:1536])          # warm-up
    enc = Encoder(48000, 192000, 2)
    zero_kernel_counts()
    t0 = time.perf_counter()
    with core_watch() as watch:
        out = enc.encode(pcm)
    dt = time.perf_counter() - t0
    launches = core_assert(watch, "single-stream Encoder")
    audio_s = ENC_SINGLE_FRAMES * 1536 / 48000.0
    wrapper_host_costs()
    assert len(out) == ENC_SINGLE_FRAMES * 768
    p17 = mixed_pcm(2, 17, 17)[0]
    one = Encoder(48000, 192000, 2).encode(p17)
    lane = BatchedEncoder(1, 48000, 192000, 2).encode_frames(p17[None])[0]
    st = PcmToAc3Stream(Ac3Format(2, 48000, 192))
    cuts = [0, 7, 1536 * 3 + 5, 1536 * 10, 1536 * 17]
    fed = b"".join(st.convert(p17[a:b]) for a, b in zip(cuts, cuts[1:]))
    h = a52.AC3_encode_init(48000, 192000, 2)
    api = b"".join(a52.AC3_encode_frame(h, p17[f * 1536:(f + 1) * 1536])
                   for f in range(17))
    log(f"single-stream Encoder: {ENC_SINGLE_FRAMES} frames in {dt:.3f} s "
        f"-> {audio_s / dt:.1f}x realtime, M1, E1, X1, Q1 launches "
        f"{launches} "
        f"for "
        f"{watch['core']} core calls; a 17-frame call == lane 0 of "
        f"BatchedEncoder {one == lane}; PcmToAc3Stream (feeds of 7 B..) == "
        f"Encoder {fed == one}; AC3_encode_frame == Encoder {api == one}")
    assert one == lane == fed == api
    mp = mixed_pcm(2, 4, 21)[0]
    es = Encoder(48000, 192000, 2).encode(mp)
    dec, _ = Decoder().decode_stream(es, T.A52_STEREO | T.A52_ADJUST_LEVEL,
                                     level=1.0, bias=0.0)
    mine = np.moveaxis(np.asarray(dec), 1, 2).reshape(-1, 2)[256:] * 32768.0
    orig = mp[: mine.shape[0]].astype(np.float64)
    snr = 10 * np.log10((orig ** 2).mean() / ((mine - orig) ** 2).mean())
    log(f"single-stream round trip through Decoder(): SNR {snr:.2f} dB")
    assert snr > 12.0
    return audio_s / dt, launches


def phase_transcode():
    """Config 5 in reference mode through Transcoder: native f32, compact
    and raw (and a coupled raw batch); every B1F and gather call held to
    its plain version; the digest of the first lanes; f32 equal to its
    composition on a subset of lanes.  -> (launches by kernel, worst
    |diff| by kernel, x-realtime by path)."""
    from ac3acm_tpu_torch.models import decoder as PD
    from ac3acm_tpu_torch.parallel.encode import BatchedEncoder
    from ac3acm_tpu_torch.parallel.pipeline import BatchedDecoder
    from ac3acm_tpu_torch.parallel.transcode import Transcoder, enc_input
    assert PD.ACCURACY == "reference"
    chunks = tc_chunks(TC_BATCH)
    audio_s = TC_BATCH * TC_NCHUNKS * TC_CHUNK_FRAMES * 1536 / 48000.0
    launches, worst, rt, errs, wires = {}, {}, {}, {}, {}
    outs = {}
    # M1's, E1's, X1's, Q1's and P1's calls of the first native f32 chunk,
    # recorded (inputs and outputs cloned) in an untimed pass of their own
    with core_watch(record=True) as w, p1_watch(record=True) as pw:
        Transcoder(TC_BATCH, 192000, 2).step_frames(chunks[0],
                                                    TC_CHUNK_FRAMES)
    core_assert(w, "transcode native f32, recorded")
    assert pw["launches"] == pw["n"] == w["core"], (pw["n"], w["core"])
    e1_calls, p1_calls = w["calls"], pw["calls"]
    x1_calls, q1_calls = w["x1_calls"], w["q1_calls"]
    m1_calls = w["m1_calls"]
    for tag, kw, lanes, want in (
            ("native f32", {}, chunks, ("B1F",)),
            ("native compact", dict(compact_h2d=True), chunks, ("B1F",)),
            ("raw", dict(parser="raw"), chunks,
             ("B1F", "extract_fields", "extract_i16_table")),
            ("raw coupled", dict(parser="raw"),
             tc_chunks(TC_CPL_BATCH, CPL_GOLDEN, rotate=False),
             ("B1F", "extract_fields", "extract_fields_shared"))):
        n = len(lanes[0])
        tc = Transcoder(n, 192000, 2, **kw)
        got, per_chunk = [b""] * n, []

        def run():
            nonlocal got
            for data in lanes:
                before = kernel_counts()
                with core_watch() as w:
                    got = [a + b for a, b in zip(got, tc.step_frames(
                        data, TC_CHUNK_FRAMES))]
                per_chunk.append({k: v - before[k]
                                  for k, v in kernel_counts().items()})
                core_assert(w, f"transcode {tag}")
                assert tc.ok.all(), tag

        torch.cuda.synchronize()
        zero_kernel_counts()
        t0 = time.perf_counter()
        with record_steady() as steady:
            gathers = record_gathers(run)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        counts = kernel_counts()
        outs[tag] = got
        for c in per_chunk:
            assert all(c[k] >= 1 for k in want + ("M1", "E1", "X1", "Q1",
                                                  "P1")), (tag, per_chunk)
            assert c["K1"] == 0 and c["B1"] == 0, (tag, per_chunk)
        for k, v in counts.items():
            launches[k] = launches.get(k, 0) + v
        check_gather_calls(gathers, f"transcode {tag}", errs, wires)
        for k, v in check_steady_calls(steady, f"transcode {tag}").items():
            worst[k] = max(worst.get(k, 0.0), v)
        rt[tag] = n * TC_NCHUNKS * TC_CHUNK_FRAMES * 1536 / 48000.0 / dt
        log(f"transcode {tag}: {n} lanes x {TC_NCHUNKS} chunks x "
            f"{TC_CHUNK_FRAMES} frames, step_frames {dt:.3f} s -> "
            f"{rt[tag]:.0f}x realtime; launches per chunk "
            f"{[{k: c[k] for k in c if c[k]} for c in per_chunk]}")
        del tc, steady, gathers
        torch.cuda.empty_cache()
    for k, v in errs.items():
        worst[k] = max(worst.get(k, 0.0), v)
    worst["E1"] = max(e1_same(call) for call in e1_calls)
    worst["P1"] = max(p1_same(call) for call in p1_calls)
    worst["X1"] = max(x1_same(call) for call in x1_calls)
    worst["Q1"] = max(q1_same(call) for call in q1_calls)
    worst["M1"] = max(m1_same(call) for call in m1_calls)
    log(f"transcode: the first native f32 chunk's {len(e1_calls)} E1 calls "
        f"equal to the plain version bitwise (M, fstar, bap), its "
        f"{len(m1_calls)} M1, {len(x1_calls)} X1 and {len(q1_calls)} Q1 "
        f"calls to theirs, its {len(p1_calls)} P1 calls to pack_frames_ref "
        f"byte for byte")
    del e1_calls, p1_calls, x1_calls, q1_calls, m1_calls
    dig = tc_digest(outs["native f32"])
    same_raw = outs["raw"] == outs["native f32"]
    ndiff = sum(a != b for a, b in zip(outs["native compact"],
                                       outs["native f32"]))
    log(f"transcode digest of the first {TC_DIGEST_LANES} lanes "
        f"{dig[:16]} (JAX {TC_DIGEST[:16]}); raw == native {same_raw}; "
        f"compact lanes that differ from f32: {ndiff} of {TC_BATCH}")
    assert dig == TC_DIGEST and same_raw
    # the f32 transcode equals its composition on a subset of lanes
    sub = min(64, TC_BATCH)
    dec = BatchedDecoder(sub, FLAGS_51_TO_20, 1.0, 384.0, None, True)
    enc = BatchedEncoder(sub, 48000, 192000, 2)
    comp = [b""] * sub
    for data in chunks:
        for i in range(sub):
            dec.feed(i, data[i])
        pcm, valid = dec.decode_available(max_frames=TC_CHUNK_FRAMES)
        x = enc_input(pcm, 2)
        ok, fr = encode_resident(enc, x)
        assert valid.all() and bool(ok.all())
        fr = fr.cpu().numpy()
        comp = [c + fr[:, b].tobytes() for b, c in enumerate(comp)]
    log(f"transcode: the first {sub} lanes == BatchedDecoder int16 -> "
        f"BatchedEncoder {comp == outs['native f32'][:sub]}")
    assert comp == outs["native f32"][:sub]
    # pipelined dispatch_frames/finish, two chunks in flight
    tc = Transcoder(TC_BATCH, 192000, 2)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    h = [tc.dispatch_frames(d, TC_CHUNK_FRAMES) for d in chunks]
    piped = [tc.finish(x) for x in h]
    dt = time.perf_counter() - t0
    piped = [a + b for a, b in zip(*piped)]
    rt["native f32 pipelined"] = audio_s / dt
    log(f"transcode native f32 dispatch_frames x {TC_NCHUNKS} then finish: "
        f"{dt:.3f} s -> {audio_s / dt:.0f}x realtime; == step_frames "
        f"{piped == outs['native f32']}")
    assert piped == outs["native f32"]
    return launches, worst, rt


def fixed_frames(path, flags, nframes=None):
    """ac3h_sdec_parse_fixed over a golden's frames (DRC on): the fixed
    device path's blocks, one (StreamFormat, blocks) a frame, numpy:
    freq int32 [6, 6, 256], blksw bool [6, 5], coeff float32 0/1 [6, 5],
    remat False [6, 256], bias zeros [6]."""
    import ctypes as C
    from ac3acm_tpu_torch.host.native import get_lib
    from ac3acm_tpu_torch.models.decoder import StreamFormat
    lib = get_lib()
    d = lib.ac3h_sdec_new(0)
    out = []
    for fb in golden_frames(path)[:nframes]:
        freq = np.zeros((6, 6, 256), np.int32)
        blksw = np.zeros((6, 5), np.uint8)
        czero = np.zeros((6, 5), np.uint8)
        meta = np.zeros(6, np.int32)
        assert lib.ac3h_sdec_parse_fixed(
            d, fb, flags, float(1 << 26), C.c_void_p(freq.ctypes.data),
            C.c_void_p(blksw.ctypes.data), C.c_void_p(czero.ctypes.data),
            C.c_void_p(meta.ctypes.data)) == 0
        fmt = StreamFormat(acmod=int(meta[0]), output=int(meta[1]),
                           slev_zero=bool(meta[3]), chanbias=int(meta[2]))
        out.append((fmt, {"freq": freq, "blksw": blksw.astype(bool),
                          "coeff": 1.0 - czero.astype(np.float32),
                          "remat": np.zeros((6, 256), bool),
                          "bias": np.zeros(6, np.int32)}))
    lib.ac3h_sdec_free(d, 0)
    return out


def fixed_planes(path, flags):
    """The Q30 planes the fixed device path's transform reads, [frames *
    36, 256] int32 (6 blocks x 6 channel slots a frame), and each row's
    short-block flag (the LFE slot long)."""
    frames = fixed_frames(path, flags)
    rows = [b["freq"].reshape(36, 256) for _, b in frames]
    flags_out = [np.concatenate([b["blksw"], np.zeros((6, 1), bool)],
                                1).reshape(36) for _, b in frames]
    return np.concatenate(rows), np.concatenate(flags_out)


def b1q_same(x, blk, what):
    """B1Q against its plain version, bitwise -> max |diff| (0)."""
    from ac3acm_tpu_torch.ops import imdct_exact as IE
    z, d = IE.split_fb_fixed(x, blk)
    zr, dr = IE.split_fb_fixed_ref(x, blk)
    torch.cuda.synchronize()
    err = max(int((z.long() - zr.long()).abs().max()),
              int((d.long() - dr.long()).abs().max()))
    assert torch.equal(z, zr) and torch.equal(d, dr), (what, err)
    return float(err)


def phase_check_b1q(dev):
    """B1Q (the Q30 split, csrc/imdct_exact.cu:imdct_fixed_kernel) against
    its plain version BITWISE: the 5.1 golden's real Q30 planes tiled to
    the main chunk's 786,432 rows, long and with 30% short rows; edge rows
    (full-range random int32, INT32_MIN / INT32_MAX, zeros, one non-zero
    bin) long, short and mixed; ragged row counts; the real planes with
    their own flags; an unaligned view, which must raise.  -> (the tiled
    rows, max |diff|)."""
    from ac3acm_tpu_torch.ops import imdct_exact as IE
    rng = np.random.default_rng(17)
    planes, own = fixed_planes(GOLDEN, FLAGS_51_TO_20)
    worst, cases = 0.0, 0
    R = MAIN_BATCH * CHUNK_FRAMES * 6 * 2                # B1's chunk rows
    tiled = torch.from_numpy(
        np.resize(planes, (R, 256))).to(dev).contiguous()
    for tag, blk in (("long", None),
                     ("30% short", torch.rand(R, device=dev) < 0.3)):
        worst = max(worst, b1q_same(tiled, blk, tag))
        cases += 1
    n = 64
    edge = np.concatenate([
        rng.integers(-2 ** 31, 2 ** 31, (n, 256), dtype=np.int64),
        np.where(rng.random((n, 256)) < 0.5, -2 ** 31, 2 ** 31 - 1),
        np.full((4, 256), -2 ** 31), np.full((4, 256), 2 ** 31 - 1),
        np.zeros((4, 256), np.int64)]).astype(np.int32)
    one = np.zeros((256, 256), np.int32)
    one[np.arange(256), np.arange(256)] = rng.integers(
        -2 ** 31, 2 ** 31, 256, dtype=np.int64).astype(np.int32)
    edge = torch.from_numpy(np.concatenate([edge, one])).to(dev)
    E = edge.shape[0]
    for blk in (None, torch.zeros(E, dtype=torch.bool),
                torch.ones(E, dtype=torch.bool),
                torch.from_numpy(rng.random(E) < 0.5)):
        worst = max(worst, b1q_same(edge, None if blk is None else
                                    blk.to(dev), "edge rows"))
        cases += 1
    real = torch.from_numpy(planes).to(dev)
    worst = max(worst, b1q_same(real, torch.from_numpy(own).to(dev),
                                "real planes, own flags"))
    cases += 1
    for rows in (1, 5, 6, 31, 33):
        x = edge[:rows].contiguous()
        for blk in (None, torch.from_numpy(rng.random(rows) < 0.5).to(dev)):
            worst = max(worst, b1q_same(x, blk, ("ragged", rows)))
            cases += 1
    flat = torch.zeros(5 * 256 + 1, dtype=torch.int32, device=dev)
    try:
        IE.split_fb_fixed(flat[1:].view(5, 256))
        raise AssertionError("an unaligned view was accepted")
    except ValueError as e:
        assert "aligned" in str(e), e
    log(f"check imdct_fixed (B1Q): {cases} cases equal to the plain version "
        f"bitwise (the 5.1 golden's {planes.shape[0]} real Q30 rows tiled "
        f"to {R} rows, long and 30% short; {E} edge rows: full-range "
        f"int32, INT32_MIN/INT32_MAX, zeros, one non-zero bin, long, short "
        f"and mixed; the real rows with their own flags; ragged 1, 5, 6, "
        f"31, 33 rows), max |diff| {worst}; an unaligned view raises")
    return tiled, worst


def phase_times_b1q(tiled):
    """B1Q at B1's 786,432 long rows and at the fixed path's 5-row call:
    kernel, plain version, bound (bytes or integer instructions, the
    larger; bytes at both sizes).
    No PyTorch call computes a Q30 split-16 IMDCT: library_ms is null."""
    from ac3acm_tpu_torch.ops import imdct_exact as IE
    out = {}
    for R, x in ((tiled.shape[0], tiled), (5, tiled[:5].contiguous())):
        before = IE.launches_fixed
        ms = cuda_ms(lambda: IE.split_fb_fixed(x))
        per_call = (IE.launches_fixed - before) / 9
        plain_ms = cuda_ms(lambda: IE.split_fb_fixed_ref(x), warmup=1,
                           reps=3)
        nbytes = R * (256 + 256 + 128) * 4
        t_bytes = nbytes / PEAK_BYTES * 1e3
        t_ops = R * B1Q_LONG_ROW_OPS / PEAK_ISSUE * 1e3
        bound_ms = max(t_bytes, t_ops)
        bound_by = "bytes" if t_bytes >= t_ops else "operations"
        log(f"time imdct_fixed (B1Q) [{R} long rows]: kernel_ms {ms:.4f} "
            f"plain_ms {plain_ms:.3f}; bounds: bytes {nbytes} B / 3.35e12 "
            f"B/s = {t_bytes:.5f} ms | integer instructions "
            f"{R * B1Q_LONG_ROW_OPS:.4e} / {PEAK_ISSUE:.4e} issued/s = "
            f"{t_ops:.5f} ms; bound_ms {bound_ms:.5f} -> {bound_by} "
            f"({bound_ms / ms:.1%} of the kernel's time); library_ms null "
            f"(no PyTorch call computes a Q30 split-16 IMDCT); {per_call:g} "
            f"launch per call")
        out[R] = dict(ms=ms, plain_ms=plain_ms, library_ms=None,
                      bound_ms=bound_ms, bound_by=bound_by)
    big, small = out[tiled.shape[0]], out[5]
    return dict(big, ms_5_rows=small["ms"], plain_ms_5_rows=small["plain_ms"],
                bound_ms_5_rows=small["bound_ms"])


# B1QS: the fixed block chain.  The JAX digest's cases take the formats
# of the fixed parse of the 5.1 golden to 2F2R, mono and 3F2R|LFE and of
# the stereo golden to 2.0 (acmod, output, slev_zero, chanbias); the
# digest is sha256 over each case's PCM, delay and downmixed
# (b1qs_digest), recomputed from the JAX package by
# tests/test_torch_fixed_chain.py
B1QS_DIGEST_FORMATS = ((7, 6, False, 7), (7, 1, False, 31),
                       (7, 23, False, 0), (2, 2, True, 0))
B1QS_DIGEST_BLOCKS = 7
B1QS_DIGEST = (
    "6f4e4dc168a4acae006d606f6c3cff136d9cdde8fe74ab537c4fb2c4d4331658")
# integer instructions of one short row of the Q30 IMDCT, counted as
# B1Q_LONG_ROW_OPS: 1,560 MULs (pre-twiddle 512, 10 ifft8 x 4, the
# passes 144 + 112 + 240, post-twiddle 512) at 7 each and 2,336 adds
B1Q_SHORT_ROW_OPS = 1560 * 7 + 2336
# one output of the Q30 overlap-add: two MULs at 7 and two adds
OLA_SAMPLE_OPS = 2 * 7 + 2


def b1qs_blocks(rng, n, kind):
    """Synthetic chain blocks (numpy): "full" full-range int32 planes
    (adds wrap), blksw at random (mixed, seldom uniform), channel 2
    without coefficients and others at random, random remat and bias;
    "short" every block short, "long" every block long with channel 4
    without coefficients, both Q30-scale, remat off, bias 0."""
    if kind == "full":
        freq = rng.integers(-2 ** 31, 2 ** 31, (n, 6, 256), dtype=np.int64)
        blksw = rng.random((n, 5)) < 0.5
        coeff = (rng.random((n, 5)) < 0.8).astype(np.float32)
        coeff[:, 2] = 0.0
        remat = rng.random((n, 256)) < 0.5
        bias = rng.integers(-2 ** 31, 2 ** 31, n, dtype=np.int64)
    else:
        freq = rng.standard_normal((n, 6, 256)) * 2 ** 27
        blksw = np.full((n, 5), kind == "short")
        coeff = np.ones((n, 5), np.float32)
        if kind == "long":
            coeff[:, 4] = 0.0
        remat = np.zeros((n, 256), bool)
        bias = np.zeros(n)
    return {"freq": freq.astype(np.int32), "blksw": blksw, "coeff": coeff,
            "remat": remat, "bias": bias.astype(np.int32)}


def b1qs_carry(rng, downmixed):
    """A full-range delay and the given downmixed flag (numpy)."""
    return (rng.integers(-2 ** 31, 2 ** 31, (6, 128),
                         dtype=np.int64).astype(np.int32),
            np.array(bool(downmixed)))


def b1qs_digest_cases():
    """The JAX digest's inputs: one case a format of B1QS_DIGEST_FORMATS,
    B1QS_DIGEST_BLOCKS blocks each (a group of 6 and a tail) ->
    [((acmod, output, slev_zero, chanbias), carry, blocks)], numpy."""
    rng = np.random.default_rng(2026)
    return [(spec, b1qs_carry(rng, dmx),
             b1qs_blocks(rng, B1QS_DIGEST_BLOCKS, kind))
            for spec, kind, dmx in zip(B1QS_DIGEST_FORMATS,
                                       ("full", "short", "full", "long"),
                                       (True, False, False, True))]


def b1qs_digest(outs):
    """sha256 over each case's ((delay, downmixed), pcm) in order: the
    int32 PCM and delay, then one byte for downmixed."""
    import hashlib
    h = hashlib.sha256()
    for (delay, downmixed), pcm in outs:
        h.update(np.ascontiguousarray(np.asarray(pcm), np.int32).tobytes())
        h.update(np.ascontiguousarray(np.asarray(delay), np.int32).tobytes())
        h.update(bytes([bool(np.asarray(downmixed))]))
    return h.hexdigest()


def on_card(carry, blocks, dev):
    return (tuple(torch.as_tensor(x, device=dev) for x in carry),
            {k: torch.as_tensor(v, device=dev) for k, v in blocks.items()})


def b1qs_plain(fmt, calls):
    """Every call (carry, blocks, ((delay, downmixed), pcm)) of one format
    and one block count against the plain version (fixed_chain_ref, the
    eager _block_step loop on the card), all of them in one pass with a
    lane axis (torch.func.vmap), bitwise -> max |diff| (0)."""
    import functools
    from ac3acm_tpu_torch.ops import fixed_chain as FC
    carry = tuple(torch.stack([c[0][i] for c in calls]) for i in range(2))
    blocks = {k: torch.stack([c[1][k] for c in calls]) for k in calls[0][1]}
    (d, m), p = torch.func.vmap(functools.partial(FC.fixed_chain_ref, fmt))(
        carry, blocks)
    gd, gm, gp = (torch.stack([c[2][0][0] for c in calls]),
                  torch.stack([c[2][0][1] for c in calls]),
                  torch.stack([c[2][1] for c in calls]))
    err = max(int((p.long() - gp.long()).abs().max()),
              int((d.long() - gd.long()).abs().max()))
    assert torch.equal(p, gp) and torch.equal(d, gd) and torch.equal(m, gm), \
        (fmt, err, m.tolist(), gm.tolist())
    return float(err)


def b1qs_group(calls):
    """Recorded calls (fmt, carry, blocks, out) -> {(fmt, n): [(carry,
    blocks, out)]}."""
    groups = {}
    for fmt, carry, blocks, out in calls:
        groups.setdefault((fmt, blocks["freq"].shape[0]), []).append(
            (carry, blocks, out))
    return groups


def phase_check_b1qs(dev):
    """B1QS (the fixed block chain, csrc/imdct_exact.cu:fixed_chain_kernel)
    against its plain version BITWISE (pcm, delay and downmixed): the 5.1
    golden's real Q30 blocks (ac3h_sdec_parse_fixed) to every output the
    fixed backend takes, 13 blocks each (two groups and a tail); the
    stereo golden and the short-block hazard stream to 2.0; the 5.1 ->
    2.0 switch, the carry crossing two calls; synthetic blocks with n
    from 1 to 13 (full-range int32 planes, mixed blksw, zero-coefficient
    channels, all short, all long; carries with downmixed True and
    False, full-range delays) in four formats; the JAX digest's cases,
    whose sha256 must equal B1QS_DIGEST; n = 0 gives the carry back;
    bad inputs raise.  -> max |diff|."""
    from ac3acm_tpu_torch.models.decoder import StreamFormat
    from ac3acm_tpu_torch.ops import fixed_chain as FC
    calls = []

    def run(fmt, carry, blocks):
        carry, blocks = on_card(carry, blocks, dev)
        out = FC.fixed_chain(fmt, carry, blocks)
        calls.append((fmt, carry, blocks, out))
        return out

    def stack(frames):
        return {k: np.concatenate([b[k] for _, b in frames])
                for k in frames[0][1]}

    init = (np.zeros((6, 128), np.int32), np.array(True))
    real = []
    for flags in (2, 10, 1, 3, 4, 6, 5, 7 | 16):
        frames = fixed_frames(GOLDEN, flags | 32, 3)
        blocks = {k: v[:13] for k, v in stack(frames).items()}
        run(frames[0][0], init, blocks)
        real.append(frames[0][0])
    for path in (STEREO_GOLDEN, os.path.join(HERE, "tests", "golden",
                                             "blksw20_hazard.ac3")):
        frames = fixed_frames(path, FLAGS_51_TO_20, 2)
        run(frames[0][0], init, stack(frames))
    # the switch: two calls, the second from the first one's carry
    b51 = fixed_frames(GOLDEN, FLAGS_51_TO_20, 1)[0]
    st = fixed_frames(STEREO_GOLDEN, FLAGS_51_TO_20, 1)[0]
    carry, _ = run(b51[0], init, b51[1])
    (sw_d, sw_m), sw_p = run(st[0], carry, st[1])
    carry, _ = FC.fixed_chain_ref(b51[0], *on_card(init, b51[1], dev))
    (rd, rm), rp = FC.fixed_chain_ref(st[0], carry,
                                      on_card((), st[1], dev)[1])
    assert torch.equal(sw_p, rp) and torch.equal(sw_d, rd) and \
        torch.equal(sw_m, rm), "the 5.1 -> 2.0 switch"
    rng = np.random.default_rng(12)
    edge_formats = (StreamFormat(7, 2, False, 31), StreamFormat(2, 2, True, 0),
                    StreamFormat(7, 23, False, 0), StreamFormat(6, 1, True, 1))
    for n in range(1, 14):
        fmt = edge_formats[n % 4]
        for kind in ("full", "short", "long"):
            for dmx in (True, False):
                run(fmt, b1qs_carry(rng, dmx), b1qs_blocks(rng, n, kind))
    digest_outs = []
    for spec, carry, blocks in b1qs_digest_cases():
        (d, m), p = run(StreamFormat(*spec), carry, blocks)
        digest_outs.append(((d.cpu().numpy(), m.cpu().numpy()),
                            p.cpu().numpy()))
    digest = b1qs_digest(digest_outs)
    worst = 0.0
    for (fmt, _), group in b1qs_group(calls).items():
        worst = max(worst, b1qs_plain(fmt, group))
    # n = 0: the carry back and no PCM
    carry, blocks = on_card(init, {k: v[:0] for k, v in
                                   b1qs_blocks(rng, 1, "long").items()}, dev)
    (d, m), p = FC.fixed_chain(real[0], carry, blocks)
    assert torch.equal(d, carry[0]) and bool(m) and p.shape == (0, 2, 256)
    # refusals: a wrong dtype, a strided view, an unaligned view
    carry, blocks = on_card(init, b1qs_blocks(rng, 2, "long"), dev)
    flat = torch.zeros(2 * 6 * 256 + 1, dtype=torch.int32, device=dev)
    for key, bad, err in (
            ("freq", blocks["freq"].long(), TypeError),
            ("blksw", blocks["blksw"].to(torch.uint8), TypeError),
            ("coeff", blocks["coeff"].double(), TypeError),
            ("freq", blocks["freq"].transpose(1, 2).contiguous().transpose(
                1, 2), ValueError),
            ("freq", flat[1:].view(2, 6, 256), ValueError),
            ("bias", blocks["bias"][:1], ValueError),
            ("remat", blocks["remat"].cpu(), ValueError)):
        try:
            FC.fixed_chain(real[0], carry, {**blocks, key: bad})
            raise AssertionError(f"bad {key} was accepted")
        except err:
            pass
    log(f"check fixed_chain (B1QS): {len(calls)} calls equal to the plain "
        f"version bitwise in pcm, delay and downmixed (the 5.1 golden to "
        f"{len(real)} outputs x 13 blocks, the stereo golden and the "
        f"short-block hazard stream to 2.0, the 5.1 -> 2.0 switch across "
        f"two calls, synthetic n = 1..13 x full-range / all short / all "
        f"long x downmixed True / False in 4 formats, the JAX digest's "
        f"{len(digest_outs)} cases), max |diff| {worst}; digest {digest} "
        f"== JAX's {digest == B1QS_DIGEST}; n = 0 returns the carry; bad "
        f"dtypes, a strided, an unaligned and a short input and a CPU "
        f"tensor raise")
    assert digest == B1QS_DIGEST, digest
    return worst


def device_ms(fn, warmup=2, reps=7):
    """Median milliseconds of fn()'s device work alone: the card is held
    busy (torch.cuda._sleep) while the host enqueues fn, so its launch
    overhead on the host does not open gaps between the events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(2_000_000)
        t0.record()
        fn()
        t1.record()
        t1.synchronize()
        times.append(t0.elapsed_time(t1))
    return float(np.median(times))


def b1qs_bound(fmt, blocks):
    """The least time of one B1QS call on these inputs: the larger of its
    bytes (every input read once, the PCM and the carry written once) at
    the card's memory rate and its integer instructions at the card's
    issue rate (PEAK_ISSUE: the rows' splits do not depend on one another
    and the overlap-add and mixes run per sample, so the function needs
    no one SM).  The instructions are the split of the rows the chain
    reads (each block's path rows, long or short as its blksw says, less
    a frequency-path row whose downmix row is zero, whose input and split
    are 0, or a time-path channel without coefficients, whose split is not
    read; and the LFE long) and the overlap-add of the planes it emits or
    carries.  Beside it, the same instructions at one SM's issue rate.
    -> (bound_ms, "bytes" | "operations", instructions, one_sm_ms)."""
    from ac3acm_tpu_torch.ops import fixed_chain as FC
    D = FC.affine_mixers(fmt.acmod, fmt.output, fmt.slev_zero)[0]
    bs, nf, nfo = blocks["blksw"], fmt.nfchans, fmt.nf_out
    ops = 0
    for blk, cf in zip(bs, blocks["coeff"]):
        fp = nfo < nf and bool((blk[:nf] == blk[0]).all())
        rows = ([bool(blk[0]) for p in range(5) if D[p].any()] if fp
                else [bool(x) for x, c in zip(blk, cf) if c != 0])
        ops += sum(B1Q_SHORT_ROW_OPS if r else B1Q_LONG_ROW_OPS
                   for r in rows)
        ops += (B1Q_LONG_ROW_OPS + 256 * OLA_SAMPLE_OPS) * fmt.lfe_out
        ops += 256 * OLA_SAMPLE_OPS * (nfo if fp else len(rows))
    n = len(bs)
    nbytes = (sum(np.asarray(v).nbytes for v in blocks.values())
              + 2 * (6 * 128 * 4 + 1) + n * fmt.nch_out * 256 * 4)
    t_bytes = nbytes / PEAK_BYTES * 1e3
    t_ops = ops / PEAK_ISSUE * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops
            else "operations", ops, ops / (PEAK_ISSUE / 132) * 1e3)


def b1qs_shape(lib):
    """(dynamic shared memory bytes a CTA, threads a CTA, CTAs) of the B1QS
    launch, as the built library reports them."""
    import ctypes
    shape = (ctypes.c_int * 3)()
    lib.fixed_chain_shape(shape)
    return tuple(shape)


def phase_times_b1qs(dev):
    """B1QS on one frame (6 blocks) of the 5.1 golden to 2.0 and to
    3F2R|LFE: the kernel's device time (device_ms), the wrapper's host
    time a call, the call with no blocks (the kernel's prologue and the
    launch: the carry alone) beside a bare launch (a kernel that does
    nothing: one CTA, and a cluster of B1QS's shape),
    the plain version, the bound and the same instructions at one SM's
    issue rate.  No
    PyTorch call computes the chain: library_ms is null."""
    from ac3acm_tpu_torch.ops import _cuda
    from ac3acm_tpu_torch.ops import fixed_chain as FC
    from ac3acm_tpu_torch.ops import imdct_exact as IE
    lib = _cuda.load("imdct_exact", IE._bind)
    smem, threads, ctas = b1qs_shape(lib)

    def bare(nbytes, cluster):
        rc = lib.imdct_exact_bare_launch(
            nbytes, threads, cluster, torch.cuda.current_stream().cuda_stream)
        assert rc == 0, rc

    bare_ms = {c: device_ms(lambda: bare(smem if c > 1 else 0, c))
               for c in (1, ctas)}
    log(f"time a bare launch (a kernel that does nothing, {threads} threads "
        f"a CTA): {bare_ms[1]:.4f} ms one CTA with no shared memory, "
        f"{bare_ms[ctas]:.4f} ms a cluster of {ctas} CTAs of {smem} B "
        f"(B1QS's shape; device time)")
    init = (np.zeros((6, 128), np.int32), np.array(True))
    out = {}
    for flags in (FLAGS_51_TO_20, 7 | 16 | 32):
        fmt, blocks = fixed_frames(GOLDEN, flags, 1)[0]
        carry, tb = on_card(init, blocks, dev)
        ms = device_ms(lambda: FC.fixed_chain(fmt, carry, tb))
        empty = {k: v[:0] for k, v in tb.items()}
        launch_ms = device_ms(lambda: FC.fixed_chain(fmt, carry, empty))
        reps = 200
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            FC.fixed_chain(fmt, carry, tb)
        host_ms = (time.perf_counter() - t0) / reps * 1e3
        torch.cuda.synchronize()
        plain_ms = cuda_ms(lambda: FC.fixed_chain_ref(fmt, carry, tb),
                           warmup=1, reps=3)
        bound_ms, bound_by, ops, floor_ms = b1qs_bound(fmt, blocks)
        log(f"time fixed_chain (B1QS) [one frame of the 5.1 golden to "
            f"{fmt.output}, 6 blocks]: kernel_ms {ms:.4f} (device time); "
            f"the call with no blocks (prologue and launch) "
            f"{launch_ms:.4f} ms beside a bare launch's {bare_ms[ctas]:.4f} "
            f"(B1QS's shape) / {bare_ms[1]:.4f} (one CTA); wrapper "
            f"{host_ms:.4f} ms a call on the "
            f"host; plain_ms {plain_ms:.3f}; bound_ms {bound_ms:.3e} -> "
            f"{bound_by} ({ops} integer instructions at the card's "
            f"{PEAK_ISSUE:.4e}/s; {bound_ms / ms:.4%} of the kernel's "
            f"time); on one SM {floor_ms:.6f} ms (the "
            f"same instructions at one SM's {PEAK_ISSUE / 132:.4e}/s; "
            f"{floor_ms / ms:.2%}); library_ms null (no PyTorch call "
            f"computes the chain)")
        out[fmt.output] = dict(ms=ms, plain_ms=plain_ms, library_ms=None,
                               bound_ms=bound_ms, bound_by=bound_by,
                               launch_ms=launch_ms, host_ms=host_ms)
    res = dict(out[2])
    res["ms_3f2r_lfe"] = out[7 | 16]["ms"]
    return res


@contextlib.contextmanager
def record_b1qs():
    """The inputs and outputs of every fixed_chain call the fixed path
    makes (each still launches B1QS once), cloned on the card."""
    from ac3acm_tpu_torch.ops import fixed_chain as FC
    orig = FC.fixed_chain
    calls = []

    def call(fmt, carry, blocks):
        out = orig(fmt, carry, blocks)
        (d, m), p = out
        calls.append((fmt, tuple(x.clone() for x in carry),
                      {k: v.clone() for k, v in blocks.items()},
                      ((d.clone(), m.clone()), p.clone())))
        return out

    FC.fixed_chain = call
    try:
        yield calls
    finally:
        FC.fixed_chain = orig


def check_b1qs_calls(calls):
    """Every recorded B1QS call's outputs (from the run itself) against the
    plain version of its inputs, bitwise, one lane-batched plain pass a
    (format, block count) -> max |diff|."""
    worst = 0.0
    for (fmt, _), group in b1qs_group(calls).items():
        worst = max(worst, b1qs_plain(fmt, group))
    return worst


def fixed_run(es, flags, drc=True):
    """SampleDecoder("fixed") on the card over es, its counts set to 0
    just before; -> (pcm, the native fixed backend's pcm, seconds, kernel
    counts, B1QS calls)."""
    from ac3acm_tpu_torch.host.native import SampleDecoder
    dev, nat = SampleDecoder("fixed"), SampleDecoder("fixed",
                                                     backend="native")
    if not drc:
        dev.set_drc_enabled(False)
        nat.set_drc_enabled(False)
    torch.cuda.synchronize()
    with record_b1qs() as calls:
        zero_kernel_counts()
        t0 = time.perf_counter()
        pcm = dev.decode_stream(es, flags)                  # numpy: synced
        dt = time.perf_counter() - t0
        counts = kernel_counts()
    return pcm, nat.decode_stream(es, flags), dt, counts, calls


def fixed_ops_per_frame(nframes=32):
    """ATen operations a frame of SampleDecoder("fixed") on the card (5.1
    -> 2.0), counted by a TorchDispatchMode over nframes frames, and its
    B1QS launches a frame."""
    from ac3acm_tpu_torch.host.native import SampleDecoder
    from ac3acm_tpu_torch.ops import fixed_chain as FC
    es = cycle(golden_frames(GOLDEN), nframes)
    dec = SampleDecoder("fixed")
    dec.decode_stream(cycle(golden_frames(GOLDEN), 2), FLAGS_51_TO_20)
    clock = OpClock()
    before = FC.launches_fixed_chain
    with clock.mode:
        dec.decode_stream(es, FLAGS_51_TO_20)
    return (clock.n / nframes,
            (FC.launches_fixed_chain - before) / nframes)


def phase_fixed():
    """The fixed-point path (SampleDecoder("fixed"), device backend) on the
    card: 512 frames of the 5.1 golden to stereo and to 3F2R|LFE, the 5.1
    -> 2.0 switch with DRC off; each int32 bitwise the native fixed
    backend's; B1QS once a frame, B1Q, B1, B1F and K1 never; every B1QS
    call held to its plain version; the eager operations a frame.
    -> (B1QS launches, max |diff|, x-realtime by run, ops a frame)."""
    b51, st = golden_frames(GOLDEN), golden_frames(STEREO_GOLDEN)
    runs = (("5.1 -> 2.0", cycle(b51, FIXED_FRAMES), 2 | 32, True),
            ("5.1 -> 3F2R|LFE", cycle(b51, FIXED_FRAMES), 7 | 16 | 32, True),
            ("5.1 then 2.0 mid-stream, DRC off",
             cycle(b51, FIXED_SWITCH_FRAMES) + cycle(st, FIXED_SWITCH_FRAMES),
             2 | 32, False))
    launches, worst, xrt = 0, 0.0, {}
    for tag, es, flags, drc in runs:
        pcm, want, dt, counts, calls = fixed_run(es, flags, drc)
        nfr = pcm.shape[0] // 6
        same = pcm.dtype == np.int32 and pcm.shape == want.shape \
            and np.array_equal(pcm, want)
        xrt[tag] = nfr * 1536 / 48000.0 / dt
        log(f"fixed path {tag}: SampleDecoder('fixed') on the card, {nfr} "
            f"frames {dt:.3f} s -> {xrt[tag]:.2f}x realtime; int32 "
            f"{tuple(pcm.shape)} == the native fixed backend {same}; "
            f"launches B1QS {counts['B1QS']} ({len(calls)} calls recorded), "
            f"B1Q {counts['B1Q']}, B1 {counts['B1']}, B1F {counts['B1F']}, "
            f"K1 {counts['K1']}")
        assert same, tag
        assert counts["B1QS"] == nfr == len(calls), counts
        assert counts["B1Q"] == counts["B1"] == counts["B1F"] \
            == counts["K1"] == 0, counts
        launches += counts["B1QS"]
        err = check_b1qs_calls(calls)
        worst = max(worst, err)
        log(f"fixed path {tag}: every B1QS call's pcm, delay and downmixed "
            f"({len(calls)} calls) == the plain version of its inputs, max "
            f"|diff| {err}")
    ops, per_frame = fixed_ops_per_frame()
    log(f"fixed path: {ops:g} ATen operations and {per_frame:g} B1QS "
        f"launch a frame (5.1 -> 2.0, a TorchDispatchMode over 32 frames)")
    assert per_frame == 1
    return launches, worst, xrt, ops


def phase_fixed_variant(dev):
    """B1Q's path now: the fixed variant's public entry points
    (get_variant("fixed"): imdct512, imdct256, filterbank) on the card,
    counts set to 0 just before; each equal bitwise to the same call on
    the split's plain version.  -> (B1Q launches, max |diff|)."""
    from ac3acm_tpu_torch.ops import imdct_exact as IE
    frames = fixed_frames(GOLDEN, FLAGS_51_TO_20, 1)
    freq = torch.from_numpy(frames[0][1]["freq"][0, :5]).to(dev)
    rng = np.random.default_rng(21)
    delay = torch.from_numpy(rng.integers(-2 ** 31, 2 ** 31, (5, 128),
                                          dtype=np.int64).astype(np.int32)
                             ).to(dev)
    blksw = torch.tensor([False, True, False, True, True], device=dev)
    bias = torch.zeros((), dtype=torch.int32, device=dev)
    v = IE.get_variant("fixed")
    cases = (("imdct512", (freq, delay, bias), False),
             ("imdct256", (freq, delay, bias), True),
             ("filterbank", (freq, delay, blksw, bias), blksw))
    zero_kernel_counts()
    outs = [v[name](*args) for name, args, _ in cases]
    counts = kernel_counts()
    worst = 0.0
    for (name, args, blk), (o, d) in zip(cases, outs):
        ro, rd = IE._filterbank(IE.split_fb_fixed_ref, IE._ola_fixed,
                                freq, delay, blk, bias[..., None])
        err = max(int((o.long() - ro.long()).abs().max()),
                  int((d.long() - rd.long()).abs().max()))
        assert torch.equal(o, ro) and torch.equal(d, rd), (name, err)
        worst = max(worst, float(err))
    log(f"fixed variant (B1Q's path): get_variant('fixed') imdct512, "
        f"imdct256 and filterbank on the card equal to the plain split's "
        f"bitwise, max |diff| {worst}; launches B1Q {counts['B1Q']}, B1QS "
        f"{counts['B1QS']}")
    assert counts["B1Q"] == len(cases) and counts["B1QS"] == 0, counts
    return counts["B1Q"], worst


def meter_xrt(stderr):
    """The x-realtime of the CLI's closing meter line ("N frames in Xs
    (F fps, Rx realtime)"), from its frames a second at 48 kHz: decode or
    encode alone, start-up excluded."""
    m = re.findall(r"frames in [\d.]+s \(([\d.]+) fps", stderr)
    assert m, stderr[-2000:]
    return float(m[-1]) * 1536 / 48000.0


def phase_cli():
    """python -m ac3acm_tpu_torch.cli as subprocesses on a 128-frame file
    of the 5.1 golden: decode to wav on the card (float, reference mode,
    and fixed) byte-equal to --backend native (run in this process, to
    save a start-up each); encode of that wav equal to the port's Encoder
    on the same PCM; info --check-crc exits 0.  -> {run: x-realtime}."""
    import tempfile
    from ac3acm_tpu_torch.cli import _read_wav
    from ac3acm_tpu_torch.cli import main as cli_main
    from ac3acm_tpu_torch.models.encoder import Encoder
    env = dict(os.environ, PYTHONPATH=HERE)
    xrt = {}

    def cli(*args):
        r = subprocess.run([sys.executable, "-m", "ac3acm_tpu_torch.cli",
                            *args], cwd=HERE, env=env, capture_output=True,
                           text=True, timeout=300)
        assert r.returncode == 0, (args, r.stderr[-3000:])
        return r

    with tempfile.TemporaryDirectory() as tmp:
        src = os.path.join(tmp, "in.ac3")
        with open(src, "wb") as f:
            f.write(cycle(golden_frames(GOLDEN), CLI_FRAMES))
        wavs = {}
        for st in ("float", "fixed"):
            for backend in ("device", "native"):
                out = os.path.join(tmp, f"{st}_{backend}.wav")
                args = ("decode", src, "-o", out, "--output", "wav",
                        "--sample-type", st, "--backend", backend)
                if backend == "device":
                    xrt[st] = meter_xrt(cli(*args).stderr)
                else:
                    assert cli_main([*args, "-q"]) == 0
                wavs[st, backend] = open(out, "rb").read()
            same = wavs[st, "device"] == wavs[st, "native"]
            log(f"cli decode --sample-type {st}: {CLI_FRAMES} frames, wav "
                f"{len(wavs[st, 'device'])} B, --backend device == native "
                f"bytes {same}; device {xrt[st]:.3f}x realtime (the "
                f"meter: decode alone)")
            assert same, st
        enc = os.path.join(tmp, "enc.ac3")
        r = cli("encode", os.path.join(tmp, "float_device.wav"), "-o", enc,
                "-b", "384")
        xrt["encode"] = meter_xrt(r.stderr)
        pcm, rate = _read_wav(os.path.join(tmp, "float_device.wav"))
        want = Encoder(rate, 384000, pcm.shape[1]).encode(pcm)
        got = open(enc, "rb").read()
        log(f"cli encode: {len(got)} B == Encoder's bytes on the same PCM "
            f"{got == want}; {xrt['encode']:.3f}x realtime (the meter)")
        assert got == want and got[:2] == b"\x0b\x77"
        r = cli("info", enc, "--check-crc")
        log(f"cli info --check-crc: {r.stdout.strip()}")
        assert "CRC ok" in r.stdout
    return xrt


def phase_driver():
    """CodecDriver streams on the card: decode and encode equal to
    Ac3ToPcmStream and PcmToAc3Stream on the same bytes."""
    from ac3acm_tpu_torch.io.driver import CodecDriver
    from ac3acm_tpu_torch.io.stream import (Ac3Format, Ac3ToPcmStream,
                                            PcmFormat, PcmToAc3Stream)
    es = cycle(golden_frames(GOLDEN), 16)
    with CodecDriver() as drv:
        src = Ac3Format(6, 48000, 448)
        dec = drv.stream_open(src, PcmFormat(2, 48000))
        pcm = dec.convert(es)
        want = Ac3ToPcmStream(2).convert(es)
        fmt = Ac3Format(2, 48000, 192)
        out = drv.stream_open(PcmFormat(2, 48000), fmt).convert(pcm)
        want_out = PcmToAc3Stream(fmt).convert(pcm)
    same = np.array_equal(pcm, want) and out == want_out
    log(f"driver: CodecDriver().stream_open decode {tuple(pcm.shape)} int16 "
        f"== Ac3ToPcmStream and encode {len(out)} B == PcmToAc3Stream "
        f"{same}")
    assert same and pcm.shape == (16 * 1536, 2) and out[:2] == b"\x0b\x77"


def busy_share(events):
    """A Chrome trace's device busy share: the union of its kernels'
    intervals over the traced window (from the trace's first event to its
    last end).  -> (share, busy us, window us, kernels)."""
    spans = [(e["ts"], e["ts"] + e.get("dur", 0)) for e in events
             if "ts" in e and e.get("ph") == "X"]
    kern = sorted((e["ts"], e["ts"] + e["dur"]) for e in events
                  if e.get("cat") == "kernel" and e.get("ph") == "X")
    busy, end = 0.0, -1e30
    for a, b in kern:
        if b > end:
            busy += b - max(a, end)
            end = b
    t0, t1 = min(a for a, _ in spans), max(b for _, b in spans)
    return busy / (t1 - t0), busy, t1 - t0, len(kern)


def phase_profile():
    """profile() around 32 frames of the fixed decode on the card: the
    Chrome trace must exist and name B1QS's kernel once a frame (B1Q's
    never); the device busy share is busy_share's.  -> busy share."""
    import glob
    import tempfile
    from ac3acm_tpu_torch.host.native import SampleDecoder
    from ac3acm_tpu_torch.utils.trace import profile
    es = cycle(golden_frames(GOLDEN), PROFILE_FRAMES)
    dec = SampleDecoder("fixed")
    dec.decode_stream(cycle(golden_frames(GOLDEN), 2), FLAGS_51_TO_20)
    with tempfile.TemporaryDirectory() as tmp:
        torch.cuda.synchronize()
        with profile(tmp):
            dec.decode_stream(es, FLAGS_51_TO_20)
            torch.cuda.synchronize()
        files = glob.glob(os.path.join(tmp, "*.json"))
        assert len(files) == 1, files
        events = json.load(open(files[0]))["traceEvents"]
    names = {e["name"] for e in events if e.get("cat") == "kernel"}
    assert any("fixed_chain_kernel" in n for n in names), sorted(names)[:20]
    share, busy, window, nkern = busy_share(events)
    per = {k: sum(1 for e in events if e.get("cat") == "kernel"
                  and k in e.get("name", ""))
           for k in ("fixed_chain_kernel", "imdct_fixed_kernel")}
    assert per == {"fixed_chain_kernel": PROFILE_FRAMES,
                   "imdct_fixed_kernel": 0}, per
    log(f"profile: {PROFILE_FRAMES} frames of the fixed decode traced; "
        f"{nkern} kernels ({len(names)} names; B1QS "
        f"'fixed_chain_kernel' {per['fixed_chain_kernel']} times, B1Q "
        f"'imdct_fixed_kernel' {per['imdct_fixed_kernel']}), window "
        f"{window / 1e3:.3f} ms, kernels busy {busy / 1e3:.3f} ms -> "
        f"device busy share {share:.2%}, idle {1 - share:.2%}")
    return share


def filterbank_f64(coeffs, delay, blksw, bias):
    """The filterbank in float64 on the card, and the bound on |f32 result
    - this| that holds for any order of the 256-term sums: gamma_256 =
    256 u / (1 - 256 u) (u = 2^-24) times the sum of |terms| of each
    product, then for `out` the epilogue's four f32 roundings (z * win,
    dfold * win_r, their sum, + bias), each within u of its value;
    -> ((out, new_delay), (bound on out, bound on new_delay))."""
    from ac3acm_tpu_torch.ops.filterbank import mats_on
    w_long, w_short, win, win_r = (w.double() for w in
                                   mats_on(coeffs.device))
    blk = blksw[..., None]
    c = coeffs.double()

    def product(x, wl, ws):
        return torch.where(blk, 0.0, x) @ wl + torch.where(blk, x, 0.0) @ ws

    zd = product(c, w_long, w_short)
    mag = product(c.abs(), w_long.abs(), w_short.abs())
    u = 2.0 ** -24
    gamma = 256 * u / (1 - 256 * u)
    dfold = torch.cat([delay, delay.flip(-1)], dim=-1).double()
    zw, dw = zd[..., :256] * win, dfold * win_r
    out = zw + dw + bias.double()[..., None]
    out_bound = (gamma * mag[..., :256] * win.abs()
                 + u * (zw.abs() + dw.abs() + (zw + dw).abs() + out.abs())
                 ) * 1.01
    return ((out, zd[..., 256:]),
            (out_bound, gamma * mag[..., 256:] * 1.01))


def mesh_devices(n):
    """n mesh entries: with one card cuda:0 n times, with more the cards
    in turn (cuda:0, cuda:1, ...)."""
    count = torch.cuda.device_count()
    return [f"cuda:{i % count}" for i in range(n)]


def sync_all():
    for i in range(torch.cuda.device_count()):
        torch.cuda.synchronize(i)


def reset_peaks():
    """Peak statistics of every card set to 0; -> the bytes each holds
    now (peaks_gb's baseline)."""
    for i in range(torch.cuda.device_count()):
        torch.cuda.reset_peak_memory_stats(i)
    return [torch.cuda.memory_allocated(i)
            for i in range(torch.cuda.device_count())]


def peaks_gb(base):
    """Each card's peak allocation since reset_peaks, above its baseline
    (what a run itself allocated: tensors kept from earlier runs are not
    its own)."""
    return [round((torch.cuda.max_memory_allocated(i) - b) / 1e9, 2)
            for i, b in enumerate(base)]


def mesh_decode(streams, parser, mesh):
    """One BatchedDecoder run of the main path's chunks (int16, bias 384)
    on `mesh`, or on one card for None; -> (PCM chunks on one card, kernel
    launches per chunk, seconds from the first parse to the last chunk on
    its card, peak GB per card); a mesh's PCM is gathered onto its first
    card after the clock stops."""
    from ac3acm_tpu_torch.parallel.pipeline import BatchedDecoder
    dec = BatchedDecoder(len(streams), FLAGS_51_TO_20, bias=384.0,
                         mesh=mesh, emit_int16=True, parser=parser)
    for i, s in enumerate(streams):
        dec.feed(i, s)
    sync_all()
    base = reset_peaks()
    chunks, per_chunk = [], []
    t0 = time.perf_counter()
    for _ in range(NCHUNKS):
        before = kernel_counts()
        r = dec.decode_available(max_frames=CHUNK_FRAMES)
        assert r is not None, "mesh path ran dry"
        pcm, valid = r
        per_chunk.append({k: v - before[k]
                          for k, v in kernel_counts().items()})
        assert valid.all() and tuple(pcm.shape) == (
            len(streams), CHUNK_FRAMES * 6, 2, 256), tuple(pcm.shape)
        chunks.append(pcm)
    sync_all()
    dt = time.perf_counter() - t0
    peaks = peaks_gb(base)
    if mesh is not None:
        chunks = [c.gather(mesh.row_devices[0]) for c in chunks]
    return chunks, per_chunk, dt, peaks


def mesh_transcode(chunks, mesh):
    """Transcoder(mesh=...) (None: one card) over the transcode phase's
    chunks, reference mode, native parser; -> (each lane's bytes, kernel
    launches per chunk, seconds, peak GB per card)."""
    from ac3acm_tpu_torch.parallel.transcode import Transcoder
    tc = Transcoder(len(chunks[0]), 192000, 2, mesh=mesh)
    outs, per_chunk = [b""] * len(chunks[0]), []
    sync_all()
    base = reset_peaks()
    t0 = time.perf_counter()
    for data in chunks:
        before = kernel_counts()
        outs = [a + b for a, b in zip(outs, tc.step_frames(
            data, TC_CHUNK_FRAMES))]
        per_chunk.append({k: v - before[k]
                          for k, v in kernel_counts().items()})
        assert tc.ok.all()
    sync_all()
    return outs, per_chunk, time.perf_counter() - t0, peaks_gb(base)


def mesh_runs(run, mesh, tag):
    """run(None), then run(mesh) for its time and memory, then run(mesh)
    again with every count set to 0 just before it and every B1F, K1 and
    gather call recorded; -> (the one-card run, the recorded mesh run, the
    timed mesh run, the counts of the recorded run, its steady calls, its
    gather calls)."""
    one = run(None)
    torch.cuda.empty_cache()
    timed = run(mesh)
    torch.cuda.empty_cache()
    rec = []
    zero_kernel_counts()
    with record_steady() as steady:
        gathers = record_gathers(lambda: rec.append(run(mesh)))
    counts = kernel_counts()
    log(f"mesh {tag}: one card {one[2]:.3f} s, mesh {timed[2]:.3f} s "
        f"(recorded run {rec[0][2]:.3f} s); launches per chunk "
        f"{[{k: c[k] for k in c if c[k]} for c in rec[0][1]]}; peak GB "
        f"per card one card {one[3]}, mesh {timed[3]}")
    return one, rec[0], timed, counts, steady, gathers


def phase_mesh():
    """The lane split over a mesh's 'data' axis; -> (launches of each
    kernel in the recorded sharded runs, worst |kernel - plain| by
    kernel)."""
    from ac3acm_tpu_torch.ops.filterbank import filterbank
    from ac3acm_tpu_torch.parallel.mesh import make_mesh
    from ac3acm_tpu_torch.parallel.pipeline import tp_filterbank
    count = torch.cuda.device_count()
    data = MESH_DATA_ONE_CARD if count == 1 else count
    mesh = make_mesh(data=data, devices=mesh_devices(data))
    if count == 1:
        log(f"mesh: one card, so the mesh names cuda:0 {data} times (the "
            f"card repeated): every line of the split runs, the {data} "
            f"shards one after another on it; {mesh}")
    else:
        log(f"mesh: {count} distinct cards, one data row each; {mesh}")
    streams = lane_streams(MAIN_BATCH, CHUNK_FRAMES * NCHUNKS)
    audio_s = MAIN_BATCH * CHUNK_FRAMES * NCHUNKS * 1536 / 48000.0
    launches, worst, errs, wires = {}, {}, {}, {}
    for mode, parser, want in (
            ("reference", "native", ("B1F",)),
            ("fast", "native", ("K1",)),
            ("fast", "raw", ("extract_fields", "extract_i16_table"))):
        tag = f"{parser} {mode}"
        with accuracy(mode):
            one, rec, timed, counts, steady, gathers = mesh_runs(
                lambda m: mesh_decode(streams, parser, m), mesh, tag)
        never = ("B1", "K1") if mode == "reference" else ("B1", "B1F")
        for c in rec[1]:
            assert all(c[k] >= data for k in want), (tag, rec[1])
            assert all(c[k] == 0 for k in never), (tag, rec[1])
        for k, v in counts.items():
            launches[k] = launches.get(k, 0) + v
        err = max(max(max_lsb(a, b) for a, b in zip(run[0], one[0]))
                  for run in (rec, timed))
        if mode == "reference":
            assert all(torch.equal(a, b) for run in (rec, timed)
                       for a, b in zip(run[0], one[0])), tag
        assert err <= 1, (tag, err)
        check_gather_calls(gathers, f"mesh {tag}", errs, wires)
        for k, v in check_steady_calls(steady, f"mesh {tag}").items():
            worst[k] = max(worst.get(k, 0.0), v)
        log(f"mesh {tag}: {MAIN_BATCH} lanes x {NCHUNKS} chunks x "
            f"{CHUNK_FRAMES} frames over data={data}: PCM vs one card max "
            f"{err} LSB ({'bitwise' if mode == 'reference' else '<= 1'}); "
            f"{audio_s / timed[2]:.0f}x realtime sharded, "
            f"{audio_s / one[2]:.0f}x on one card; launches {counts}")
        del one, rec, timed, steady, gathers
        torch.cuda.empty_cache()
    chunks = tc_chunks(TC_BATCH)
    tc_audio = TC_BATCH * TC_NCHUNKS * TC_CHUNK_FRAMES * 1536 / 48000.0
    one, rec, timed, counts, steady, _ = mesh_runs(
        lambda m: mesh_transcode(chunks, m), mesh, "transcode")
    for c in rec[1]:
        assert c["B1F"] >= data and c["K1"] == 0 and c["B1"] == 0, rec[1]
        assert c["E1"] >= data and c["P1"] >= data, rec[1]
        # one M1, X1 and Q1 launch a core call, as E1's
        assert c["M1"] == c["X1"] == c["Q1"] == c["E1"], rec[1]
    for k, v in counts.items():
        launches[k] = launches.get(k, 0) + v
    same = rec[0] == one[0] and timed[0] == one[0]
    log(f"mesh transcode (config 5): {TC_BATCH} lanes x {TC_NCHUNKS} chunks "
        f"x {TC_CHUNK_FRAMES} frames over data={data}: bytes == one card "
        f"{same}; {tc_audio / timed[2]:.0f}x realtime sharded, "
        f"{tc_audio / one[2]:.0f}x on one card")
    assert same
    for k, v in check_steady_calls(steady, "mesh transcode").items():
        worst[k] = max(worst.get(k, 0.0), v)
    del one, rec, timed, steady
    torch.cuda.empty_cache()
    # tp_filterbank: the contraction split over 'model'
    rng = np.random.default_rng(5)
    B, C, K = MESH_TP_SHAPE
    d, m = MESH_TP_GRID
    tmesh = make_mesh(d, m, devices=mesh_devices(d * m))
    dev = tmesh.row_devices[0]
    coeffs = torch.from_numpy((rng.standard_normal((B, C, K)) * 1e-3)
                              .astype(np.float32)).to(dev)
    delay = torch.from_numpy((rng.standard_normal((B, C, 128)) * 1e-3)
                             .astype(np.float32)).to(dev)
    blksw = torch.from_numpy(rng.random((B, C)) < 0.3).to(dev)
    bias = torch.full((B, C), 384.0, device=dev)
    args = (coeffs, delay, blksw, bias)
    ref = filterbank(*args)
    got = [g.gather(dev) for g in tp_filterbank(tmesh, *args)]
    exact, bound = filterbank_f64(*args)
    for name, outs in (("tp_filterbank", got), ("filterbank", ref)):
        for o, x, b in zip(outs, exact, bound):
            over = float(((o.double() - x).abs() - b).max())
            assert over <= 0.0, (name, over)
    tp_err = [float((g - r).abs().max()) for g, r in zip(got, ref)]

    def host_ms(fn, reps=5):
        fn()
        sync_all()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        sync_all()
        return (time.perf_counter() - t0) / reps * 1e3

    log(f"mesh tp_filterbank {d}x{m} at {list(MESH_TP_SHAPE)} (30% short "
        f"rows): out and delay within the f32 rounding bound of the float64 "
        f"product, as the one-card filterbank's are; max |diff| between the "
        f"two {tp_err[0]:.3g} / {tp_err[1]:.3g}; "
        f"{host_ms(lambda: tp_filterbank(tmesh, *args)):.3f} ms a call "
        f"(host clock, all cards synchronized), one-card filterbank "
        f"{host_ms(lambda: filterbank(*args)):.3f} ms")
    del got, ref, args, coeffs, delay, blksw, bias
    for k, v in errs.items():
        worst[k] = max(worst.get(k, 0.0), v)
    log(f"mesh launches over the recorded sharded runs: "
        f"{ {k: v for k, v in launches.items() if v} }")
    return launches, worst


def main():
    phase_card()
    dev = torch.device("cuda")
    phase_build()
    bench_inputs, err = phase_check_bench(dev)
    phase_check_formats(dev)
    phase_check_ragged(dev)
    phase_check_gather_edges(dev)
    phase_check_field_edges(dev)
    b1_freq, b1_err = phase_check_b1(dev, bench_inputs)
    b1f_err, b1f_inputs = phase_check_b1f(dev, bench_inputs, b1_freq)
    times = phase_times(bench_inputs)
    b1_times = phase_times_b1(b1_freq)
    b1f_times = phase_times_b1f(b1f_inputs, b1_times)
    del bench_inputs, b1_freq, b1f_inputs
    torch.cuda.empty_cache()
    b1q_rows, b1q_err = phase_check_b1q(dev)
    b1q_times = phase_times_b1q(b1q_rows)
    del b1q_rows
    torch.cuda.empty_cache()
    b1qs_err = phase_check_b1qs(dev)
    b1qs_times = phase_times_b1qs(dev)
    e1_err = phase_check_e1(dev)
    p1_err = phase_check_p1(dev)
    x1_err = phase_check_x1(dev)
    q1_err = phase_check_q1(dev)
    m1_err = phase_check_m1(dev)
    with accuracy("fast"):
        launches, native_plain, fast_rt = phase_main_path()
        torch.cuda.empty_cache()
        gathers = phase_raw_gathers()
        torch.cuda.empty_cache()
        raw_launches, raw_pcm = phase_raw_main(native_plain)
        torch.cuda.empty_cache()
        raw_k1_launches, raw_k1_err = phase_raw_k1(raw_pcm)
        launches += raw_k1_launches
        del raw_pcm
        torch.cuda.empty_cache()
        raw_launches["extract_fields_shared"] = phase_raw_coupling()
    torch.cuda.empty_cache()
    b1f_launches, ref_native = phase_ref_main(native_plain, fast_rt)
    del native_plain
    torch.cuda.empty_cache()
    phase_ref_raw(ref_native)
    del ref_native
    torch.cuda.empty_cache()
    b1_launches = phase_general()
    torch.cuda.empty_cache()
    phase_mixed()
    torch.cuda.empty_cache()
    single_b1, single_err = phase_single()
    b1_launches += single_b1 + phase_stream_layer()
    py_errs = phase_python()
    py_errs.update({k: max(v, py_errs.get(k, 0.0))
                    for k, v in phase_raw_py().items()})
    phase_enc_extremes()
    phase_enc_digests()
    (_, core_launches, e1_main_err, e1_times_by, p1_launches,
     p1_times_by, x1_times_by, q1_times_by, m1_times_by) = phase_enc_main()
    p1_loud = phase_p1_loud()
    _, core_single = phase_enc_single()
    torch.cuda.empty_cache()
    tc_launches, tc_errs, _ = phase_transcode()
    b1f_launches += tc_launches["B1F"]
    for k in ("M1", "E1", "X1", "Q1"):
        log(f"{k} launches: configs 3 and 4 (end to end, both packers) "
            f"{core_launches[k]}, single-stream Encoder {core_single[k]}, "
            f"transcode {tc_launches[k]}")
        core_launches[k] += core_single[k] + tc_launches[k]
    e1_err = max(e1_err, e1_main_err, tc_errs.pop("E1"))
    x1_err = max(x1_err, tc_errs.pop("X1"))
    q1_err = max(q1_err, tc_errs.pop("Q1"))
    m1_err = max(m1_err, tc_errs.pop("M1"))
    log(f"P1 launches: configs 3 and 4 (end to end, pack='device') "
        f"{p1_launches}, transcode {tc_launches['P1']}")
    p1_launches += tc_launches["P1"]
    p1_err = max(p1_err, tc_errs.pop("P1"))
    for entry, _, _ in GATHER_KERNELS:
        raw_launches[entry] += tc_launches[entry]
    py_errs.update({k: max(v, py_errs.get(k, 0.0))
                    for k, v in tc_errs.items()})
    torch.cuda.empty_cache()
    mesh_launches, mesh_errs = phase_mesh()
    launches += mesh_launches["K1"]
    for k in ("M1", "E1", "X1", "Q1"):
        core_launches[k] += mesh_launches[k]
    p1_launches += mesh_launches["P1"]
    b1f_launches += mesh_launches["B1F"]
    b1_launches += mesh_launches["B1"]
    for entry, _, _ in GATHER_KERNELS:
        raw_launches[entry] += mesh_launches[entry]
    py_errs.update({k: max(v, py_errs.get(k, 0.0))
                    for k, v in mesh_errs.items()})
    torch.cuda.empty_cache()
    b1qs_launches, b1qs_path_err, fixed_xrt, fixed_ops = phase_fixed()
    b1q_launches, b1q_path_err = phase_fixed_variant(dev)
    cli_xrt = phase_cli()
    phase_driver()
    busy = phase_profile()
    log(f"x-realtime: fixed path (SampleDecoder on the card) "
        f"{fixed_xrt['5.1 -> 2.0']:.2f}x; cli decode (the meter) float "
        f"{cli_xrt['float']:.3f}x, fixed {cli_xrt['fixed']:.3f}x; "
        f"device busy share of the traced fixed decode {busy:.2%}; "
        f"{fixed_ops:g} ATen operations and one B1QS launch a fixed frame")
    kernels = [dict(
        name="fused_steady", route="cuda",
        source="ac3acm_tpu_torch/csrc/fused_steady.cu",
        replaces="ac3acm_tpu/ops/pallas_steady.py:210",
        launches=launches, max_abs_err=max(err, py_errs["K1"], raw_k1_err),
        **times)]
    for entry, kname, line in GATHER_KERNELS:
        kernels.append(dict(
            name=kname, route="cuda",
            source="ac3acm_tpu_torch/csrc/bitgather.cu",
            replaces=f"ac3acm_tpu/ops/bitgather.py:{line}",
            launches=raw_launches[entry], **dict(
                gathers[entry], max_abs_err=max(gathers[entry]["max_abs_err"],
                                                py_errs.get(entry, 0)))))
    kernels.append(dict(
        name="imdct_exact (B1)", route="cuda",
        source="ac3acm_tpu_torch/csrc/imdct_exact.cu",
        replaces="ac3acm_tpu/ops/imdct_exact.py:437,466 (XLA; no pallas_call)",
        launches=b1_launches,
        max_abs_err=max(b1_err, single_err, py_errs["B1"]),
        **b1_times))
    kernels.append(dict(
        name="fused_steady_exact (B1F)", route="cuda",
        source="ac3acm_tpu_torch/csrc/imdct_exact.cu",
        replaces="ac3acm_tpu/ops/imdct_exact.py:437,466 + the steady OLA "
                 "and int16 (XLA; no pallas_call)",
        launches=b1f_launches, max_abs_err=max(b1f_err, py_errs["B1F"]),
        **b1f_times))
    kernels.append(dict(
        name="imdct_fixed (B1Q)", route="cuda",
        source="ac3acm_tpu_torch/csrc/imdct_exact.cu",
        replaces="ac3acm_tpu/ops/imdct_exact.py:256,294 _build(\"fixed\") "
                 "(XLA; no pallas_call)",
        launches=b1q_launches, max_abs_err=max(b1q_err, b1q_path_err),
        **b1q_times))
    kernels.append(dict(
        name="fixed_chain (B1QS)", route="cuda",
        source="ac3acm_tpu_torch/csrc/imdct_exact.cu",
        replaces="ac3acm_tpu/models/decoder.py:526 (the fixed lax.scan) + "
                 "ac3acm_tpu/ops/imdct_exact.py:256,294 (XLA; no "
                 "pallas_call)",
        launches=b1qs_launches, max_abs_err=max(b1qs_err, b1qs_path_err),
        **b1qs_times))
    e1 = dict(e1_times_by["config 3"])
    e1.update({f"{k}_51": v for k, v in e1_times_by["config 4"].items()
               if k in ("ms", "plain_ms", "bound_ms")})
    e1.pop("design_floor_ms")
    kernels.append(dict(
        name="snr_search (E1)", route="cuda",
        source="ac3acm_tpu_torch/csrc/snr_search.cu",
        replaces="ac3acm_tpu/models/encoder.py:386-451 with "
                 "ac3acm_tpu/ops/alloc.py:81,120,202,213,285 (XLA; no "
                 "pallas_call)",
        launches=core_launches["E1"], max_abs_err=e1_err, **e1))
    p1 = dict(p1_times_by["config 3"])
    p1.update({f"{k}_51": v for k, v in p1_times_by["config 4"].items()
               if k in ("ms", "ms_int32", "plain_ms", "bound_ms")})
    p1.pop("rows")
    p1.update(ms_loud=p1_loud["ms"], ms_int32_loud=p1_loud["ms_int32"],
              bound_ms_loud=p1_loud["bound_ms"],
              coded_share_loud=p1_loud["coded_share"])
    kernels.append(dict(
        name="pack (P1)", route="cuda",
        source="ac3acm_tpu_torch/csrc/pack.cu",
        replaces="ac3acm_tpu/ops/pack_device.py:361 (XLA; no pallas_call)",
        launches=p1_launches, max_abs_err=p1_err, **p1))
    for name, src, replaces, key, err, by in (
            ("exponents (X1)", "exponents.cu",
             "ac3acm_tpu/ops/mdct.py:181 + ac3acm_tpu/models/encoder.py:"
             "116,316-384 (XLA; no pallas_call)", "X1", x1_err, x1_times_by),
            ("quantize (Q1)", "quantize.cu",
             "ac3acm_tpu/models/encoder.py:148-180 (XLA; no pallas_call)",
             "Q1", q1_err, q1_times_by),
            ("window_mdct (M1)", "window_mdct.cu",
             "ac3acm_tpu/ops/mdct.py:64,129,162 (XLA; no pallas_call)",
             "M1", m1_err, m1_times_by)):
        t = dict(by["config 3"])
        t.update({f"{k}_51": v for k, v in by["config 4"].items()
                  if k in ("ms", "ms_int32", "plain_ms", "bound_ms")})
        t.pop("rows")
        t.pop("model_ms", None)
        kernels.append(dict(
            name=name, route="cuda", source=f"ac3acm_tpu_torch/csrc/{src}",
            replaces=replaces, launches=core_launches[key], max_abs_err=err,
            **t))
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    sys.path.insert(0, HERE)
    main()
