"""The yardstick: the card's published peaks and each kernel's least work,
counted from the cell's own data (the reference's frames, classes and
strategies), whatever implements the kernel.

Copied from ``chip_smoke.py`` (``gather_bound``'s slot bytes,
``stage_least_bytes``, ``e1_least_bytes``, ``q1_least_bytes``,
``pack_least_bytes``, ``m1_bound``'s and ``x1_bound``'s operation counts and
B1F's byte count in ``phase_times_b1f``), never imported from it, so that
no later change to the program's scripts moves them.  A kernel's least
time is the larger of its least bytes at the memory rate and its least
operations at the issue rate; its roofline share is that time over the
time the profiler gives it.
"""
from __future__ import annotations

import numpy as np

# published H100 SXM peaks (NVIDIA data sheet, 700 W): HBM bytes/s and
# FP32 FLOP/s outside the tensor cores; instructions a second the card can
# issue, the FP32 peak counted one instruction per FMA
PEAK_BYTES, PEAK_FP32 = 3.35e12, 67e12
PEAK_ISSUE = PEAK_FP32 / 2

# FP32 operations of one long row of the order-exact IMDCT: the
# pre-twiddle 128 x 6, the leaves 11 ifft8 x 56 + 10 ifft4 x 16, the passes
# (a zero butterfly 12, another 24) 5 x 84 + 3 x 180 + 372 + 756, the
# post-twiddle 64 x 12; and 9 a sample for the OLA and the int16
B1_LONG_ROW_FLOP = 768 + 776 + 420 + 540 + 372 + 756 + 768
B1F_SAMPLE_FLOP = 9

# integer work a transform / a bin of the encoder's kernels' functions
M1_TRANSFORM_OPS = (512 * 3 + 512 * 4 + 128 * 2 * 2 + 128 * 13
                    + 448 * 12 + 289 * 6 + 32 + 128 * 6)
X1_BIN_OPS, Q1_BIN_OPS = 12, 16
P1_BIN_OPS, P1_CRC_OPS = 5, 3

# least bytes a gathered field moves: K2 (a bit offset int16, a width
# int8, the int16 result) and K4 (an ordinal uint16, the int16 state)
K2_SLOT_BYTES, K4_SLOT_BYTES = 2 + 1 + 2, 2 + 2
LFSR_ORBIT = 65535


def least_ms(nbytes: float, ops: float = 0.0, rate: float = PEAK_ISSUE):
    """The least time in ms: bytes at the memory rate or ops at `rate`,
    whichever is longer."""
    return max(nbytes / PEAK_BYTES, ops / rate) * 1e3


def b1f_ms(lanes: int, frames: int, planes: int, out_bytes: int = 2):
    """B1F on a chunk: each coefficient read once (f32), the PCM written
    once, the carry read and written once a chain, the bias once a
    block."""
    rows = lanes * frames * 6 * planes
    chains = lanes * planes
    nbytes = rows * 256 * (4 + out_bytes) + chains * 128 * 4 * 2 \
        + lanes * frames * 6 * 4
    flop = rows * (B1_LONG_ROW_FLOP + B1F_SAMPLE_FLOP * 256)
    return least_ms(nbytes, flop, PEAK_FP32)


def gather_ms(frame_bytes: int, fields: int, dithered: int):
    """The device unpack's gathers on a chunk: K2 reads the frame bytes
    once and moves every exponent group and mantissa word the stream
    codes; K4 reads the LFSR orbit once and moves one state a dithered
    bin."""
    k2 = frame_bytes + fields * K2_SLOT_BYTES
    k4 = (LFSR_ORBIT * 2 + dithered * K4_SLOT_BYTES) if dithered else 0
    return least_ms(k2 + k4)


def m1_ms(rows: int, nch: int):
    """M1 on `rows` lane-frames: the two blocks in as int16, a coefficient
    out as int32 and the shift a byte a (block, channel)."""
    bc = rows * 6 * nch
    return least_ms(bc * (2 * 512 + 1024 + 1), bc * M1_TRANSFORM_OPS)


def x1_ms(rows: int, nch: int):
    """X1: a coefficient in as int32, a coded exponent out a byte."""
    bc = rows * 6 * nch
    return least_ms(bc * (1024 + 256), bc * 256 * X1_BIN_OPS)


def e1_ms(rows: int, nb, calls: int = 1):
    """E1: on the live bins an exponent a byte in and a class a byte out,
    avail in and M, fstar out (int32); nb, is_lfe and hth once a call."""
    live = 6 * sum(max(0, min(int(n), 256)) for n in nb)
    return least_ms(rows * (2 * live + 3 * 4) + calls * (len(nb) * 5
                                                         + 50 * 4))


def q1_ms(bap: np.ndarray):
    """Q1 on classes bap [..., 256]: every bin's class in and 16-bit code
    out; the coefficient (int32) and exponent (a byte) in where the class
    is not 0; a global exponent (int32) a (block, channel) that has one."""
    coded = bap != 0
    nbytes = 3 * bap.size + 5 * int(coded.sum()) \
        + 4 * int(coded.any(axis=-1).sum())
    return least_ms(nbytes, int(coded.sum()) * Q1_BIN_OPS)


def _ngroups(nb: int, gs: int) -> int:
    return (nb + gs * 3 - 4) // (3 * gs)


def p1_ms(nb, frame_size: int, bap: np.ndarray, strat: np.ndarray):
    """P1 on fields bap [R, 6, ch, 256], strat [R, 6, ch] (strategy 0
    reuses, 1..3 D15/D25/D45): a live bin's class in and its 16-bit code
    where the class is not 0; 1 + 3 ng exponent bytes a coded (block,
    channel); the strategies and both offsets (int32); the frame out."""
    nb = [max(0, min(int(n), 256)) for n in nb]
    nch = len(nb)
    bap = bap.reshape(-1, 6, nch, 256)
    strat = strat.reshape(-1, 6, nch)
    rows = bap.shape[0]
    live = np.arange(256)[None, :] < np.asarray(nb)[:, None]     # [ch, 256]
    coded = int(((bap != 0) & live).sum())
    ng = np.array([[0] + [max(_ngroups(n, gs), 0) for gs in (1, 2, 4)]
                   for n in nb])                                 # [ch, 4]
    s = strat.astype(np.int64)
    per = ng[np.arange(nch)[None, None, :], s]
    exps = int(np.where(s > 0, 1 + 3 * per, 0).sum())
    fixed = 6 * sum(nb) + 6 * nch * 4 + 8 + frame_size * 2
    nbytes = rows * fixed + 2 * coded + exps
    ops = rows * (6 * sum(nb) * P1_BIN_OPS + frame_size * 2 * P1_CRC_OPS)
    return least_ms(nbytes, ops)
