"""The encoder's quantizer, Q1: a code per coefficient by its bap class.

``quantize(coef, enc_exp, global_exp, bap)`` (ac3enc.cpp:1149-1190):

    coef       int32 [..., K]           the coefficients (overrange ones
                                        zeroed by the exponent stage)
    enc_exp    int8 or int32 [..., K]   the coded exponents
    global_exp int32 [...]              the block's exp_samples
    bap        int8 [..., K]            the class of each coefficient
    ->         int32 [..., K]           the raw code (before grouping);
               or int16 [..., K]        its low 16 bits (codes=torch.int16)

with e = enc_exp - global_exp (int32): class 0 gives 0; classes 1-5
(levels L = 3, 5, 7, 11, 15) give L/2 + v for c >= 0 and L/2 - v below,
v = (((L * (|c| << e)) >> 24) + 1) >> 1; classes 6-15 (q = 5..12, 14, 16
bits) give v & (2^q - 1), v = min(((c << s or c >> -s) + 1) >> 1,
2^(q-1) - 1), s = e + q - 24.  Every step is int32 as XLA runs the
reference's ints: |c|, L * x and v + 1 wrap; a left shift by a count
outside [0, 31] gives 0 and a right shift by one fills with the sign.

The codes come as int32 (JAX's dtype, the default: what every public
function returns) or, with codes=torch.int16, as their low 16 bits: every
code of the encoder fits 16 bits, and the device-pack path hands that form
to the packer (P1), which reads half the bytes.  A class-15 code from
32,768 up is negative as int16: widen it only as unsigned (code_bits, or
& 0xFFFF), never by a sign-extending cast.

On CUDA tensors it launches the hand-written kernel Q1
(csrc/quantize.cu), once a call.  On CPU tensors it runs
``quantize_ref``, the plain version: the same arithmetic on int64 words
wrapped to int32 where the reference's int32 wraps, one eager pass a step.
There is no other path.  The JAX package computes the same function as
XLA (ac3acm_tpu/models/encoder.py:148-180 quantize), with no pallas_call.

Bound on the card: bytes (a class in and a code out everywhere; a
coefficient and its exponent in only where the class is not 0); the
kernel's header says what its design does.
"""
from __future__ import annotations

import ctypes as C
from functools import lru_cache

import numpy as np
import torch

from . import _cuda

# Q1 launches since the last reset (only where the CUDA kernel is
# launched; the CPU path leaves it alone)
launches_quantize = 0


def _wrap32(x):
    """int64 -> the value of (int32)x, kept in int64."""
    return ((x + 0x80000000) & 0xFFFFFFFF) - 0x80000000


def _shl32(x, s):
    """int32 x << s as XLA defines it for any count: a count outside
    [0, 31] gives 0.  x, s int64; the count is clamped before the shift,
    so no device sees an over-wide one."""
    ok = (s >= 0) & (s < 32)
    return torch.where(ok, _wrap32(x << torch.clamp(s, 0, 31)), 0)


def _sar32(x, s):
    """int32 x >> s (arithmetic) as XLA defines it: a count outside
    [0, 31] fills with the sign."""
    return x >> torch.where((s < 0) | (s > 31), 31, s)


@lru_cache(maxsize=8)
def _quant_tables(device: torch.device):
    """Per bap class: symmetric levels (classes 1-5, else 0), asymmetric
    bits (classes 6-15, else 1), as int64 tensors."""
    levels = np.zeros(16, np.int64)
    levels[1:6] = (3, 5, 7, 11, 15)
    qbits = np.ones(16, np.int64)
    for cls in range(6, 16):
        qbits[cls] = cls - 1 if cls < 14 else (14 if cls == 14 else 16)
    return (torch.tensor(levels, device=device),
            torch.tensor(qbits, device=device))


def quantize_ref(coef, enc_exp, global_exp, bap, codes=torch.int32):
    """Plain version of quantize (any device), codes in either form.

    Each coefficient is quantized by its own class (a per-element table
    lookup of levels or bits, not one pass per class); every int32 step
    of the reference wraps as it does there."""
    levels_t, qbits_t = _quant_tables(coef.device)
    cls = bap.to(torch.int64)
    c = coef.to(torch.int64)
    e = (enc_exp - global_exp[..., None]).to(torch.int64)
    # symmetric: levels 3, 5, 7, 11, 15
    levels = levels_t[cls]
    x = _shl32(_wrap32(c.abs()), e)
    v = (_wrap32(levels * x) >> 24) + 1 >> 1
    half = levels >> 1
    sym = torch.where(c >= 0, half + v, half - v)
    # asymmetric: qbits-bit two's complement, saturated at the top
    qbits = qbits_t[cls]
    lshift = e + qbits - 24
    v = torch.where(lshift >= 0, _shl32(c, torch.clamp(lshift, min=0)),
                    _sar32(c, torch.clamp(-lshift, min=0)))
    v = _wrap32(v + 1) >> 1
    one = torch.ones_like(qbits)
    m = one << (qbits - 1)
    v = torch.where(v >= m, m - 1, v)
    asym = v & ((one << qbits) - 1)
    out = torch.where(cls >= 6, asym, torch.where(cls >= 1, sym, 0))
    if codes == torch.int16:
        # the low 16 bits, as the int16 of that pattern
        return (((out + 0x8000) & 0xFFFF) - 0x8000).to(torch.int16)
    return out.to(torch.int32)


def code_bits(q):
    """Codes of either width -> their low 16 bits as int32 in [0, 65535]:
    what the packers read of a code (every token is at most 16 bits).  An
    int16 code widens as unsigned here; .to(), .long() or astype would
    sign-extend the class-15 codes from 32,768 up."""
    return q.to(torch.int32) & 0xFFFF


def _bind(lib):
    p, i = C.c_void_p, C.c_int
    lib.quantize_launch.restype = i
    lib.quantize_launch.argtypes = [p, p, i, p, p, p, i, C.c_longlong, i, p]
    lib.quantize_error_string.restype = C.c_char_p
    lib.quantize_error_string.argtypes = [i]


# bins a thread takes at once (csrc/quantize.cu:CHUNK): the row length a
# multiple of it, each tensor 16-byte aligned
CHUNK = 16
CODES = (torch.int32, torch.int16)


def _check(coef, enc_exp, global_exp, bap, codes):
    """The kernel's contract, on both devices."""
    dev = coef.device
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"quantize runs on cuda or cpu, not {dev}")
    if codes not in CODES:
        raise TypeError(f"codes={codes}: expected one of {CODES}")
    named = (("coef", coef, (torch.int32,)),
             ("enc_exp", enc_exp, (torch.int8, torch.int32)),
             ("global_exp", global_exp, (torch.int32,)),
             ("bap", bap, (torch.int8,)))
    for name, t, dtypes in named:
        if t.dtype not in dtypes:
            raise TypeError(f"{name} is {t.dtype}, expected one of "
                            f"{dtypes}")
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, coef on {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if coef.dim() < 1 or coef.shape[-1] % CHUNK:
        raise ValueError(f"coef has shape {tuple(coef.shape)}: its last "
                         f"axis must be a multiple of {CHUNK}")
    for name, t, shape in (("enc_exp", enc_exp, coef.shape),
                           ("bap", bap, coef.shape),
                           ("global_exp", global_exp, coef.shape[:-1])):
        if tuple(t.shape) != tuple(shape):
            raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                             f"{tuple(shape)}")
    for name, t in (("coef", coef), ("enc_exp", enc_exp), ("bap", bap)):
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")


def quantize(coef, enc_exp, global_exp, bap, codes=torch.int32):
    """The quantizer (see the module docstring): every tensor contiguous
    and on one device, coef's last axis a multiple of 16, coef, enc_exp
    and bap 16-byte aligned; codes torch.int32 (JAX's dtype) or
    torch.int16 (their low 16 bits).  CUDA tensors launch Q1 once, CPU
    ones run quantize_ref."""
    global launches_quantize
    _check(coef, enc_exp, global_exp, bap, codes)
    dev = coef.device
    if dev.type == "cpu":
        return quantize_ref(coef, enc_exp, global_exp, bap, codes)
    out = torch.empty(coef.shape, dtype=codes, device=dev)
    if coef.numel() == 0:
        return out
    lib = _cuda.load("quantize", _bind)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.quantize_launch(
            coef.data_ptr(), enc_exp.data_ptr(),
            int(enc_exp.dtype == torch.int32), global_exp.data_ptr(),
            bap.data_ptr(), out.data_ptr(), out.element_size(),
            coef.numel(), coef.shape[-1], stream)
    if rc != 0:
        raise RuntimeError("quantize (Q1) kernel launch failed: "
                           + lib.quantize_error_string(rc).decode())
    launches_quantize += 1
    return out
