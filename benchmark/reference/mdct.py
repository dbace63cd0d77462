"""Encoder forward MDCT: the reference's int16 block-float arithmetic.

The reference encoder's 512-point MDCT (ac3enc.cpp:441-603) is a radix-2
128-point complex FFT whose every butterfly halves (>>1) and whose twiddle
products truncate (>>15), with results stored through int16.  Bit-exact
frames need those truncations and wraps, so this runs the same dataflow on
int32 tensors with an explicit wrap to int16 wherever the C code stores
through a short.  Every product here is of an int16-valued operand and a
15-bit twiddle or window value, and every sum adds two of them, so no
int32 intermediate can overflow (|sum| <= 2 * 32768 * 32767 < 2^31).

Batched over any leading axes: six blocks x channels x streams run
together, one elementwise op per butterfly stage.
"""
from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from . import tables as T

N = 512
NBITS = 7          # 128-point FFT


def _fix15(a32: np.ndarray) -> np.ndarray:
    """fix15 on a float32 input: v = (int)(a * 32768.0f), clamp +-32767."""
    a32 = a32.astype(np.float32)
    v = np.trunc((a32 * np.float32(32768.0)).astype(np.float32)).astype(np.int64)
    return np.clip(v, -32767, 32767).astype(np.int32)


@lru_cache(maxsize=1)
def _twiddles():
    """numpy (costab [64], sintab [64], xcos1 [128], xsin1 [128], rev [128])."""
    # fft_init: alpha = (float)(2*pi*i/n); fix15((float)cos(alpha))
    i = np.arange(64)
    alpha = (2 * np.pi * i / 128.0).astype(np.float32)
    costab = _fix15(np.cos(alpha.astype(np.float64)).astype(np.float32))
    sintab = _fix15(np.sin(alpha.astype(np.float64)).astype(np.float32))
    # encoder init: alpha = (float)(2*pi*(i+1/8)/512); fix15((float)-cos(alpha))
    i = np.arange(128)
    alpha = (2 * np.pi * (i + 1.0 / 8.0) / N).astype(np.float32)
    xcos1 = _fix15((-np.cos(alpha.astype(np.float64))).astype(np.float32))
    xsin1 = _fix15((-np.sin(alpha.astype(np.float64))).astype(np.float32))
    rev = np.zeros(128, np.int64)
    for k in range(128):
        m = 0
        for j in range(NBITS):
            m |= ((k >> j) & 1) << (NBITS - 1 - j)
        rev[k] = m
    return costab, sintab, xcos1, xsin1, rev


@lru_cache(maxsize=8)
def _tables_on(device: torch.device):
    """The twiddles, the butterfly stages' twiddle rows and the encoder
    window as tensors on `device`."""
    costab, sintab, xcos1, xsin1, rev = _twiddles()

    def t(a, dtype=torch.int32):
        return torch.tensor(np.asarray(a), dtype=dtype, device=device)

    stages = []
    for s in range(2, NBITS):
        half = 1 << s
        nblocks = 128 >> (s + 1)
        l = np.arange(half) * nblocks              # twiddle indices, l[0]=0
        stages.append((t(costab[l]), t(sintab[l])))
    return dict(xcos1=t(xcos1), xsin1=t(xsin1), rev=t(rev, torch.int64),
                stages=stages,
                window=t(T.enc_window_int16().astype(np.int32)))


def _wrap16(x):
    """int32 -> the value of (int16)x, kept in int32."""
    return ((x + 0x8000) & 0xFFFF) - 0x8000


def _ilv(*parts):
    """Interleave equal-length last axes: a0 b0 [c0 ...] a1 b1 ..."""
    out = torch.stack(parts, dim=-1)
    return out.reshape(out.shape[:-2] + (out.shape[-2] * len(parts),))


def _fft128(re, im):
    """Batched 128-point FFT with the reference's exact >>1 / >>15
    truncations and int16 stores.  re/im: [..., 128] int32."""
    tab = _tables_on(re.device)
    re = re[..., tab["rev"]]
    im = im[..., tab["rev"]]

    def bf(pre, pim, qre, qim):
        # BF macro: p' = (p+q)>>1, q' = (p-q)>>1, stored to int16
        return (_wrap16((pre + qre) >> 1), _wrap16((pim + qim) >> 1),
                _wrap16((pre - qre) >> 1), _wrap16((pim - qim) >> 1))

    # pass 0: stride-2 pairs
    a, b, c, d = bf(re[..., 0::2], im[..., 0::2], re[..., 1::2],
                    im[..., 1::2])
    re, im = _ilv(a, c), _ilv(b, d)

    # pass 1: groups of 4; the second butterfly uses (q.im, -q.re)
    p0, p1, p2, p3 = (re[..., k::4] for k in range(4))
    q0, q1, q2, q3 = (im[..., k::4] for k in range(4))
    a0, b0, c0, d0 = bf(p0, q0, p2, q2)
    a1, b1, c1, d1 = bf(p1, q1, q3, -p3)
    re, im = _ilv(a0, a1, c0, c1), _ilv(b0, b1, d0, d1)

    # passes 2..6: each stage's (p, q) lanes are a [nblocks, 2, half] view
    lead = re.shape[:-1]
    for s, (ct, st) in zip(range(2, NBITS), tab["stages"]):
        half = 1 << s
        nblocks = 128 >> (s + 1)
        re4 = re.reshape(lead + (nblocks, 2, half))
        im4 = im.reshape(lead + (nblocks, 2, half))
        pre, qre = re4[..., 0, :], re4[..., 1, :]
        pim, qim = im4[..., 0, :], im4[..., 1, :]
        # CMUL(tmp, costab[l], -sintab[l], q); the l = 0 butterfly takes q
        tre = (ct * qre + st * qim) >> 15
        tim = (ct * qim - st * qre) >> 15
        tre[..., 0] = qre[..., 0]
        tim[..., 0] = qim[..., 0]
        a, b, c, d = bf(pre, pim, tre, tim)
        re = torch.stack([a, c], dim=-2).reshape(lead + (128,))
        im = torch.stack([b, d], dim=-2).reshape(lead + (128,))
    return re, im


def mdct512(x):
    """x [..., 512] int32 (int16-valued windowed, normalized samples)
    -> coefficients [..., 256] int32 (full precision, like the C long)."""
    tab = _tables_on(x.device)
    xc, xs = tab["xcos1"], tab["xsin1"]
    # rotation: rot[i] = -x[i+384] (i<128), rot[i] = x[i-128] (i>=128)
    rot = _wrap16(torch.cat([-x[..., 384:], x[..., :384]], dim=-1))
    # pre rotation from strided views: rot[2i], rot[511-2i], rot[256+2i],
    # rot[255-2i]
    reA = (rot[..., 0:256:2] - rot[..., 257::2].flip(-1)) >> 1
    imA = (-(rot[..., 256::2] - rot[..., 1:256:2].flip(-1))) >> 1
    # CMUL(x.re, x.im, re, im, -xcos1, xsin1) stored to int16
    zre = _wrap16((reA * (-xc) - imA * xs) >> 15)
    zim = _wrap16((reA * xs + (-xc) * imA) >> 15)
    fre, fim = _fft128(zre, zim)
    # post rotation CMUL(re1, im1, re, im, xsin1, xcos1), full precision
    re1 = (fre * xs - fim * xc) >> 15
    im1 = (fre * xc + xs * fim) >> 15
    # out[2i] = im1[i]; out[255-2i] = re1[i]  <=>  out[2j+1] = re1[127-j]
    return _ilv(im1, re1.flip(-1))


def av_log2(v):
    """floor(log2(v)) for v >= 1, 0 for v == 0 (ff_log2_tab semantics);
    v int32 >= 0.  The exponent of the float64 value, which holds every
    int32 exactly."""
    return (torch.frexp(v.to(torch.float64)).exponent - 1).clamp(
        min=0).to(v.dtype)


def window_norm_block(last, cur):
    """One block's framing: window + block-float normalize.

    last/cur [..., 256] int32 (int16-valued).  Returns (windowed
    [..., 512], the left shift v [...], exp_samples = v - 9).

    The reference ORs |x| over the block to find its top set bit; the top
    set bit of the OR is that of the largest |x|, so amax stands in."""
    w = _tables_on(cur.device)["window"]
    front = _wrap16((last * w) >> 15)
    back = _wrap16((cur.flip(-1) * w) >> 15).flip(-1)
    x = torch.cat([front, back], dim=-1)
    vmax = x.abs().amax(dim=-1)
    # av_log2 >= 0, so the shift count lies in [0, 14]
    v = (14 - av_log2(vmax)).clamp(0, 14)
    x = _wrap16(x << v[..., None])
    return x, v, v - 9


def extract_exponents(coef, exp_samples):
    """coef [..., 256] int32, exp_samples [...] -> (exp [..., 256] int32,
    coef with overrange values zeroed)."""
    v = coef.abs()
    e = 23 - av_log2(v) + exp_samples[..., None]
    e = torch.where(v == 0, 24, e)
    over = e >= 24
    e = torch.where(over, 24, e)
    coef = torch.where(over & (v != 0), 0, coef)
    return e, coef
