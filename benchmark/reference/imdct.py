"""The order-exact float IMDCT of liba52 (imdct.c:77-345), in plain PyTorch.

A frozen copy of the port's plain version (``split_fb_exact_ref``, float
variant only), kept here so that the benchmark's reference never imports
the program: the split-radix IFFT's leaves, butterflies and pre- and
post-twiddles replayed operation for operation, each eager op rounding its
own result, then the windowed overlap-add ``z*win + fold(d)*win_r + bias``
as separate ops.  That is the compiled float liba52's output bit for bit
(``benchmark/tests`` holds it to ``tests/golden/*.stereo_float.npy``).
"""
from __future__ import annotations

from types import SimpleNamespace

import numpy as np
import torch

from . import tables as T

# eager float32 matmuls never run here, but the switch stays off as in the
# program: nothing in this package may compute in TF32
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

FLOAT = SimpleNamespace(mul=torch.mul, one=1.0, neg=torch.neg,
                        out=lambda x: x)

_ON = {}


def _tw_on(device) -> dict:
    """The float twiddle tables as tensors on `device` (fftorder int64)."""
    key = str(torch.device(device))
    if key not in _ON:
        tw = T.imdct_twiddles()
        out = {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
               for k, v in tw.items() if k != "fftorder"}
        out["fftorder"] = torch.from_numpy(
            np.asarray(tw["fftorder"], np.int64)).to(device)
        _ON[key] = out
    return _ON[key]


# complex values as (re, im) pairs of [..., n] tensors; `m` is the multiply


def _ifft2(re, im):
    r0, r1 = re[..., 0], re[..., 1]
    i0, i1 = im[..., 0], im[..., 1]
    return (torch.stack([r0 + r1, r0 - r1], -1),
            torch.stack([i0 + i1, i0 - i1], -1))


def _ifft4(re, im, _ar=None):
    """ifft4, which multiplies nothing (_ar: the leaves' common
    signature in _split_radix)."""
    tmp1 = re[..., 0] + re[..., 1]
    tmp2 = re[..., 3] + re[..., 2]
    tmp3 = im[..., 0] + im[..., 1]
    tmp4 = im[..., 2] + im[..., 3]
    tmp5 = re[..., 0] - re[..., 1]
    tmp6 = im[..., 0] - im[..., 1]
    tmp7 = im[..., 2] - im[..., 3]
    tmp8 = re[..., 3] - re[..., 2]
    return (torch.stack([tmp1 + tmp2, tmp5 + tmp7, tmp1 - tmp2, tmp5 - tmp7],
                        -1),
            torch.stack([tmp3 + tmp4, tmp6 + tmp8, tmp3 - tmp4, tmp6 - tmp8],
                        -1))


def _bf_zero(a0r, a0i, a1r, a1i, a2r, a2i, a3r, a3i):
    tmp1 = a2r + a3r
    tmp2 = a2i + a3i
    tmp3 = a2i - a3i
    tmp4 = a3r - a2r
    return (a0r + tmp1, a0i + tmp2, a1r + tmp3, a1i + tmp4,
            a0r - tmp1, a0i - tmp2, a1r - tmp3, a1i - tmp4)


def _bf_half(a0r, a0i, a1r, a1i, a2r, a2i, a3r, a3i, w, m):
    tmp5 = m(a2r + a2i, w)
    tmp6 = m(a2i - a2r, w)
    tmp7 = m(a3r - a3i, w)
    tmp8 = m(a3i + a3r, w)
    tmp1 = tmp5 + tmp7
    tmp2 = tmp6 + tmp8
    tmp3 = tmp6 - tmp8
    tmp4 = tmp7 - tmp5
    return (a0r + tmp1, a0i + tmp2, a1r + tmp3, a1i + tmp4,
            a0r - tmp1, a0i - tmp2, a1r - tmp3, a1i - tmp4)


def _bf(a0r, a0i, a1r, a1i, a2r, a2i, a3r, a3i, wr, wi, m):
    tmp5 = m(wi, a2i) + m(wr, a2r)
    tmp6 = m(wr, a2i) - m(wi, a2r)
    tmp8 = m(wi, a3r) + m(wr, a3i)
    tmp7 = m(wr, a3r) - m(wi, a3i)
    tmp1 = tmp5 + tmp7
    tmp2 = tmp6 + tmp8
    tmp3 = tmp6 - tmp8
    tmp4 = tmp7 - tmp5
    return (a0r + tmp1, a0i + tmp2, a1r + tmp3, a1i + tmp4,
            a0r - tmp1, a0i - tmp2, a1r - tmp3, a1i - tmp4)


def _ifft8(re, im, ar):
    r0, i0 = _ifft4(re[..., :4], im[..., :4])
    r1, i1 = _ifft2(re[..., 4:6], im[..., 4:6])
    r2, i2 = _ifft2(re[..., 6:8], im[..., 6:8])
    w = _tw_on(re.device)["roots16"][1]
    a0r, a0i, a1r, a1i, a2r, a2i, a3r, a3i = _bf_zero(
        r0[..., 0], i0[..., 0], r0[..., 2], i0[..., 2],
        r1[..., 0], i1[..., 0], r2[..., 0], i2[..., 0])
    b0r, b0i, b1r, b1i, b2r, b2i, b3r, b3i = _bf_half(
        r0[..., 1], i0[..., 1], r0[..., 3], i0[..., 3],
        r1[..., 1], i1[..., 1], r2[..., 1], i2[..., 1], w, ar.mul)
    return (torch.stack([a0r, b0r, a1r, b1r, a2r, b2r, a3r, b3r], -1),
            torch.stack([a0i, b0i, a1i, b1i, a2i, b2i, a3i, b3i], -1))


def _ifft_pass(re, im, roots, n, ar):
    """ifft_pass(buf, weight, n): butterflies over the 4 sub-buffers of
    length n.  The reference special-cases butterfly 0 (_bf_zero); here
    it rides the same wide _bf with wr=1, wi=0, which gives _bf_zero's
    values (float: x*1 and x*0 are exact, 0 + x is x, so only the signs of
    zeros can differ; fixed: MUL(2^30, x) = x and MUL(0, x) = 0)."""
    one = roots.new_full((1,), ar.one)
    wr = torch.cat([one, roots[: n - 1]])
    wi = torch.cat([one * 0, roots[: n - 1].flip(0)])
    v = _bf(re[..., 0:n], im[..., 0:n], re[..., n:2 * n], im[..., n:2 * n],
            re[..., 2 * n:3 * n], im[..., 2 * n:3 * n],
            re[..., 3 * n:], im[..., 3 * n:], wr, wi, ar.mul)
    return (torch.cat([v[0], v[2], v[4], v[6]], -1),
            torch.cat([v[1], v[3], v[5], v[7]], -1))


def _split_radix(sub, leaf1, leaf2, roots_key, n):
    """ifft of 4n points: sub (2n points) then two leaf transforms of n,
    joined by one ifft_pass (the shape shared by _ifft16.._ifft128)."""
    def ifft(re, im, ar):
        r0, i0 = sub(re[..., :2 * n], im[..., :2 * n], ar)
        r1, i1 = leaf1(re[..., 2 * n:3 * n], im[..., 2 * n:3 * n], ar)
        r2, i2 = leaf2(re[..., 3 * n:], im[..., 3 * n:], ar)
        return _ifft_pass(torch.cat([r0, r1, r2], -1),
                          torch.cat([i0, i1, i2], -1),
                          _tw_on(re.device)[roots_key], n, ar)
    return ifft


_ifft16 = _split_radix(_ifft8, _ifft4, _ifft4, "roots16", 4)
_ifft32 = _split_radix(_ifft16, _ifft8, _ifft8, "roots32", 8)
_ifft64 = _split_radix(_ifft32, _ifft16, _ifft16, "roots64", 16)
_ifft128 = _split_radix(_ifft64, _ifft32, _ifft32, "roots128", 32)


def _interleave(even, odd):
    """[..., m] x 2 -> [..., 2m] with even at 0, 2, .. and odd at 1, 3, .."""
    return torch.stack([even, odd], -1).flatten(-2)


def imdct512_z(data, ar=FLOAT):
    """data [..., 256] -> (z [..., 256], d [..., 128]): a52_imdct_512
    (imdct.c:258-293) split for the shared OLA epilogue."""
    tw = _tw_on(data.device)
    m, neg = ar.mul, ar.neg
    order = tw["fftorder"]
    dk = data.index_select(-1, order)
    dm = data.index_select(-1, 255 - order)
    tr, ti = tw["pre1_r"], tw["pre1_i"]
    bre, bim = _ifft128(m(ti, dm) + m(tr, dk), m(tr, dm) - m(ti, dk), ar)
    t_r, t_i = tw["post1_r"], tw["post1_i"]
    fr, fi = bre[..., :64], bim[..., :64]
    gr, gi = bre[..., 64:].flip(-1), bim[..., 64:].flip(-1)
    a_r = m(t_r, fr) + m(t_i, fi)
    a_i = m(t_i, fr) - m(t_r, fi)
    b_r = m(t_i, gr) + m(t_r, gi)
    b_i = m(t_r, gr) - m(t_i, gi)
    # z[2i] = -a_r, z[2i+1] = b_r, z[254-2i] = -b_r, z[255-2i] = a_r (the
    # signs folded in the float variant only); d[2i] = a_i, d[2i+1] = b_i
    # (i < 64)
    z = torch.cat([_interleave(neg(a_r), b_r),
                   _interleave(neg(b_r.flip(-1)), a_r.flip(-1))], -1)
    return ar.out(z), ar.out(_interleave(a_i, b_i))


def imdct256_z(data, ar=FLOAT):
    """Short-block twin of imdct512_z (a52_imdct_256, imdct.c:295-345):
    two 128-point transforms of the interleaved coefficient halves."""
    tw = _tw_on(data.device)
    m, neg = ar.mul, ar.neg
    k = tw["fftorder"][:64]
    tr, ti = tw["pre2_r"], tw["pre2_i"]
    d1a, d1b = data.index_select(-1, k), data.index_select(-1, 254 - k)
    d2a, d2b = data.index_select(-1, k + 1), data.index_select(-1, 255 - k)
    b1r, b1i = _ifft64(m(ti, d1b) + m(tr, d1a), m(tr, d1b) - m(ti, d1a), ar)
    b2r, b2i = _ifft64(m(ti, d2b) + m(tr, d2a), m(tr, d2b) - m(ti, d2a), ar)

    t_r, t_i = tw["post2_r"], tw["post2_i"]
    a_r = m(t_r, b1r[..., :32]) + m(t_i, b1i[..., :32])
    a_i = m(t_i, b1r[..., :32]) - m(t_r, b1i[..., :32])
    g1r, g1i = b1r[..., 32:].flip(-1), b1i[..., 32:].flip(-1)
    b_r = m(t_i, g1r) + m(t_r, g1i)
    b_i = m(t_r, g1r) - m(t_i, g1i)
    c_r = m(t_r, b2r[..., :32]) + m(t_i, b2i[..., :32])
    c_i = m(t_i, b2r[..., :32]) - m(t_r, b2i[..., :32])
    g2r, g2i = b2r[..., 32:].flip(-1), b2i[..., 32:].flip(-1)
    d_r = m(t_i, g2r) + m(t_r, g2i)
    d_i = m(t_r, g2r) - m(t_i, g2i)
    # i < 32: z[2i] = -a_r, z[2i+1] = -b_i, z[126-2i] = -b_r,
    # z[127-2i] = -a_i, z[128+2i] = a_i, z[129+2i] = b_r, z[254-2i] = b_i,
    # z[255-2i] = a_r (the signs folded in the float variant only);
    # d[2i] = c_i, d[2i+1] = d_r, d[126-2i] = d_i, d[127-2i] = c_r
    fl = lambda x: x.flip(-1)
    z = torch.cat([_interleave(neg(a_r), neg(b_i)),
                   _interleave(neg(fl(b_r)), neg(fl(a_i))),
                   _interleave(a_i, b_r), _interleave(fl(b_i), fl(a_r))], -1)
    d = torch.cat([_interleave(c_i, d_r), _interleave(fl(d_i), fl(c_r))], -1)
    return ar.out(z), ar.out(d)


def _split_ref(coeffs, blksw, ar):
    z_l, d_l = imdct512_z(coeffs, ar)
    if blksw is None:
        return z_l, d_l
    z_s, d_s = imdct256_z(coeffs, ar)
    blk = blksw[..., None]
    return torch.where(blk, z_s, z_l), torch.where(blk, d_s, d_l)


_WIN = {}


def window_on(device):
    """(win [256], win reversed) float32 on `device`."""
    key = str(torch.device(device))
    if key not in _WIN:
        win = T.kbd_window().astype(np.float32)
        _WIN[key] = tuple(torch.from_numpy(np.ascontiguousarray(a)).to(device)
                          for a in (win, win[::-1]))
    return _WIN[key]


def filterbank_exact(coeffs, delay, blksw, bias):
    """coeffs [..., 256], delay [..., 128], blksw (broadcast to the rows;
    True = short block), bias (broadcast to the rows) -> (out [..., 256],
    new delay [..., 128]), liba52's float order bit for bit."""
    blksw = torch.as_tensor(blksw, dtype=torch.bool, device=coeffs.device)
    blksw = blksw.expand(coeffs.shape[:-1]).contiguous()
    z, dnew = _split_ref(coeffs.contiguous(), blksw, FLOAT)
    win, win_r = window_on(z.device)
    dfold = torch.cat([delay, delay.flip(-1)], dim=-1)
    return z * win + dfold * win_r + torch.as_tensor(bias)[..., None], dnew


def convert_to_int16(biased: torch.Tensor, bias: float = 384.0):
    """Planar biased float -> int16: (x - 384) * 32768, rounded half to
    even, clipped."""
    x = (biased - bias) * 32768.0
    return torch.clamp(torch.round(x), -32768.0, 32767.0).to(torch.int16)
