"""Order-exact IMDCT: the (z, d) split, bit-identical to liba52, in the
float and the fixed-point (Q30) sample types.

The matmul filterbank (ops.filterbank) sums each output as one dot
product; the reference computes it through the split-radix IFFT of
imdct.c:77-345 (ifft2/4/8 leaves, ifft_pass butterflies, pre- and
post-twiddles), and the two orders round differently by about an ulp.
This module replays the reference's order operation for operation, so
that the shared windowed overlap-add (models.decoder's ``ola``)
reproduces the compiled float build's output bit for bit.

``split_fb_exact(coeffs, blksw)`` returns, per row of 256 coefficients,

    z [256]  the post-twiddled outputs at their window positions, with
             the reference's "- a*w" terms folded in as a sign flip
             (fl(-a*w) == -fl(a*w), so the window product is unchanged)
    d [128]  the new OLA delay, independent of the entering delay

for a long (512-point) block, or for a short one (two 256-point
transforms) where ``blksw`` is set.  On a CUDA tensor it launches the
hand-written kernel csrc/imdct_exact.cu (B1; the JAX package computes the
same function in XLA, ac3acm_tpu/ops/imdct_exact.py:437,466, with no
pallas_call); on a CPU tensor it runs ``split_fb_exact_ref``, the plain
PyTorch version below.  There is no other path.

Exactness in eager PyTorch needs no guard: every elementwise op is its
own kernel and rounds its result, so no multiply is ever contracted into
the add that follows it (the JAX package needs an f64 round trip or an
optimization barrier for that, and {0, +-1} matmuls for the
permutations; here they are index_select, flip and interleaving).

``filterbank_exact`` wraps the split with that overlap-add for one block
step at a time (models.decoder._block_step).

The fixed-point variant (LIBA52_FIXED, int32 Q30) replays the same
transform with the reference's MUL (native/ac3sample.inc:33-38: a split
16-bit multiply, intermediates mod 2^32) and the Q30 tables of
``_tw_fixed``.  ``split_fb_fixed`` (kernel B1Q, the third entry of
csrc/imdct_exact.cu, on a CUDA tensor; ``split_fb_fixed_ref`` on the CPU)
returns z and d as above except that z keeps each value's own sign: MUL
truncates with arithmetic shifts, so MUL(-a, w) != -MUL(a, w) (MUL(-1,
2^29) = -1, -MUL(1, 2^29) = 0) and the sign cannot fold into z.  The
fixed overlap-add ``filterbank_fixed`` subtracts MUL(z, w) where the
reference does (a +-1 sign vector applied after the MUL, exact mod 2^32).
``get_variant("float" | "fixed")`` gives the JAX package's entry points
(``imdct512``, ``imdct256``, ``filterbank``) of either variant.  The
fixed decode path (models.decoder.fixed_block_pipeline) runs none of
these on the card: kernel B1QS (ops.fixed_chain) takes its whole block
chain, on B1Q's transform code.

Integers: the plain fixed version keeps its values in int64 congruent mod
2^32 to the reference's uint32 ones (integer adds are exact, and their
order is free), wraps them to int32 explicitly (``_i32``) before every
MUL and at the outputs, and forms each split-16 partial product of a MUL
in int32, where it provably fits.  Nothing relies on signed int32
overflow.
"""
from __future__ import annotations

import ctypes as C
from typing import Callable, NamedTuple

import numpy as np
import torch

from .. import tables as T
from . import _cuda

# kernel launches since the last reset, B1 (float) and B1Q (fixed)
# (incremented only where the CUDA kernel is launched; the CPU path leaves
# them alone)
launches = 0
launches_fixed = 0

# the twiddle tables the kernel reads, packed in this order (float32,
# bit for bit those of tables.imdct_twiddles(); csrc/imdct_exact.cu
# names the same offsets)
_PACKED = (("pre1_r", 128), ("pre1_i", 128), ("post1_r", 64),
           ("post1_i", 64), ("pre2_r", 64), ("pre2_i", 64),
           ("post2_r", 32), ("post2_i", 32), ("roots16", 3),
           ("roots32", 7), ("roots64", 15), ("roots128", 31))

_ON = {}

Q30 = 1 << 30


def _tw_fixed() -> dict:
    """The twiddles and window SAMPLE()-quantized to int32 Q30 (truncation
    toward zero, the C cast of native/ac3sample.inc:31)."""
    return {k: (v if k == "fftorder" else np.trunc(
                np.asarray(v, np.float64) * float(Q30)).astype(np.int32))
            for k, v in T.imdct_twiddles_f64().items()}


# where the reference subtracts the window product of z in its overlap-add
# (imdct.c:283-290, 328-343): -1, else +1; the float z carries these signs
# (imdct512_z / imdct256_z), the fixed one does not
_SIGN_LONG = np.where(np.arange(256) % 2 == 0, -1, 1)
_SIGN_SHORT = np.where(np.arange(256) < 128, -1, 1)


def _tw_on(device, variant: str = "float") -> dict:
    """The variant's twiddle tables as tensors on `device` (float32, or
    int32 Q30 for "fixed"; fftorder as int64), made once per device;
    "packed"/"order32" are the kernel's operands."""
    device = torch.device(device)
    key = (str(device), variant)
    if key not in _ON:
        tw = T.imdct_twiddles() if variant == "float" else _tw_fixed()
        out = {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
               for k, v in tw.items() if k != "fftorder"}
        order = np.asarray(tw["fftorder"], np.int64)
        out["fftorder"] = torch.from_numpy(order).to(device)
        packed = np.concatenate([np.asarray(tw[k]) for k, n in _PACKED])
        assert [len(tw[k]) for k, _ in _PACKED] == [n for _, n in _PACKED]
        out["packed"] = torch.from_numpy(packed).to(device)
        out["order32"] = torch.from_numpy(order.astype(np.int32)).to(device)
        if variant == "fixed":
            out["win_r"] = out["window"].flip(0).contiguous()
            out["sign"] = torch.from_numpy(
                np.stack([_SIGN_LONG, _SIGN_SHORT])).to(device)
        _ON[key] = out
    return _ON[key]


def _i32(x):
    """x mod 2^32 as int32: an int32 tensor as it is, an int64 one wrapped
    explicitly (two's complement)."""
    if x.dtype == torch.int32:
        return x
    return (((x + (1 << 31)) & 0xFFFFFFFF) - (1 << 31)).to(torch.int32)


def _mul_fixed(a, b):
    """FixedOps::MUL (native/ac3sample.inc:33-38), the Q30 multiply of the
    fixed build: split 16-bit halves, intermediates mod 2^32.  a, b int32,
    or int64 taken mod 2^32 -> int64 congruent mod 2^32 to the reference's
    result (``_i32`` gives it as int32).  Each partial product fits in
    int32 (|a & 0xFFFF| < 2^16, |b >> 16| <= 2^15); their sum and the
    high product's << 2 are formed in int64 and wrapped explicitly."""
    a, b = _i32(a), _i32(b)
    ah, bh = a >> 16, b >> 16
    tc = _i32((a & 0xFFFF) * bh + (ah * (b & 0xFFFF)).long())
    return (tc >> 14).long() + ((ah * bh).long() << 2)


class _Arith(NamedTuple):
    """One sample type of the transform: its tables ("float" or "fixed"),
    its multiply, its one (butterfly 0's weight), the sign fold of z
    (``neg``: the float variant negates where the reference subtracts;
    the fixed one cannot, MUL is not odd, and keeps each value's sign),
    the wrap of the outputs into ``dtype``, and the names of the wrapper
    and of its kernel's entry in csrc/imdct_exact.cu."""
    variant: str
    mul: Callable
    one: float | int
    neg: Callable
    out: Callable
    dtype: torch.dtype
    name: str
    entry: str


def _same(x):
    return x


FLOAT = _Arith("float", torch.mul, 1.0, torch.neg, _same, torch.float32,
               "split_fb_exact", "imdct_exact_launch")
FIXED = _Arith("fixed", _mul_fixed, Q30, _same, _i32, torch.int32,
               "split_fb_fixed", "imdct_fixed_launch")


# complex values as (re, im) pairs of [..., n] tensors; `m` is the
# variant's multiply ----------------------------------------------------------

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
    w = _tw_on(re.device, ar.variant)["roots16"][1]
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
                          _tw_on(re.device, ar.variant)[roots_key], n, ar)
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
    tw = _tw_on(data.device, ar.variant)
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
    tw = _tw_on(data.device, ar.variant)
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


def split_fb_exact_ref(coeffs, blksw=None):
    """Plain PyTorch version of split_fb_exact (any device)."""
    return _split_ref(coeffs, blksw, FLOAT)


def split_fb_fixed_ref(coeffs, blksw=None):
    """Plain PyTorch version of split_fb_fixed (any device)."""
    return _split_ref(coeffs, blksw, FIXED)


def _ola_float(z, delay, blksw, bias):
    """The float overlap-add: z*win + fold(delay)*win_r + bias, each op
    rounding on its own; z carries the signs, blksw is not needed."""
    from .filterbank import mats_on
    _, _, win, win_r = mats_on(z.device)
    dfold = torch.cat([delay, delay.flip(-1)], dim=-1)
    return z * win + dfold * win_r + bias


def _ola_fixed(z, delay, blksw, bias):
    """The fixed build's overlap-add: MUL(delay, w) +- MUL(z, w') + bias
    with the reference's own products, the sign applied after the MUL."""
    tw = _tw_on(z.device, "fixed")
    dfold = torch.cat([delay, delay.flip(-1)], dim=-1)
    sign = tw["sign"][blksw.long()]
    return _i32(_mul_fixed(dfold, tw["win_r"])
                + sign * _mul_fixed(z, tw["window"]) + bias)


def _filterbank(split, ola, coeffs, delay, blksw, bias):
    """split then the overlap-add; bias broadcasts against the output."""
    blksw = torch.as_tensor(blksw, dtype=torch.bool, device=coeffs.device)
    blksw = blksw.expand(coeffs.shape[:-1]).contiguous()
    z, dnew = split(coeffs.contiguous(), blksw)
    return ola(z, delay, blksw, bias), dnew


def filterbank_exact(coeffs, delay, blksw, bias):
    """Drop-in for ops.filterbank.filterbank with the reference's operation
    order: coeffs [..., 256], delay [..., 128], blksw (broadcast to the
    rows; True = short block), bias (broadcast to the rows) -> (out
    [..., 256], new delay [..., 128]).

    The transform is split_fb_exact (B1 on a CUDA tensor); the windowed
    overlap-add z*win + fold(delay)*win_r + bias runs as separate eager
    ops, each rounding its own result, which with z's folded signs is
    the reference's per-sample formula bit for bit.  (Never addcmul or
    torch.compile here: both fuse the multiply into the add.)"""
    return _filterbank(split_fb_exact, _ola_float, coeffs, delay, blksw,
                       torch.as_tensor(bias)[..., None])


def filterbank_fixed(coeffs, delay, blksw, bias):
    """filterbank_exact of the fixed build: coeffs [..., 256] and delay
    [..., 128] int32 Q30, blksw and bias (int32) broadcast to the rows ->
    (out [..., 256], new delay [..., 128]) int32.  The transform is
    split_fb_fixed (B1Q on a CUDA tensor); the overlap-add runs eagerly
    (_ola_fixed), bit for bit the -DLIBA52_FIXED reference.  The fixed
    decode path does not call it on the card: its whole block chain is
    kernel B1QS (ops.fixed_chain), whose plain version runs this
    function's plain twin."""
    return _filterbank(split_fb_fixed, _ola_fixed, coeffs, delay, blksw,
                       torch.as_tensor(bias)[..., None])


def get_variant(variant: str) -> dict:
    """The JAX package's entry points of one sample type ("float" or
    "fixed"): imdct512(data, delay, bias) and imdct256 (a52_imdct_512 /
    _256 of every row; bias broadcasts against the output) and
    filterbank(coeffs, delay, blksw, bias) (bias broadcasts against the
    rows), each the variant's split (its kernel on a CUDA tensor) then
    its overlap-add.  "float" also has imdct512_z(data) and imdct256_z
    (data [..., 256] -> (z [..., 256], d [..., 128]), every row long or
    every row short), the split alone."""
    if variant not in ("float", "fixed"):
        raise ValueError(f"variant must be float|fixed, got {variant!r}")
    split, ola, fb = ((split_fb_exact, _ola_float, filterbank_exact)
                      if variant == "float" else
                      (split_fb_fixed, _ola_fixed, filterbank_fixed))
    out = {
        "imdct512": lambda data, delay, bias: _filterbank(
            split, ola, data, delay, False, bias),
        "imdct256": lambda data, delay, bias: _filterbank(
            split, ola, data, delay, True, bias),
        "filterbank": fb,
    }
    if variant == "float":
        out["imdct512_z"] = lambda data: _split_rows(data, False)
        out["imdct256_z"] = lambda data: _split_rows(data, True)
    return out


def _split_rows(data, short: bool):
    """split_fb_exact with every row long (blksw None) or every row short."""
    data = data.contiguous()
    return split_fb_exact(data, torch.ones(data.shape[:-1], dtype=torch.bool,
                                           device=data.device)
                          if short else None)


def imdct512_exact(data, delay, bias):
    """a52_imdct_512 of every row: data [..., 256], delay [..., 128] ->
    (out [..., 256], new delay [..., 128]) float32 (get_variant)."""
    return get_variant("float")["imdct512"](data, delay, bias)


def imdct256_exact(data, delay, bias):
    """a52_imdct_256 of every row, as imdct512_exact."""
    return get_variant("float")["imdct256"](data, delay, bias)


def _bind(lib):
    """argtypes of csrc/imdct_exact.cu's entries: B1, B1Q, B1F (the fused
    steady tail of ops.fused_steady_exact) and B1QS (the fixed block chain
    of ops.fixed_chain) share the library."""
    p, i = C.c_void_p, C.c_int
    for ar in (FLOAT, FIXED):
        fn = getattr(lib, ar.entry)
        fn.restype = C.c_int
        fn.argtypes = [p, p, p, p, p, p, C.c_longlong, p]
    lib.fused_steady_exact_launch.restype = C.c_int
    lib.fused_steady_exact_launch.argtypes = [p] * 10 + [i, i, i, i, p]
    lib.fixed_chain_launch.restype = C.c_int
    lib.fixed_chain_launch.argtypes = [p] * 13 + [i, p, p]
    lib.fixed_chain_mix_size.restype = C.c_int
    lib.fixed_chain_mix_size.argtypes = []
    lib.imdct_exact_bare_launch.restype = C.c_int
    lib.imdct_exact_bare_launch.argtypes = [i, i, i, p]
    lib.fixed_chain_shape.restype = None
    lib.fixed_chain_shape.argtypes = [p]
    lib.imdct_exact_error_string.restype = C.c_char_p
    lib.imdct_exact_error_string.argtypes = [C.c_int]


def _split_fb(coeffs, blksw, ar):
    """split_fb_exact / split_fb_fixed: the checks, then the plain version
    (CPU) or the kernel (CUDA)."""
    global launches, launches_fixed
    if coeffs.dtype != ar.dtype:
        raise TypeError(f"coeffs is {coeffs.dtype}, expected {ar.dtype}")
    if coeffs.dim() < 1 or coeffs.shape[-1] != 256:
        raise ValueError(f"coeffs must be [..., 256], got "
                         f"{tuple(coeffs.shape)}")
    if not coeffs.is_contiguous():
        raise ValueError("coeffs must be contiguous")
    if blksw is not None:
        if blksw.dtype != torch.bool:
            raise TypeError(f"blksw is {blksw.dtype}, expected torch.bool")
        if blksw.shape != coeffs.shape[:-1]:
            raise ValueError(f"blksw has shape {tuple(blksw.shape)}, "
                             f"expected {tuple(coeffs.shape[:-1])}")
        if blksw.device != coeffs.device:
            raise ValueError(f"blksw is on {blksw.device}, coeffs on "
                             f"{coeffs.device}")
        if not blksw.is_contiguous():
            raise ValueError("blksw must be contiguous")
    if coeffs.device.type not in ("cuda", "cpu"):
        raise ValueError(f"{ar.name} runs on cuda or cpu, not "
                         f"{coeffs.device}")
    if coeffs.data_ptr() % 16:
        raise ValueError("coeffs must be 16-byte aligned")
    if coeffs.device.type == "cpu":
        return _split_ref(coeffs, blksw, ar)
    dev = coeffs.device
    lead = coeffs.shape[:-1]
    z = torch.empty(lead + (256,), dtype=ar.dtype, device=dev)
    d = torch.empty(lead + (128,), dtype=ar.dtype, device=dev)
    rows = coeffs.numel() // 256
    if rows == 0:
        return z, d
    tw = _tw_on(dev, ar.variant)
    lib = _cuda.load("imdct_exact", _bind)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = getattr(lib, ar.entry)(
            coeffs.data_ptr(), None if blksw is None else blksw.data_ptr(),
            tw["packed"].data_ptr(), tw["order32"].data_ptr(),
            z.data_ptr(), d.data_ptr(), rows, stream)
    if rc != 0:
        raise RuntimeError(f"{ar.name} kernel launch failed: "
                           + lib.imdct_exact_error_string(rc).decode())
    if ar is FIXED:
        launches_fixed += 1
    else:
        launches += 1
    return z, d


def split_fb_exact(coeffs, blksw=None):
    """coeffs [..., 256] float32, blksw [...] bool (the same leading
    shape; True = short block) or None (every row long)
    -> (z [..., 256], d [..., 128]) float32.

    Both inputs must be contiguous and coeffs 16-byte aligned (rows of
    1 KB), on either device; a CUDA tensor launches the kernel B1, a CPU
    tensor runs split_fb_exact_ref."""
    return _split_fb(coeffs, blksw, FLOAT)


def split_fb_fixed(coeffs, blksw=None):
    """The fixed build's split: coeffs [..., 256] int32 Q30, blksw as for
    split_fb_exact -> (z [..., 256], d [..., 128]) int32, z with each
    value's own sign (filterbank_fixed applies the reference's).

    Both inputs must be contiguous and coeffs 16-byte aligned, on either
    device; a CUDA tensor launches the kernel B1Q (csrc/imdct_exact.cu:
    imdct_fixed_kernel), a CPU tensor runs split_fb_fixed_ref.  The JAX
    package computes the same function in XLA
    (ac3acm_tpu/ops/imdct_exact.py:256,294, _build("fixed")), with no
    pallas_call."""
    return _split_fb(coeffs, blksw, FIXED)
