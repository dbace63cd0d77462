"""Order-exact float IMDCT: the (z, d) split, bit-identical to liba52.

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
step at a time (models.decoder._block_step).  Only the float variant is
ported; the fixed-point one is ROADMAP A8.
"""
from __future__ import annotations

import ctypes as C

import numpy as np
import torch

from .. import tables as T
from . import _cuda

# kernel launches since the last reset (incremented only where the CUDA
# kernel is launched; the CPU path leaves it alone)
launches = 0

# the twiddle tables the kernel reads, packed in this order (float32,
# bit for bit those of tables.imdct_twiddles(); csrc/imdct_exact.cu
# names the same offsets)
_PACKED = (("pre1_r", 128), ("pre1_i", 128), ("post1_r", 64),
           ("post1_i", 64), ("pre2_r", 64), ("pre2_i", 64),
           ("post2_r", 32), ("post2_i", 32), ("roots16", 3),
           ("roots32", 7), ("roots64", 15), ("roots128", 31))

_ON = {}


def _tw_on(device) -> dict:
    """imdct_twiddles() as tensors on `device` (fftorder as int64), made
    once per device; "packed"/"order32" are the kernel's operands."""
    device = torch.device(device)
    key = str(device)
    if key not in _ON:
        tw = T.imdct_twiddles()
        out = {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
               for k, v in tw.items() if k != "fftorder"}
        order = np.asarray(tw["fftorder"], np.int64)
        out["fftorder"] = torch.from_numpy(order).to(device)
        packed = np.concatenate([np.asarray(tw[k], np.float32)
                                 for k, n in _PACKED])
        assert [len(tw[k]) for k, _ in _PACKED] == [n for _, n in _PACKED]
        out["packed"] = torch.from_numpy(packed).to(device)
        out["order32"] = torch.from_numpy(order.astype(np.int32)).to(device)
        _ON[key] = out
    return _ON[key]


# complex values as (re, im) pairs of [..., n] tensors -----------------------

def _ifft2(re, im):
    r0, r1 = re[..., 0], re[..., 1]
    i0, i1 = im[..., 0], im[..., 1]
    return (torch.stack([r0 + r1, r0 - r1], -1),
            torch.stack([i0 + i1, i0 - i1], -1))


def _ifft4(re, im):
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


def _bf_half(a0r, a0i, a1r, a1i, a2r, a2i, a3r, a3i, w):
    tmp5 = (a2r + a2i) * w
    tmp6 = (a2i - a2r) * w
    tmp7 = (a3r - a3i) * w
    tmp8 = (a3i + a3r) * w
    tmp1 = tmp5 + tmp7
    tmp2 = tmp6 + tmp8
    tmp3 = tmp6 - tmp8
    tmp4 = tmp7 - tmp5
    return (a0r + tmp1, a0i + tmp2, a1r + tmp3, a1i + tmp4,
            a0r - tmp1, a0i - tmp2, a1r - tmp3, a1i - tmp4)


def _bf(a0r, a0i, a1r, a1i, a2r, a2i, a3r, a3i, wr, wi):
    tmp5 = wi * a2i + wr * a2r
    tmp6 = wr * a2i - wi * a2r
    tmp8 = wi * a3r + wr * a3i
    tmp7 = wr * a3r - wi * a3i
    tmp1 = tmp5 + tmp7
    tmp2 = tmp6 + tmp8
    tmp3 = tmp6 - tmp8
    tmp4 = tmp7 - tmp5
    return (a0r + tmp1, a0i + tmp2, a1r + tmp3, a1i + tmp4,
            a0r - tmp1, a0i - tmp2, a1r - tmp3, a1i - tmp4)


def _ifft8(re, im):
    r0, i0 = _ifft4(re[..., :4], im[..., :4])
    r1, i1 = _ifft2(re[..., 4:6], im[..., 4:6])
    r2, i2 = _ifft2(re[..., 6:8], im[..., 6:8])
    w = _tw_on(re.device)["roots16"][1]
    a0r, a0i, a1r, a1i, a2r, a2i, a3r, a3i = _bf_zero(
        r0[..., 0], i0[..., 0], r0[..., 2], i0[..., 2],
        r1[..., 0], i1[..., 0], r2[..., 0], i2[..., 0])
    b0r, b0i, b1r, b1i, b2r, b2i, b3r, b3i = _bf_half(
        r0[..., 1], i0[..., 1], r0[..., 3], i0[..., 3],
        r1[..., 1], i1[..., 1], r2[..., 1], i2[..., 1], w)
    return (torch.stack([a0r, b0r, a1r, b1r, a2r, b2r, a3r, b3r], -1),
            torch.stack([a0i, b0i, a1i, b1i, a2i, b2i, a3i, b3i], -1))


def _ifft_pass(re, im, roots, n):
    """ifft_pass(buf, weight, n): butterflies over the 4 sub-buffers of
    length n.  The reference special-cases butterfly 0 (_bf_zero); here
    it rides the same wide _bf with wr=1, wi=0, which gives _bf_zero's
    values (x*1 and x*0 are exact, 0 + x is x): only the signs of zeros
    can differ."""
    one = roots.new_ones(1)
    wr = torch.cat([one, roots[: n - 1]])
    wi = torch.cat([one * 0, roots[: n - 1].flip(0)])
    v = _bf(re[..., 0:n], im[..., 0:n], re[..., n:2 * n], im[..., n:2 * n],
            re[..., 2 * n:3 * n], im[..., 2 * n:3 * n],
            re[..., 3 * n:], im[..., 3 * n:], wr, wi)
    return (torch.cat([v[0], v[2], v[4], v[6]], -1),
            torch.cat([v[1], v[3], v[5], v[7]], -1))


def _split_radix(sub, leaf1, leaf2, roots_key, n):
    """ifft of 4n points: sub (2n points) then two leaf transforms of n,
    joined by one ifft_pass (the shape shared by _ifft16.._ifft128)."""
    def ifft(re, im):
        r0, i0 = sub(re[..., :2 * n], im[..., :2 * n])
        r1, i1 = leaf1(re[..., 2 * n:3 * n], im[..., 2 * n:3 * n])
        r2, i2 = leaf2(re[..., 3 * n:], im[..., 3 * n:])
        return _ifft_pass(torch.cat([r0, r1, r2], -1),
                          torch.cat([i0, i1, i2], -1),
                          _tw_on(re.device)[roots_key], n)
    return ifft


_ifft16 = _split_radix(_ifft8, _ifft4, _ifft4, "roots16", 4)
_ifft32 = _split_radix(_ifft16, _ifft8, _ifft8, "roots32", 8)
_ifft64 = _split_radix(_ifft32, _ifft16, _ifft16, "roots64", 16)
_ifft128 = _split_radix(_ifft64, _ifft32, _ifft32, "roots128", 32)


def _interleave(even, odd):
    """[..., m] x 2 -> [..., 2m] with even at 0, 2, .. and odd at 1, 3, .."""
    return torch.stack([even, odd], -1).flatten(-2)


def imdct512_z(data):
    """data [..., 256] -> (z [..., 256], d [..., 128]): a52_imdct_512
    (imdct.c:258-293) split for the shared OLA epilogue."""
    tw = _tw_on(data.device)
    order = tw["fftorder"]
    dk = data.index_select(-1, order)
    dm = data.index_select(-1, 255 - order)
    tr, ti = tw["pre1_r"], tw["pre1_i"]
    bre, bim = _ifft128(ti * dm + tr * dk, tr * dm - ti * dk)
    t_r, t_i = tw["post1_r"], tw["post1_i"]
    fr, fi = bre[..., :64], bim[..., :64]
    gr, gi = bre[..., 64:].flip(-1), bim[..., 64:].flip(-1)
    a_r = t_r * fr + t_i * fi
    a_i = t_i * fr - t_r * fi
    b_r = t_i * gr + t_r * gi
    b_i = t_r * gr - t_i * gi
    # z[2i] = -a_r, z[2i+1] = b_r, z[254-2i] = -b_r, z[255-2i] = a_r;
    # d[2i] = a_i, d[2i+1] = b_i  (i < 64)
    z = torch.cat([_interleave(-a_r, b_r),
                   _interleave(-b_r.flip(-1), a_r.flip(-1))], -1)
    return z, _interleave(a_i, b_i)


def imdct256_z(data):
    """Short-block twin of imdct512_z (a52_imdct_256, imdct.c:295-345):
    two 128-point transforms of the interleaved coefficient halves."""
    tw = _tw_on(data.device)
    k = tw["fftorder"][:64]
    tr, ti = tw["pre2_r"], tw["pre2_i"]
    d1a, d1b = data.index_select(-1, k), data.index_select(-1, 254 - k)
    d2a, d2b = data.index_select(-1, k + 1), data.index_select(-1, 255 - k)
    b1r, b1i = _ifft64(ti * d1b + tr * d1a, tr * d1b - ti * d1a)
    b2r, b2i = _ifft64(ti * d2b + tr * d2a, tr * d2b - ti * d2a)

    t_r, t_i = tw["post2_r"], tw["post2_i"]
    a_r = t_r * b1r[..., :32] + t_i * b1i[..., :32]
    a_i = t_i * b1r[..., :32] - t_r * b1i[..., :32]
    g1r, g1i = b1r[..., 32:].flip(-1), b1i[..., 32:].flip(-1)
    b_r = t_i * g1r + t_r * g1i
    b_i = t_r * g1r - t_i * g1i
    c_r = t_r * b2r[..., :32] + t_i * b2i[..., :32]
    c_i = t_i * b2r[..., :32] - t_r * b2i[..., :32]
    g2r, g2i = b2r[..., 32:].flip(-1), b2i[..., 32:].flip(-1)
    d_r = t_i * g2r + t_r * g2i
    d_i = t_r * g2r - t_i * g2i
    # i < 32: z[2i] = -a_r, z[2i+1] = -b_i, z[126-2i] = -b_r,
    # z[127-2i] = -a_i, z[128+2i] = a_i, z[129+2i] = b_r, z[254-2i] = b_i,
    # z[255-2i] = a_r; d[2i] = c_i, d[2i+1] = d_r, d[126-2i] = d_i,
    # d[127-2i] = c_r
    fl = lambda x: x.flip(-1)
    z = torch.cat([_interleave(-a_r, -b_i), _interleave(-fl(b_r), -fl(a_i)),
                   _interleave(a_i, b_r), _interleave(fl(b_i), fl(a_r))], -1)
    d = torch.cat([_interleave(c_i, d_r), _interleave(fl(d_i), fl(c_r))], -1)
    return z, d


def split_fb_exact_ref(coeffs, blksw=None):
    """Plain PyTorch version of split_fb_exact (any device)."""
    z_l, d_l = imdct512_z(coeffs)
    if blksw is None:
        return z_l, d_l
    z_s, d_s = imdct256_z(coeffs)
    blk = blksw[..., None]
    return torch.where(blk, z_s, z_l), torch.where(blk, d_s, d_l)


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
    from .filterbank import mats_on
    _, _, win, win_r = mats_on(coeffs.device)
    blksw = torch.as_tensor(blksw, dtype=torch.bool, device=coeffs.device)
    z, dnew = split_fb_exact(coeffs.contiguous(),
                             blksw.expand(coeffs.shape[:-1]).contiguous())
    dfold = torch.cat([delay, delay.flip(-1)], dim=-1)
    return z * win + dfold * win_r + bias[..., None], dnew


def _bind(lib):
    """argtypes of csrc/imdct_exact.cu's entries: B1 and B1F (the fused
    steady tail of ops.fused_steady_exact) share the library."""
    p, i = C.c_void_p, C.c_int
    lib.imdct_exact_launch.restype = C.c_int
    lib.imdct_exact_launch.argtypes = [p, p, p, p, p, p, C.c_longlong, p]
    lib.fused_steady_exact_launch.restype = C.c_int
    lib.fused_steady_exact_launch.argtypes = [p, p, p, p, p, p, p, p, p,
                                              i, i, i, i, p]
    lib.imdct_exact_error_string.restype = C.c_char_p
    lib.imdct_exact_error_string.argtypes = [C.c_int]


def split_fb_exact(coeffs, blksw=None):
    """coeffs [..., 256] float32, blksw [...] bool (the same leading
    shape; True = short block) or None (every row long)
    -> (z [..., 256], d [..., 128]) float32.

    Both inputs must be contiguous, on either device; a CUDA tensor
    launches the kernel (rows of 1 KB, 16-byte aligned), a CPU tensor
    runs split_fb_exact_ref."""
    global launches
    if coeffs.dtype != torch.float32:
        raise TypeError(f"coeffs is {coeffs.dtype}, expected torch.float32")
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
    if coeffs.device.type == "cpu":
        return split_fb_exact_ref(coeffs, blksw)
    if coeffs.device.type != "cuda":
        raise ValueError(f"split_fb_exact runs on cuda or cpu, not "
                         f"{coeffs.device}")
    if coeffs.data_ptr() % 16:
        raise ValueError("coeffs must be 16-byte aligned")
    dev = coeffs.device
    lead = coeffs.shape[:-1]
    z = torch.empty(lead + (256,), dtype=torch.float32, device=dev)
    d = torch.empty(lead + (128,), dtype=torch.float32, device=dev)
    rows = coeffs.numel() // 256
    if rows == 0:
        return z, d
    tw = _tw_on(dev)
    lib = _cuda.load("imdct_exact", _bind)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.imdct_exact_launch(
            coeffs.data_ptr(), None if blksw is None else blksw.data_ptr(),
            tw["packed"].data_ptr(), tw["order32"].data_ptr(),
            z.data_ptr(), d.data_ptr(), rows, stream)
    if rc != 0:
        raise RuntimeError("imdct_exact kernel launch failed: "
                           + lib.imdct_exact_error_string(rc).decode())
    launches += 1
    return z, d
