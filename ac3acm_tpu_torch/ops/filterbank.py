"""IMDCT filterbank as one matrix product + windowed overlap-add.

The full 512/256-pt IMDCT (pre-twiddle, split-radix IFFT, post-twiddle) is
a linear map of the 256 coefficients, so the fast decode is

    [R, 256] @ [256, 384]  ->  z [R, 256] ++ new_delay [R, 128]

batched over lanes*blocks*channels, followed by the elementwise KBD
window / overlap-add / bias epilogue.  Matches liba52 a52_imdct_512/256
(imdct.c:258-345) to float32 rounding of the dot products.
"""
from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from .. import tables as T

# The library's TF32 switch stays off: every torch.matmul of the port runs
# in full FP32, because ONE TF32 pass (11 significant bits on each operand)
# moves the PCM by several int16 LSB and the fast-mode contract allows one.
# The fused steady kernel (csrc/fused_steady.cu) does use the tensor cores,
# but as THREE TF32 passes over a hi/lo split of both operands (split_tf32
# below), which keeps 22 significant bits and lands where the FP32 product
# lands; tests/test_torch_fused_steady.py holds both statements.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


@lru_cache(maxsize=1)
def _mats():
    """(w_long [256, 384], w_short [256, 384], win [256]) as float32 numpy,
    bitwise equal to the JAX package's constants."""
    z512, d512 = T.imdct512_matrices()
    z256, d256 = T.imdct256_matrices()
    w_long = np.concatenate([z512, d512], axis=1).astype(np.float32)
    w_short = np.concatenate([z256, d256], axis=1).astype(np.float32)
    win = T.kbd_window().astype(np.float32)
    return w_long, w_short, win


_DEV_MATS = {}


def mats_on(device) -> tuple:
    """_mats() as tensors on `device` (w_long, w_short, win, win reversed),
    made once per device."""
    device = torch.device(device)
    key = str(device)
    if key not in _DEV_MATS:
        w_long, w_short, win = _mats()
        _DEV_MATS[key] = tuple(
            torch.from_numpy(np.ascontiguousarray(a)).to(device)
            for a in (w_long, w_short, win, win[::-1]))
    return _DEV_MATS[key]


def split_tf32(x: torch.Tensor) -> tuple:
    """x (float32) -> (hi, lo), both exactly representable in TF32 (low 13
    mantissa bits clear) with |x - hi - lo| <= 2^-21 |x|.

    hi is x rounded to TF32's 10 mantissa bits, to nearest with ties away
    from zero (what cvt.rna.tf32.f32 does on the card: add half a TF32 ulp
    to the magnitude, clear the low bits); x - hi is exact in FP32 and is
    rounded the same way.  The tensor cores would truncate an unrounded
    operand, so the split is made explicitly, here for W and in the kernel
    for freq."""
    def rna(v):
        bits = v.contiguous().view(torch.int32)
        return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)

    hi = rna(x)
    return hi, rna(x - hi)


@lru_cache(maxsize=1)
def wt_split() -> tuple:
    """(Wt_hi, Wt_lo): w_long transposed to [384, 256] (K contiguous, the
    operand form the tensor cores take for TF32) and split with split_tf32,
    on the CPU.  The kernel reads them as wt_tiles_on lays them out."""
    wt = torch.from_numpy(np.ascontiguousarray(_mats()[0].T))
    return tuple(a.contiguous() for a in split_tf32(wt))


def wt_tiles_on(device) -> torch.Tensor:
    """The fused steady kernel's B operand: [32, 2, 384, 8] float32 on
    `device`, made once.  Tile [s, m] is columns [8s, 8s + 8) of Wt_hi
    (m = 0) or Wt_lo (m = 1), all 384 rows, as the kernel's shared memory
    holds it (K-major rows of 32 bytes, 32-byte swizzle: the two 16-byte
    halves of rows 4..7 of every 8 swapped), so that a K step is one
    contiguous 24,576-byte copy."""
    device = torch.device(device)
    key = (str(device), "wt_tiles")
    if key not in _DEV_MATS:
        wt = torch.stack(wt_split())                          # [2, 384, 256]
        t = wt.view(2, 384, 32, 2, 4).permute(2, 0, 1, 3, 4)  # [32,2,384,2,4]
        swap = ((torch.arange(384) >> 2) & 1).bool()
        t = torch.where(swap[None, None, :, None, None], t.flip(3), t)
        _DEV_MATS[key] = t.reshape(32, 2, 384, 8).contiguous().to(device)
    return _DEV_MATS[key]


def filterbank(coeffs, delay, blksw, bias):
    """coeffs [..., 256], delay [..., 128], blksw [...] bool, bias [...]
    -> (out [..., 256], new_delay [..., 128]).

    blksw selects the short (256-pt) transform per row.  bias broadcasts.
    """
    w_long, w_short, win, win_r = mats_on(coeffs.device)
    # two masked products keep total FLOPs equal to one unmasked pass
    blk = blksw[..., None]
    c_long = torch.where(blk, 0.0, coeffs)
    c_short = torch.where(blk, coeffs, 0.0)
    zd = torch.matmul(c_long, w_long) + torch.matmul(c_short, w_short)
    z, dnew = zd[..., :256], zd[..., 256:]
    dfold = torch.cat([delay, delay.flip(-1)], dim=-1)
    out = z * win + dfold * win_r + bias[..., None]
    return out, dnew


def convert_to_int16(biased: torch.Tensor, bias: float = 384.0):
    """Planar biased float -> int16 (AC3ASM.asm clip1 semantics).

    (x - 384) * 32768 is exact on the 2^-15 grid the bias quantizes to;
    torch.round is round-half-to-even like jnp.round.
    """
    x = (biased - bias) * 32768.0
    return torch.clamp(torch.round(x), -32768.0, 32767.0).to(torch.int16)
