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

# FP32 products on the card run in full FP32: the fast-mode contract
# (<= 1 int16 LSB) leaves no room for TF32's 10-bit mantissa.
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
