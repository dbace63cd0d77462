"""The encoder's SNR-offset search and its bap, E1.

``snr_search(psd, mask, avail, nb)`` is what the encoder's frame core
computes between the masking curve and the quantizer: the reference's
SNR-offset walk (ac3enc.cpp:918-975) replayed by a binary search over the
monotone bit cost, then the bap at the chosen offset.

    psd    int32 [N, 6, ch, 256]  3072 - 128 * exponent, 0 past nb
    mask   int32 [N, 6, ch, 50]   the snroffset-independent masking curve
    avail  int32 [N]              the frame's bits left for mantissas
    nb     int32 [ch]             live bins of each channel (223, LFE 7)
    ->     (M int32 [N]: the largest coarse offset whose fine offset 0
            fits, -1 if none; fstar int32 [N]: the largest fitting fine
            offset at M; bap int8 [N, 6, ch, 256] at that offset)

On CUDA tensors it launches the hand-written kernel E1
(csrc/snr_search.cu), once a call: one CTA a row runs all 12 candidates
and the bap on chip.  On CPU tensors it runs ``snr_search_ref``, the plain
version: 7 + 5 calls of ops.alloc.bits_for_snro, each a [N, 6, ch, 256,
15] compare, then ops.alloc.bap_from_mask.  There is no other path.  The
JAX package computes the same function as XLA inside its frame core
(ac3acm_tpu/models/encoder.py:398-451, with ops/alloc.py:213
bap_from_mask and :285 bits_for_snro), with no pallas_call.

Bound on the card: bytes (each live bin's exponent read once as a byte,
the curve as int16, the bap written once as a byte); the kernel's header
(csrc/snr_search.cu) says what its design does about the 12
data-dependent candidates.
"""
from __future__ import annotations

import ctypes as C
from functools import lru_cache

import numpy as np
import torch

from .. import tables as T
from . import _cuda
from . import alloc as AL

# the encoder's floor code (ac3enc.cpp: floorcod 4)
FLOOR = int(T.FLOORTAB[4])

# E1 launches since the last reset (only where the CUDA kernel is
# launched; the CPU path leaves it alone)
launches_snr_search = 0


def _snro(c, f):
    return (((c - 15) << 4) + f) << 2


def snr_search_ref(psd, mask, avail, nb):
    """Plain version of snr_search (any device).

    The bit cost is monotone in snroffset, so the reference's down/up-4/
    up-1 hill climb lands at M whenever its down pass finds a fit, and the
    fine pass at max{f : fits(M, f)}: 7 + 5 single-offset cost
    evaluations."""
    dev = psd.device
    N = psd.shape[0]
    live = torch.arange(256, dtype=torch.int32, device=dev) < nb[:, None]

    def fits(c, f):
        bits = AL.bits_for_snro(psd, live, mask,
                                _snro(c, f)[:, None, None, None],
                                FLOOR).sum(dim=-1, dtype=torch.int32)
        return avail - bits >= 0

    lo = torch.full((N,), -1, dtype=torch.int32, device=dev)
    hi = torch.full((N,), 63, dtype=torch.int32, device=dev)
    zero = torch.zeros_like(lo)
    for _ in range(7):                    # ceil(log2(65))
        mid = (lo + hi + 1) >> 1
        ok = fits(mid, zero)
        lo = torch.where(ok, mid, lo)
        hi = torch.where(ok, hi, mid - 1)
    flo = torch.full((N,), -1, dtype=torch.int32, device=dev)
    fhi = torch.full((N,), 15, dtype=torch.int32, device=dev)
    for _ in range(5):                    # ceil(log2(17))
        fmid = (flo + fhi + 1) >> 1
        ok = fits(lo, fmid)
        flo = torch.where(ok, fmid, flo)
        fhi = torch.where(ok, fhi, fmid - 1)
    fstar = torch.clamp(flo, min=0)
    ends = nb.expand(psd.shape[:3])
    bap = AL.bap_from_mask(psd, mask, _snro(lo, fstar)[:, None, None, None],
                           FLOOR, torch.zeros_like(ends), ends)
    return lo, fstar, bap


@lru_cache(maxsize=1)
def _kernel_tables_np():
    """csrc/snr_search.cu's table, int32 [448]: the band of each bin (0
    past bin 252), the class of each address (BAPTAB), and each address's
    cost words lin | n1 << 16 and n2 | n4 << 16 (lin: the bits a bin of
    the class costs on its own, as ops.alloc._grouped_bits prices it; n1,
    n2, n4: 1 for the grouped classes 1, 2 and 4)."""
    band = np.zeros(256, np.int64)
    band[:253] = T.MASKTAB[:253]
    cls = np.asarray(T.BAPTAB[:64], np.int64)
    assert cls[0] == 0, "a dead bin's address 0 must cost nothing"
    lin = np.where(cls == 3, 3, np.where(cls >= 5, T.BAP_BITS[cls], 0))
    lo = lin | (cls == 1).astype(np.int64) << 16
    hi = (cls == 2).astype(np.int64) | (cls == 4).astype(np.int64) << 16
    return np.concatenate([band, cls, lo, hi]).astype(np.int32)


@lru_cache(maxsize=8)
def _kernel_tables(device: torch.device):
    return torch.from_numpy(_kernel_tables_np()).to(device)


def _bind(lib):
    p = C.c_void_p
    lib.snr_search_launch.restype = C.c_int
    lib.snr_search_launch.argtypes = [p, p, p, p, p, C.c_int, p, p, p,
                                      C.c_longlong, C.c_int, p]
    lib.snr_search_table_size.restype = C.c_int
    lib.snr_search_error_string.restype = C.c_char_p
    lib.snr_search_error_string.argtypes = [C.c_int]


def _check(psd, mask, avail, nb):
    """The kernel's contract, on both devices: -> (N, ch)."""
    dev = psd.device
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"snr_search runs on cuda or cpu, not {dev}")
    named = (("psd", psd), ("mask", mask), ("avail", avail), ("nb", nb))
    for name, t in named:
        if t.dtype != torch.int32:
            raise TypeError(f"{name} is {t.dtype}, expected torch.int32")
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, psd on {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if psd.dim() != 4 or psd.shape[1] != 6 or psd.shape[3] != 256:
        raise ValueError(f"psd has shape {tuple(psd.shape)}, expected "
                         f"[N, 6, ch, 256]")
    N, ch = psd.shape[0], psd.shape[2]
    if not 1 <= ch <= 6:
        raise ValueError(f"psd has {ch} channels, expected 1..6")
    for name, t, shape in (("mask", mask, (N, 6, ch, 50)),
                           ("avail", avail, (N,)), ("nb", nb, (ch,))):
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, "
                             f"expected {shape}")
    for name, t in (("psd", psd), ("mask", mask)):
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")
    return N, ch


def _lib():
    lib = _cuda.load("snr_search", _bind)
    if lib.snr_search_table_size() != _kernel_tables_np().size:
        raise RuntimeError("csrc/snr_search.cu's table size differs from "
                           "_kernel_tables'")
    return lib


def snr_search(psd, mask, avail, nb):
    """The SNR-offset search and its bap (see the module docstring): every
    tensor int32, contiguous and on one device, psd and mask 16-byte
    aligned; CUDA tensors launch E1 once, CPU ones run snr_search_ref."""
    global launches_snr_search
    N, ch = _check(psd, mask, avail, nb)
    dev = psd.device
    if dev.type == "cpu":
        return snr_search_ref(psd, mask, avail, nb)
    M = torch.empty((N,), dtype=torch.int32, device=dev)
    fstar = torch.empty((N,), dtype=torch.int32, device=dev)
    bap = torch.empty((N, 6, ch, 256), dtype=torch.int8, device=dev)
    if N == 0:
        return M, fstar, bap
    lib = _lib()
    tabs = _kernel_tables(dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.snr_search_launch(
            psd.data_ptr(), mask.data_ptr(), avail.data_ptr(), nb.data_ptr(),
            tabs.data_ptr(), FLOOR, M.data_ptr(), fstar.data_ptr(),
            bap.data_ptr(), N, ch, stream)
    if rc != 0:
        raise RuntimeError("snr_search (E1) kernel launch failed: "
                           + lib.snr_search_error_string(rc).decode())
    launches_snr_search += 1
    return M, fstar, bap
