"""The encoder's masking curve, SNR-offset search and bap, E1.

``snr_search(enc_exp, avail, nb, is_lfe, hth, halfratecod)`` is what the
encoder's frame core computes between the coded exponents and the
quantizer: the snroffset-independent masking curve (A/52 7.2.2: band psd,
excitation, masking curve), the reference's SNR-offset walk
(ac3enc.cpp:918-975) replayed by a binary search over the monotone bit
cost, then the bap at the chosen offset.

    enc_exp uint8 [N, 6, ch, 256]  the coded exponents (any byte past nb)
    avail   int32 [N]              the frame's bits left for mantissas
    nb      int32 [ch]             live bins of each channel (223, LFE 7)
    is_lfe  bool  [ch]             the LFE channel (band 6 keeps lowcomp)
    hth     int32 [50]             the hearing threshold of the sample rate
    halfratecod int (0, 1 or 2)    shifts the curve's decays (fdecay,
                                   sdecay) right; the encoder's other
                                   constants are fixed (FGAIN ... FLOOR)
    ->      (M int32 [N]: the largest coarse offset whose fine offset 0
             fits, -1 if none; fstar int32 [N]: the largest fitting fine
             offset at M; bap int8 [N, 6, ch, 256] at that offset)

On CUDA tensors it launches the hand-written kernel E1
(csrc/snr_search.cu), once a call: one CTA a row makes the curve in shared
memory and runs all 12 candidates and the bap on chip.  On CPU tensors it
runs ``mask_search_ref``, the plain version: ``masking`` (ops.alloc's
band_psd, excitation and masking_curve) then ``snr_search_ref`` (7 + 5
calls of ops.alloc.bits_for_snro, each a [N, 6, ch, 256, 15] compare, then
ops.alloc.bap_from_mask).  There is no other path.  The JAX package
computes the same function as XLA inside its frame core
(ac3acm_tpu/models/encoder.py:386-451, with ops/alloc.py:81 band_psd,
:120 excitation, :202 masking_curve, :213 bap_from_mask and :285
bits_for_snro), with no pallas_call.

Bound on the card: bytes (a live bin's exponent read once and its class
written once, a byte each); the kernel's header (csrc/snr_search.cu) says
what its design does about the 12 data-dependent candidates.
"""
from __future__ import annotations

import ctypes as C
from functools import lru_cache

import numpy as np
import torch

from .. import tables as T
from . import _cuda
from . import alloc as AL

# the encoder's curve constants (ac3enc.cpp: fgaincod 4, sgaincod 1,
# fdcycod 1, sdcycod 2, dbpbcod 2, floorcod 4); the decays are shifted
# right by halfratecod
FGAIN, SGAIN = int(T.FGAINTAB[4]), int(T.SGAINTAB[1])
FDECAY, SDECAY = int(T.FDECAYTAB[1]), int(T.SDECAYTAB[2])
DBKNEE, FLOOR = int(T.DBKNEETAB[2]), int(T.FLOORTAB[4])

# E1 launches since the last reset (only where the CUDA kernel is
# launched; the CPU path leaves it alone)
launches_snr_search = 0


def _snro(c, f):
    return (((c - 15) << 4) + f) << 2


def masking(enc_exp, nb, is_lfe, hth, halfratecod):
    """The snroffset-independent masking curve of the coded exponents:
    -> (psd int32 [N, 6, ch, 256], 0 past nb; mask int32 [N, 6, ch, 50])."""
    lead = enc_exp.shape[:3]
    live = torch.arange(256, dtype=torch.int32,
                        device=enc_exp.device) < nb[:, None]
    psd = torch.where(live, 3072 - (enc_exp.to(torch.int32) << 7), 0)
    bnd = AL.band_psd(psd, nb.expand(lead))
    exc = AL.excitation(bnd, FGAIN, SGAIN, FDECAY >> halfratecod,
                        SDECAY >> halfratecod, is_lfe.expand(lead))
    return psd, AL.masking_curve(bnd, exc, DBKNEE, hth)


def snr_search_ref(psd, mask, avail, nb):
    """The plain search and bap on a masking curve (any device).

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


def mask_search_ref(enc_exp, avail, nb, is_lfe, hth, halfratecod):
    """Plain version of snr_search (any device): masking, then
    snr_search_ref."""
    psd, mask = masking(enc_exp, nb, is_lfe, hth, halfratecod)
    return snr_search_ref(psd, mask, avail, nb)


@lru_cache(maxsize=1)
def _kernel_tables_np():
    """csrc/snr_search.cu's table, int32 [690]: the threshold entry of each
    bin (its band, 50 past bin 252), the class of each address (BAPTAB),
    each address's cost word lin | n1 << 10 | n2 << 16 | n4 << 22 (lin: the
    bits a bin of the class costs on its own, as ops.alloc._grouped_bits
    prices it; n1, n2, n4: 1 for the grouped classes 1, 2 and 4), LATAB's
    first 256 entries, and each band's first bin | size << 16."""
    band = np.full(256, 50, np.int64)
    band[:253] = T.MASKTAB[:253]
    cls = np.asarray(T.BAPTAB[:64], np.int64)
    assert cls[0] == 0, "a dead bin's address 0 must cost nothing"
    lin = np.where(cls == 3, 3, np.where(cls >= 5, T.BAP_BITS[cls], 0))
    # a lane sums at most 48 bins (8 a channel): its fields must not carry
    assert 48 * lin.max() < 1 << 10 and 48 < 1 << 6
    cost = (lin | (cls == 1).astype(np.int64) << 10
            | (cls == 2).astype(np.int64) << 16
            | (cls == 4).astype(np.int64) << 22)
    latab = np.asarray(T.LATAB[:256], np.int64)
    bands = (np.asarray(T.BNDTAB[:50], np.int64)
             | np.asarray(T.BNDSZ[:50], np.int64) << 16)
    return np.concatenate([band, cls, cost, latab, bands]).astype(np.int32)


@lru_cache(maxsize=8)
def _kernel_tables(device: torch.device):
    return torch.from_numpy(_kernel_tables_np()).to(device)


def _bind(lib):
    p, i = C.c_void_p, C.c_int
    lib.snr_search_launch.restype = i
    lib.snr_search_launch.argtypes = [p, p, p, p, p, p, i, i, i, i, i, i,
                                      p, p, p, C.c_longlong, i, p]
    lib.snr_search_table_size.restype = i
    lib.snr_search_error_string.restype = C.c_char_p
    lib.snr_search_error_string.argtypes = [i]


def _check(enc_exp, avail, nb, is_lfe, hth, halfratecod):
    """The kernel's contract, on both devices: -> (N, ch)."""
    dev = enc_exp.device
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"snr_search runs on cuda or cpu, not {dev}")
    named = (("enc_exp", enc_exp, torch.uint8), ("avail", avail, torch.int32),
             ("nb", nb, torch.int32), ("is_lfe", is_lfe, torch.bool),
             ("hth", hth, torch.int32))
    for name, t, dtype in named:
        if t.dtype != dtype:
            raise TypeError(f"{name} is {t.dtype}, expected {dtype}")
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, enc_exp on {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if (enc_exp.dim() != 4 or enc_exp.shape[1] != 6
            or enc_exp.shape[3] != 256):
        raise ValueError(f"enc_exp has shape {tuple(enc_exp.shape)}, "
                         f"expected [N, 6, ch, 256]")
    N, ch = enc_exp.shape[0], enc_exp.shape[2]
    if not 1 <= ch <= 6:
        raise ValueError(f"enc_exp has {ch} channels, expected 1..6")
    for name, t, shape in (("avail", avail, (N,)), ("nb", nb, (ch,)),
                           ("is_lfe", is_lfe, (ch,)), ("hth", hth, (50,))):
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, "
                             f"expected {shape}")
    if enc_exp.data_ptr() % 16:
        raise ValueError("enc_exp must be 16-byte aligned")
    if halfratecod not in (0, 1, 2):
        raise ValueError(f"halfratecod is {halfratecod!r}, expected 0, 1 "
                         f"or 2")
    return N, ch


def _lib():
    lib = _cuda.load("snr_search", _bind)
    if lib.snr_search_table_size() != _kernel_tables_np().size:
        raise RuntimeError("csrc/snr_search.cu's table size differs from "
                           "_kernel_tables'")
    return lib


def snr_search(enc_exp, avail, nb, is_lfe, hth, halfratecod):
    """The masking curve, SNR-offset search and bap (see the module
    docstring): every tensor contiguous and on one device, enc_exp 16-byte
    aligned; CUDA tensors launch E1 once, CPU ones run mask_search_ref."""
    global launches_snr_search
    N, ch = _check(enc_exp, avail, nb, is_lfe, hth, halfratecod)
    dev = enc_exp.device
    if dev.type == "cpu":
        return mask_search_ref(enc_exp, avail, nb, is_lfe, hth, halfratecod)
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
            enc_exp.data_ptr(), avail.data_ptr(), nb.data_ptr(),
            is_lfe.data_ptr(), hth.data_ptr(), tabs.data_ptr(), FGAIN,
            SGAIN, FDECAY >> halfratecod, SDECAY >> halfratecod, DBKNEE,
            FLOOR, M.data_ptr(), fstar.data_ptr(), bap.data_ptr(), N, ch,
            stream)
    if rc != 0:
        raise RuntimeError("snr_search (E1) kernel launch failed: "
                           + lib.snr_search_error_string(rc).decode())
    launches_snr_search += 1
    return M, fstar, bap
