"""Parametric bit allocation (A/52 section 7.2.2), decoder half, on tensors.

The device twin of liba52's a52_bit_allocate (bit_allocate.c:124-265),
batched over any leading axes: band PSD integration, the leak/excitation
recursion over the 50 bands, the masking curve and mask -> bap.  Table
lookups (LATAB, BAPTAB) are indexed loads of small tensors built once
per device from ``tables``.  The encoder half (mantissa_bits and the
rate-search helpers) is not ported yet.
"""
from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from .. import tables as T


@lru_cache(maxsize=1)
def _size_runs():
    """Contiguous runs of equal band size: (nbands, size, first_bin) --
    the A/52 band structure is 28x1, 7x3, 6x6, 4x12, 5x24."""
    runs = []
    b = 0
    while b < 50:
        sz = int(T.BNDSZ[b])
        lo = b
        while b < 50 and int(T.BNDSZ[b]) == sz:
            b += 1
        runs.append((b - lo, sz, int(T.BNDTAB[lo])))
    return tuple(runs)


@lru_cache(maxsize=8)
def _tables_on(device: torch.device):
    """(LATAB[:256], BAPTAB[:64], MASKTAB) as device tensors."""
    return (torch.tensor(np.asarray(T.LATAB[:256]), dtype=torch.int32,
                         device=device),
            torch.tensor(np.asarray(T.BAPTAB[:64]), dtype=torch.int8,
                         device=device),
            torch.tensor(np.asarray(T.MASKTAB[:253]), dtype=torch.int64,
                         device=device))


def band_psd(psd, end):
    """psd [..., 256] int32 -> bndpsd [..., 50] int32 (log-add fold).

    `end` [...]: first excluded bin (bins >= end are ignored).  Each size
    class of bands folds its bins in reference order."""
    latab = _tables_on(psd.device)[0]
    out = []
    for nb_, sz, bin0 in _size_runs():
        p = psd[..., bin0: bin0 + nb_ * sz]
        p = p.reshape(p.shape[:-1] + (nb_, sz))          # [..., nb, sz]
        v = p[..., 0]
        if sz > 1:
            idx = torch.arange(bin0, bin0 + nb_ * sz, dtype=torch.int32,
                               device=psd.device).reshape(nb_, sz)
            ok = idx < end[..., None, None]
            for k in range(1, sz):
                nxt = p[..., k]
                c = v - nxt
                la = latab[torch.clamp(c.abs() >> 1, max=255)]
                fold = torch.where(c >= 0, v + la, nxt + la)
                v = torch.where(ok[..., k], fold, v)
        out.append(v)
    return torch.cat(out, dim=-1)


def _calc_lowcomp(a, b0, b1, binno):
    """liba52 calc_lowcomp for one band, vectorized over the batch."""
    up256 = (b0 + 256) == b1
    dec = torch.clamp(a - 64, min=0)
    if binno < 7:
        return torch.where(up256, 384, torch.where(b0 > b1, dec, a))
    if binno < 20:
        return torch.where(up256, 320, torch.where(b0 > b1, dec, a))
    return torch.clamp(a - 128, min=0)


def excitation(bndpsd, fgain, sgain, fdecay, sdecay, is_lfe,
               bndstrt=None, cplfleak=None, cplsleak=None):
    """bndpsd [..., 50] -> excite [..., 50].

    fgain [...]; sgain/fdecay/sdecay broadcast against it; is_lfe a bool
    tensor broadcasting likewise.  When bndstrt is given (the coupling
    channel) the startup region is skipped and the leaks start from the
    coupling leak-init codes."""
    shp = bndpsd.shape[:-1]
    dev = bndpsd.device
    nxt = torch.cat([bndpsd[..., 1:], bndpsd[..., -1:]], dim=-1)
    coupled = bndstrt is not None
    if coupled:
        fast = (cplfleak << 8) + 768
        slow = (cplsleak << 8) + 768
    else:
        fast = torch.zeros(shp, dtype=torch.int32, device=dev)
        slow = torch.zeros(shp, dtype=torch.int32, device=dev)
    lowcomp = torch.zeros(shp, dtype=torch.int32, device=dev)
    startup = torch.ones(shp, dtype=torch.bool, device=dev)
    excs = []
    for b in range(50):
        bp = bndpsd[..., b]
        bn = nxt[..., b]
        if coupled:
            in_region = b >= bndstrt
            fast = torch.where(in_region,
                               torch.maximum(fast - fdecay, bp - fgain), fast)
            slow = torch.where(in_region,
                               torch.maximum(slow - sdecay, bp - sgain), slow)
            excs.append(torch.where(in_region, torch.maximum(fast, slow), 0))
            continue

        # full-bandwidth (and LFE) channel: startup bins, then leak region
        if b == 6:
            lc_new = torch.where(is_lfe, lowcomp,
                                 _calc_lowcomp(lowcomp, bp, bn, b))
        elif b < 22:
            lc_new = _calc_lowcomp(lowcomp, bp, bn, b)
        else:
            lc_new = lowcomp                 # unused past band 21
        lowcomp = lc_new
        if b < 2:
            excs.append(bp - fgain - lc_new)
            continue
        fresh_fast = bp - fgain
        fresh_slow = bp - sgain
        dec_fast = torch.maximum(fast - fdecay, bp - fgain)
        dec_slow = torch.maximum(slow - sdecay, bp - sgain)
        if b < 22:
            exc_leak = torch.maximum(dec_fast - lc_new, dec_slow)
        else:
            exc_leak = torch.maximum(dec_fast, dec_slow)
        if b < 7:
            leave = (bp <= bn) if b != 6 else (~is_lfe & (bp <= bn))
            excs.append(torch.where(startup, fresh_fast - lc_new, exc_leak))
            fast = torch.where(startup, fresh_fast, dec_fast)
            slow = torch.where(startup, fresh_slow, dec_slow)
            startup = startup & ~(startup & leave) & (b < 6)
        else:
            excs.append(exc_leak)
            fast, slow = dec_fast, dec_slow
    return torch.stack(excs, dim=-1)


def masking_curve(bndpsd, excite, dbknee, hth_row, deltba=None):
    """excite -> mask [..., 50].  hth_row [..., 50] already resolved for
    fscod/halfrate; deltba [..., 50] in {-4..4} (0 = none)."""
    tmp = dbknee - bndpsd
    v1 = excite + torch.where(tmp > 0, tmp >> 2, 0)
    mask = torch.maximum(v1, hth_row)
    if deltba is not None:
        mask = mask + deltba.to(torch.int32) * 128
    return mask


def bap_from_mask(psd, mask, snroffset, floor, start, end):
    """mask [..., 50] + psd [..., 256] -> bap [..., 256] int8.

    start/end [...] bound the live bins; bins outside get class 0."""
    _, baptab, masktab = _tables_on(psd.device)
    v = mask - snroffset - floor
    v = torch.clamp(v, min=0)
    v = (v & 0x1FE0) + floor
    vbin = v[..., masktab]                                # [..., 253]
    vbin = torch.cat([vbin, torch.zeros(vbin.shape[:-1] + (3,),
                                        dtype=vbin.dtype,
                                        device=vbin.device)], dim=-1)
    address = torch.clamp((psd - vbin) >> 5, 0, 63)
    bap = baptab[address]
    bins = torch.arange(256, dtype=torch.int32, device=psd.device)
    live = (bins >= start[..., None]) & (bins < end[..., None])
    return torch.where(live, bap, torch.zeros((), dtype=torch.int8,
                                              device=psd.device))
