"""Parametric bit allocation (A/52 section 7.2.2), decoder half, on tensors.

The device twin of liba52's a52_bit_allocate (bit_allocate.c:124-265),
batched over any leading axes: band PSD integration, the leak/excitation
recursion over the 50 bands, the masking curve and mask -> bap.  Table
lookups (LATAB, BAPTAB) are indexed loads of small tensors built once
per device from ``tables``.

The encoder half is the rate model of the SNR-offset search: the grouped-
mantissa bit cost of a bap lattice (mantissa_bits), counted without the
lattice from the masking curve for one offset (bits_for_snro, the
encoder's form), or for many offsets from per-band exponent histograms
(exp_histogram + bits_for_offsets).  All three give the same counts.
"""
from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from . import tables as T


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


def _vbin(mask, snro, floor):
    """The masking threshold of every bin for one SNR offset:
    mask [..., 50] -> [..., 256] (0 past bin 252)."""
    masktab = _tables_on(mask.device)[2]
    v = torch.clamp(mask - snro - floor, min=0)
    v = (v & 0x1FE0) + floor
    vbin = v[..., masktab]                                # [..., 253]
    return torch.cat([vbin, torch.zeros(vbin.shape[:-1] + (3,),
                                        dtype=vbin.dtype,
                                        device=vbin.device)], dim=-1)


def bap_from_mask(psd, mask, snroffset, floor, start, end):
    """mask [..., 50] + psd [..., 256] -> bap [..., 256] int8.

    start/end [...] bound the live bins; bins outside get class 0."""
    baptab = _tables_on(psd.device)[1]
    address = torch.clamp((psd - _vbin(mask, snroffset, floor)) >> 5, 0, 63)
    bap = baptab[address]
    bins = torch.arange(256, dtype=torch.int32, device=psd.device)
    live = (bins >= start[..., None]) & (bins < end[..., None])
    return torch.where(live, bap, torch.zeros((), dtype=torch.int8,
                                              device=psd.device))


# ---------------------------------------------------------------------------
# encoder half: the rate model of the SNR-offset search
# ---------------------------------------------------------------------------

@lru_cache(maxsize=1)
def _class_bounds():
    """First address of each bap class k (BAPTAB is monotone)."""
    lo = np.zeros(16, np.int32)
    for k in range(1, 16):
        lo[k] = int(np.argmax(T.BAPTAB >= k))
    return lo


@lru_cache(maxsize=1)
def _band_layout():
    """Padded [50, 24] bin-index layout plus in-band position masks."""
    idx = np.zeros((50, 24), np.int64)
    valid = np.zeros((50, 24), bool)
    for b in range(50):
        sz = int(T.BNDSZ[b])
        start = int(T.BNDTAB[b])
        idx[b, :sz] = np.arange(start, start + sz)
        valid[b, :sz] = True
    return idx, valid


@lru_cache(maxsize=8)
def _rate_tables_on(device: torch.device):
    """(32 * first address of classes 1..15 [15], the [50, 24] band
    layout, its valid mask) as tensors on `device`."""
    idx, valid = _band_layout()
    return (torch.tensor(32 * _class_bounds()[1:], dtype=torch.int32,
                         device=device),
            torch.tensor(idx, device=device),
            torch.tensor(valid, device=device))


def _grouped_bits(nk):
    """Per-class counts [..., 15] (classes 1..15) -> mantissa bits [...]:
    classes 1, 2 and 4 pack three, three and two codes a group."""
    n1, n2, n3, n4 = nk[..., 0], nk[..., 1], nk[..., 2], nk[..., 3]
    bits = (5 * torch.div(n1 + 2, 3, rounding_mode="floor")
            + 7 * torch.div(n2 + 2, 3, rounding_mode="floor") + 3 * n3
            + 7 * torch.div(n4 + 1, 2, rounding_mode="floor"))
    for j, w in enumerate(T.BAP_BITS[5:16]):             # classes 5..15
        bits = bits + int(w) * nk[..., 4 + j]
    return bits


def mantissa_bits(bap, end):
    """Per-(batch)-block mantissa bit cost with grouped-class sharing.

    bap [..., C, 256]: C channels whose group counters share one block
    (ac3enc.cpp:764-810: the counters carry across channels within a
    block and reset per block).  end [..., C].  Returns bits [...]."""
    bins = torch.arange(256, dtype=torch.int32, device=bap.device)
    live = bins < end[..., None]
    nk = torch.stack([(live & (bap == cls)).sum(dim=(-1, -2),
                                                dtype=torch.int32)
                      for cls in range(1, 16)], dim=-1)
    return _grouped_bits(nk)


def bits_for_snro(psd, live, mask, snro, floor):
    """Grouped-mantissa bit cost for one (broadcastable) SNR offset,
    counted directly per bin.

    psd  [..., C, 256] int32 (3072 - 128*exp, zero past end)
    live [..., C, 256] bool
    mask [..., C, 50]
    snro broadcastable against mask's leading axes (e.g. [B, 1, 1, 1])
    -> bits [...] per block (summed over channels and bins; the grouped
    classes' ceilings taken after the channel sum).

    Exactly mantissa_bits(bap_from_mask(...)): a live bin's class is the
    number of class bounds its address reaches, and its address reaches
    bound k iff psd - vbin >= 32 * lo_k, so the per-class counts are 15
    compares a bin.  Dead bins are moved below every bound instead of
    masked."""
    t32 = _rate_tables_on(psd.device)[0]
    base = torch.where(live, psd - _vbin(mask, snro, floor),
                       torch.iinfo(torch.int32).min)
    ge = (base[..., None] >= t32).sum(dim=(-3, -2), dtype=torch.int32)
    nk = torch.cat([ge[..., :-1] - ge[..., 1:], ge[..., -1:]], dim=-1)
    return _grouped_bits(nk)


def exp_histogram(exp, ends):
    """exp [..., C, 256] int32 -> per-band exponent histogram
    H [..., C, 50, 25] float32 where H[..., b, e] = #coefficients of band
    b (below end) with exponent e."""
    _, idx, valid = _rate_tables_on(exp.device)
    e = exp[..., idx]                                   # [..., C, 50, 24]
    live = valid & (idx < ends[..., None, None])
    onehot = (e[..., None] == torch.arange(25, device=exp.device)) \
        & live[..., None]
    return onehot.sum(dim=-2).to(torch.float32)         # [..., C, 50, 25]


def bits_for_offsets(hist, mask, snro, floor):
    """Grouped-mantissa bit cost for many SNR offsets at once.

    hist: exp_histogram output [..., C, 50, 25] (float32)
    mask: [..., C, 50] (the snroffset-independent masking curve)
    snro: broadcastable against mask (e.g. candidates[:, None, None, None,
          None] for a leading axis)
    -> bits [S, ..., blocks...], as bits_for_snro.

    A coefficient with exponent e has address >= t iff psd - v >= 32t
    with psd = 3072 - 128e, so each bound's count is a compare-and-
    accumulate over the 25 exponent bins."""
    t32 = _rate_tables_on(mask.device)[0]
    v = torch.clamp(mask - snro - floor, min=0)
    v = (v & 0x1FE0) + floor                            # [S, ..., C, 50]
    base = (3072 - v)[..., None] - t32                  # [S, ..., C, 50, 15]
    ge = torch.zeros(v.shape[:-2] + (15,), dtype=torch.float32,
                     device=mask.device)
    for e in range(25):
        cmp = (base >= 128 * e).to(torch.float32)
        ge = ge + (hist[..., e, None] * cmp).sum(dim=(-3, -2))
    ge = ge.to(torch.int32)                             # [S, ..., 15]
    nk = torch.cat([ge[..., :-1] - ge[..., 1:], ge[..., -1:]], dim=-1)
    return _grouped_bits(nk)
