"""Host-side parametric bit allocation (ATSC A/52 §7.2.2), spec orientation.

One allocator serves both codec directions:

  * the decoder host pre-pass runs it to learn each mantissa's bap class
    (and therefore its bitstream field width) before unpacking, exactly as
    liba52 interleaves allocation with parsing
    (a52dec-0.7.5-cvs/liba52/bit_allocate.c:124-265 — note
    liba52 stores masking quantities flipped as 0xC00-spec; results are
    identical), and
  * the encoder rate-control search evaluates it per SNR-offset candidate
    (src/ac3enc/ac3enc.cpp:220-421 is the spec form).

A vectorized tensor twin lives in ops.alloc for the device path (the
raw-H2D unpack); the two are kept apart, one per side of the host link.
"""
from __future__ import annotations

import numpy as np

from .tables import (BAPTAB, BNDSZ, BNDTAB, HTH, LATAB, MASKTAB)


def _logadd(a: int, b: int) -> int:
    c = a - b
    adr = min(abs(c) >> 1, 255)
    return (a if c >= 0 else b) + int(LATAB[adr])


def _calc_lowcomp(a: int, b0: int, b1: int, binno: int) -> int:
    if binno < 7:
        if b0 + 256 == b1:
            return 384
        if b0 > b1:
            return max(a - 64, 0)
        return a
    if binno < 20:
        if b0 + 256 == b1:
            return 320
        if b0 > b1:
            return max(a - 64, 0)
        return a
    return max(a - 128, 0)


def bit_allocate(exp: np.ndarray, start: int, end: int, snroffset: int,
                 fgain: int, sdecay: int, fdecay: int, sgain: int,
                 dbknee: int, floor: int, fscod: int, halfratecod: int,
                 is_lfe: bool = False, cplfleak: int = 0, cplsleak: int = 0,
                 deltba: np.ndarray | None = None) -> np.ndarray:
    """Returns bap[256] (int8), zeros outside [start, end).

    exp: decoded exponents (uint8, 0..24).  For the coupling channel pass
    start=cplstrtmant > 0 and the leak init codes; for LFE pass is_lfe.
    deltba: dense per-band delta array (50,) with parsed values in
    {-4..-1, 1..4} (zeros when delta bit allocation is off).
    """
    bap = np.zeros(256, dtype=np.int8)
    if end <= start:
        return bap
    psd = np.zeros(256, dtype=np.int64)
    e = exp.astype(np.int64)
    psd[start:end] = 3072 - (e[start:end] << 7)

    # --- PSD integration: sequential log-add within each band -------------
    bndstrt = int(MASKTAB[start])
    bndend = int(MASKTAB[end - 1]) + 1
    bndpsd = np.zeros(50, dtype=np.int64)
    j = start
    for k in range(bndstrt, bndend):
        v = int(psd[j])
        j += 1
        lim = min(int(BNDTAB[k + 1]), end)
        while j < lim:
            v = _logadd(v, int(psd[j]))
            j += 1
        bndpsd[k] = v

    # --- excitation function ----------------------------------------------
    excite = np.zeros(50, dtype=np.int64)
    if bndstrt == 0:
        lowcomp = _calc_lowcomp(0, int(bndpsd[0]), int(bndpsd[1]), 0)
        excite[0] = bndpsd[0] - fgain - lowcomp
        lowcomp = _calc_lowcomp(lowcomp, int(bndpsd[1]), int(bndpsd[2]), 1)
        excite[1] = bndpsd[1] - fgain - lowcomp
        begin = 7
        fastleak = slowleak = 0
        for b in range(2, 7):
            if not (is_lfe and b == 6):
                lowcomp = _calc_lowcomp(lowcomp, int(bndpsd[b]),
                                        int(bndpsd[b + 1]), b)
            fastleak = int(bndpsd[b]) - fgain
            slowleak = int(bndpsd[b]) - sgain
            excite[b] = fastleak - lowcomp
            if not (is_lfe and b == 6):
                if bndpsd[b] <= bndpsd[b + 1]:
                    begin = b + 1
                    break
        for b in range(begin, min(bndend, 22)):
            if not (is_lfe and b == 6):
                lowcomp = _calc_lowcomp(lowcomp, int(bndpsd[b]),
                                        int(bndpsd[b + 1]), b)
            fastleak = max(fastleak - fdecay, int(bndpsd[b]) - fgain)
            slowleak = max(slowleak - sdecay, int(bndpsd[b]) - sgain)
            excite[b] = max(fastleak - lowcomp, slowleak)
        begin = 22
    else:
        begin = bndstrt
        fastleak = (cplfleak << 8) + 768
        slowleak = (cplsleak << 8) + 768

    for b in range(begin, bndend):
        fastleak = max(fastleak - fdecay, int(bndpsd[b]) - fgain)
        slowleak = max(slowleak - sdecay, int(bndpsd[b]) - sgain)
        excite[b] = max(fastleak, slowleak)

    # --- masking curve ------------------------------------------------------
    mask = np.zeros(50, dtype=np.int64)
    for b in range(bndstrt, bndend):
        v1 = int(excite[b])
        tmp = dbknee - int(bndpsd[b])
        if tmp > 0:
            v1 += tmp >> 2
        mask[b] = max(v1, int(HTH[b >> halfratecod][fscod]))

    if deltba is not None:
        mask[:len(deltba)] += (np.asarray(deltba, dtype=np.int64) << 7)

    # --- bap mapping ---------------------------------------------------------
    i = start
    for k in range(bndstrt, bndend):
        v = int(mask[k]) - snroffset - floor
        if v < 0:
            v = 0
        v = (v & 0x1FE0) + floor
        lim = min(int(BNDTAB[k]) + int(BNDSZ[k]), end)
        while i < lim:
            address = (int(psd[i]) - v) >> 5
            address = min(max(address, 0), 63)
            bap[i] = BAPTAB[address]
            i += 1
    return bap


def decode_side_params(bai: int, halfratecod: int):
    """Unpack the decoder's 11-bit bai word into spec-form parameters.

    Field layout per liba52 parse (bit_allocate.c:143-154): the 11 bits are
    sdcycod[2] fdcycod[2] sgaincod[2] dbpbcod[2] floorcod[3], packed MSB
    first into state->bai, so floorcod = bai & 7, etc.
    """
    from .tables import (DBKNEETAB, FDECAYTAB, FGAINTAB, FLOORTAB,
                          SDECAYTAB, SGAINTAB)
    sdcycod = (bai >> 9) & 3
    fdcycod = (bai >> 7) & 3
    sgaincod = (bai >> 5) & 3
    dbpbcod = (bai >> 3) & 3
    floorcod = bai & 7
    return dict(
        sdecay=int(SDECAYTAB[sdcycod]) >> halfratecod,
        fdecay=int(FDECAYTAB[fdcycod]) >> halfratecod,
        sgain=int(SGAINTAB[sgaincod]),
        dbknee=int(DBKNEETAB[dbpbcod]),
        floor=int(FLOORTAB[floorcod]),
    )


def decode_snroffset(csnroffst: int, fsnroffst: int) -> int:
    """Spec snroffset from the decoder's coarse/fine codes."""
    return (((csnroffst - 15) << 4) + fsnroffst) << 2
