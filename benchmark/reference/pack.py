"""Host bit packing: AC-3 frame assembly + CRC back-patching.

Consumes the device encoder's dense outputs (bap, raw quantized mantissas,
encoded exponents, strategies, SNR offsets) and emits the serial frame:
header, six audio blocks (grouped-mantissa combining happens here, in
coefficient order across channels -- the only inherently serial part of the
encoder), zero fill, and the dual CRC with the polynomial-inverse trick for
the leading crc1 (behavioural parity: ac3enc.cpp:1113-1638).
"""
from __future__ import annotations

from functools import lru_cache

import numpy as np

from . import tables as T
from .bitio import BitWriter

CRC16_POLY = (1 << 0) | (1 << 2) | (1 << 15) | (1 << 16)


@lru_cache(maxsize=1)
def crc_table() -> np.ndarray:
    tab = np.zeros(256, np.uint32)
    for n in range(256):
        c = n << 8
        for _ in range(8):
            if c & (1 << 15):
                c = ((c << 1) & 0xFFFF) ^ (CRC16_POLY & 0xFFFF)
            else:
                c <<= 1
        tab[n] = c & 0xFFFF
    return tab


def ac3_crc(data: bytes, crc: int = 0) -> int:
    tab = crc_table()
    for byte in data:
        crc = (int(tab[byte ^ (crc >> 8)]) ^ ((crc << 8) & 0xFFFF)) & 0xFFFF
    return crc


def mul_poly(a: int, b: int, poly: int) -> int:
    c = 0
    while a:
        if a & 1:
            c ^= b
        a >>= 1
        b <<= 1
        if b & (1 << 16):
            b ^= poly
    return c


def pow_poly(a: int, n: int, poly: int) -> int:
    r = 1
    while n:
        if n & 1:
            r = mul_poly(r, a, poly)
        a = mul_poly(a, a, poly)
        n >>= 1
    return r


_GROUP_SIZE = {T.EXP_D15: 1, T.EXP_D25: 2, T.EXP_D45: 4}


def _write_exponents(bw: BitWriter, enc_exp: np.ndarray, nb_coefs: int,
                     strategy: int):
    gsize = _GROUP_SIZE[strategy]
    ngroups = (nb_coefs + gsize * 3 - 4) // (3 * gsize)
    bw.write(4, int(enc_exp[0]))
    prev = int(enc_exp[0])
    p = 1
    for _ in range(ngroups):
        d = []
        for _ in range(3):
            cur = int(enc_exp[p])
            d.append(cur - prev + 2)
            prev = cur
            p += gsize
        bw.write(7, (d[0] * 5 + d[1]) * 5 + d[2])


def pack_frame(cfg, res: dict, b: int) -> bytes:
    """Assemble one frame from device outputs (batch row b)."""
    bap = res["bap"][b]          # [6, ch, 256]
    qmant = res["qmant"][b].astype(np.int64)
    enc_exp = res["enc_exp"][b]
    strat = res["strat"][b]      # [6, ch]
    csnr = int(res["csnroffst"][b])
    fsnr = int(res["fsnroffst"][b])
    nf = cfg.nfchans
    nch = cfg.channels
    nb = cfg.nb_coefs
    lfe_ch = nf if cfg.lfe else -1

    bw = BitWriter()
    # ---- header (output_frame_header parity) ------------------------------
    bw.write(16, 0x0B77)
    bw.write(16, 0)                       # crc1 patched later
    bw.write(2, cfg.fscod)
    bw.write(6, cfg.frmsizecod)
    bw.write(5, 8 + cfg.halfratecod)      # bsid
    bw.write(3, 0)                        # bsmod
    bw.write(3, cfg.acmod)
    if (cfg.acmod & 1) and cfg.acmod != 1:
        bw.write(2, 1)                    # cmixlev -4.5 dB
    if cfg.acmod & 4:
        bw.write(2, 1)                    # surmixlev -6 dB
    if cfg.acmod == 2:
        bw.write(2, 0)                    # dsurmod not indicated
    bw.write(1, 1 if cfg.lfe else 0)
    bw.write(5, 31)                       # dialnorm -31 dB
    bw.write(1, 0)                        # compre
    bw.write(1, 0)                        # langcode
    bw.write(1, 0)                        # audprodie
    bw.write(1, 0)                        # copyrightb
    bw.write(1, 1)                        # origbs
    bw.write(1, 0)                        # timecod1e
    bw.write(1, 0)                        # timecod2e
    bw.write(1, 0)                        # addbsie

    for blk in range(6):
        for _ in range(nf):
            bw.write(1, 0)                # blksw: always 512-pt
        for _ in range(nf):
            bw.write(1, 1)                # dithflag on
        bw.write(1, 0)                    # dynrnge
        if blk == 0:
            bw.write(1, 1)                # cplstre
            bw.write(1, 0)                # cplinu off
        else:
            bw.write(1, 0)
        if cfg.acmod == 2:
            if blk == 0:
                bw.write(1, 1)            # rematstr
                for _ in range(4):
                    bw.write(1, 0)
            else:
                bw.write(1, 0)
        for ch in range(nf):
            bw.write(2, int(strat[blk, ch]))
        if cfg.lfe:
            bw.write(1, int(strat[blk, lfe_ch]))
        for ch in range(nf):
            if strat[blk, ch] != T.EXP_REUSE:
                bw.write(6, 50)           # chbwcod
        for ch in range(nch):
            if strat[blk, ch] == T.EXP_REUSE:
                continue
            _write_exponents(bw, enc_exp[blk, ch], nb[ch], int(strat[blk, ch])
                             if ch != lfe_ch else T.EXP_D15)
            if ch != lfe_ch:
                bw.write(2, 0)            # gainrng
        baie = 1 if blk == 0 else 0
        bw.write(1, baie)
        if baie:
            bw.write(2, 2)                # sdcycod
            bw.write(2, 1)                # fdcycod
            bw.write(2, 1)                # sgaincod
            bw.write(2, 2)                # dbkneecod
            bw.write(3, 4)                # floorcod
        bw.write(1, baie)                 # snroffste
        if baie:
            bw.write(6, csnr)
            for _ in range(nch):
                bw.write(4, fsnr)
                bw.write(3, 4)            # fgaincod
        bw.write(1, 0)                    # deltbaie
        bw.write(1, 0)                    # skiple

        # ---- grouped-mantissa combine + emit ------------------------------
        qm = qmant[blk].copy()            # [ch, 256]
        m1 = m2 = m4 = 0
        h1 = h2 = h4 = None
        for ch in range(nch):
            for i in range(nb[ch]):
                cls = int(bap[blk, ch, i])
                v = int(qm[ch, i])
                if cls == 1:
                    if m1 == 0:
                        h1 = (ch, i)
                        qm[ch, i] = 9 * v
                        m1 = 1
                    elif m1 == 1:
                        qm[h1] += 3 * v
                        qm[ch, i] = 128
                        m1 = 2
                    else:
                        qm[h1] += v
                        qm[ch, i] = 128
                        m1 = 0
                elif cls == 2:
                    if m2 == 0:
                        h2 = (ch, i)
                        qm[ch, i] = 25 * v
                        m2 = 1
                    elif m2 == 1:
                        qm[h2] += 5 * v
                        qm[ch, i] = 128
                        m2 = 2
                    else:
                        qm[h2] += v
                        qm[ch, i] = 128
                        m2 = 0
                elif cls == 4:
                    if m4 == 0:
                        h4 = (ch, i)
                        qm[ch, i] = 11 * v
                        m4 = 1
                    else:
                        qm[h4] += v
                        qm[ch, i] = 128
                        m4 = 0
        for ch in range(nch):
            for i in range(nb[ch]):
                cls = int(bap[blk, ch, i])
                q = int(qm[ch, i])
                if cls == 0:
                    continue
                if cls in (1, 2, 4):
                    if q != 128:
                        bw.write(5 if cls == 1 else 7, q)
                elif cls == 3:
                    bw.write(3, q)
                elif cls == 14:
                    bw.write(14, q)
                elif cls == 15:
                    bw.write(16, q)
                else:
                    bw.write(cls - 1, q)

    # ---- frame end: zero fill + dual CRC ----------------------------------
    frame = bytearray(bw.flush())
    total = cfg.frame_size * 2
    # NB: the reference's bit accounting can overshoot the frame by one byte
    # on non-48kHz sizes (its own comment at ac3enc.cpp:1609-1614 records the
    # tripped assert); in release builds crc2 then overwrites the last
    # payload byte.  We reproduce that byte-exactly.
    assert len(frame) <= total - 1, (len(frame), total)
    frame = frame[:total - 2]
    frame += b"\x00" * (total - 2 - len(frame))
    fs58 = (cfg.frame_size >> 1) + (cfg.frame_size >> 3)
    crc1 = ac3_crc(bytes(frame[4:2 * fs58]))
    crc_inv = pow_poly(CRC16_POLY >> 1, 16 * fs58 - 16, CRC16_POLY)
    crc1 = mul_poly(crc_inv, crc1, CRC16_POLY)
    frame[2] = crc1 >> 8
    frame[3] = crc1 & 0xFF
    crc2 = ac3_crc(bytes(frame[2 * fs58:]))
    frame += bytes([crc2 >> 8, crc2 & 0xFF])
    return bytes(frame)
