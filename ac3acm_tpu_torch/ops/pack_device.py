"""AC-3 frame assembly on the device: only finished frames leave it.

``pack_frames_device(cfg, bap, qmant, enc_exp, strat, csnr, fsnr)`` turns a
batch of frame fields into finished frames (``pack_frames_device(cfg)``
returns that call's packer, as in the JAX package), byte for byte
host/pack.py:pack_frame.  On CUDA tensors it launches the hand-written
kernel P1 (csrc/pack.cu:pack_frames_kernel), once a call: one warp a
frame builds the frame in its slice of shared memory, offsets, deposit and
both CRCs included, and writes only its bytes.  On CPU tensors it runs
``pack_frames_ref``, the plain version.  There is no other path.  The JAX
package computes the same function as XLA (ac3acm_tpu/ops/pack_device.py
:361 pack_frames_device), with no pallas_call.

The plain version is the reference's serial put_bits loop
(ac3enc.cpp:1194-1638) as data parallelism.  A frame is a static schedule
of bit tokens (the token count and order are fixed by the encoder config;
only lengths and values are data), so a batch of frames assembles as

    token lengths -> cumulative sum           = bit offsets
    token values  -> scatter-add into 32-bit words held in int64
                     (each token lands in one word or straddles two;
                     the bits are disjoint, so add == or)
    CRC1/CRC2     -> GF(2)-linear in the payload bytes: one table entry
                     per (byte position, byte value), XOR-folded (the
                     crc1 back-patch of ac3enc.cpp:1599-1638 folds into
                     crc1's table)

Grouped mantissas (3-in-5-bits, 3-in-7, 2-in-7, carried across channels
within a block, ac3enc.cpp:1347-1501): a class member's ordinal in its
block is a cumulative count; a head (ordinal % group size == 0) takes
the next one or two members of its class, read from the members
compacted by ordinal.

Clock marks: the kernel route marks "pack"; the plain version its stages,
"pack: tokens", "pack: offsets", "pack: deposit" and "pack: CRC".
"""
from __future__ import annotations

import ctypes as C
from functools import lru_cache

import numpy as np
import torch

from .. import tables as T
from ..host.pack import CRC16_POLY, crc_table, mul_poly, pow_poly
from . import _cuda

# P1 launches since the last reset (only where the CUDA kernel is
# launched; the CPU path leaves it alone)
launches_pack = 0


def _ngroups(nbc: int, gsize: int) -> int:
    return (nbc + gsize * 3 - 4) // (3 * gsize)


def _crc_tables(frame_size: int):
    """Per-byte-position GF(2) contribution tables of the two CRCs:
    (h1 [n1, 8], h2 [n2, 8] uint16, fs58).

    crc = M(x) * x^16 mod P with the first byte highest-degree; byte i's
    bit j (LSB j=0) contributes x^(8*(n-1-i)+j+16) mod P.  crc1 is then
    multiplied by crc_inv = (P>>1)^(16*fs58-16) (the reference's
    back-patch, ac3enc.cpp:1624-1631), which, being linear, folds into
    its table."""
    total = frame_size * 2
    fs58 = (frame_size >> 1) + (frame_size >> 3)
    crc_inv = pow_poly(CRC16_POLY >> 1, 16 * fs58 - 16, CRC16_POLY)

    def table(nbytes, mult):
        h = np.zeros((nbytes, 8), np.uint16)
        maxk = 8 * nbytes + 24
        xk = np.zeros(maxk, np.uint32)
        cur = 1
        for k in range(maxk):
            xk[k] = cur
            cur <<= 1
            if cur & (1 << 16):
                cur ^= CRC16_POLY
        for i in range(nbytes):
            base = 8 * (nbytes - 1 - i) + 16
            for j in range(8):
                h[i, j] = mul_poly(mult, int(xk[base + j]), CRC16_POLY)
        return h

    n1 = 2 * fs58 - 4
    n2 = total - 2 - 2 * fs58
    return table(n1, crc_inv), table(n2, 1), fs58


def _byte_table(h):
    """h [n, 8] -> [n * 256] int64: entry i*256 + b is the XOR of h[i, j]
    over the set bits j of b (byte i's whole contribution)."""
    bits = (np.arange(256)[:, None] >> np.arange(8)) & 1        # [256, 8]
    t = np.bitwise_xor.reduce(
        np.where(bits[None], h[:, None, :].astype(np.int64), 0), axis=-1)
    return t.reshape(-1)


def _header_tokens(cfg):
    """[(len, value)] of the static frame header (output_frame_header
    parity; host/pack.py:pack_frame).  crc1 is a 16-bit zero placeholder,
    patched after the CRC pass."""
    toks = [(16, 0x0B77), (16, 0), (2, cfg.fscod), (6, cfg.frmsizecod),
            (5, 8 + cfg.halfratecod), (3, 0), (3, cfg.acmod)]
    if (cfg.acmod & 1) and cfg.acmod != 1:
        toks.append((2, 1))
    if cfg.acmod & 4:
        toks.append((2, 1))
    if cfg.acmod == 2:
        toks.append((2, 0))
    toks.append((1, 1 if cfg.lfe else 0))
    toks.append((5, 31))
    toks += [(1, v) for v in (0, 0, 0, 0, 1, 0, 0, 0)]
    return toks


@lru_cache(maxsize=16)
def _plan(cfg, device: torch.device):
    """Per-config constants on `device`."""
    nb = np.array(cfg.nb_coefs, np.int64)
    h1, h2, fs58 = _crc_tables(cfg.frame_size)
    ng = np.zeros((cfg.channels, 4), np.int64)   # groups by strategy 1..3
    for c in range(cfg.channels):
        for s, gs in ((1, 1), (2, 2), (3, 4)):
            ng[c, s] = _ngroups(int(nb[c]), gs)
    return dict(
        fs58=fs58, total=cfg.frame_size * 2,
        gmax=_ngroups(int(nb[0]), 1),
        ngroups=torch.tensor(ng, device=device),
        crc1=torch.tensor(_byte_table(h1), device=device),
        crc2=torch.tensor(_byte_table(h2), device=device),
        live=torch.tensor(np.nonzero(np.concatenate(
            [np.arange(256) < n for n in nb]))[0], device=device))


_GROUP_CLASSES = ((1, 3, 5, (9, 3, 1)), (2, 3, 7, (25, 5, 1)),
                  (4, 2, 7, (11, 1)))


def _mant_tokens(cls, q):
    """cls int8, q int32 or int16 [R, L]: one block's live coefficients a
    row, in channel order.  -> (lens, vals) int64 [R, L] with the grouped
    classes combined onto their heads (members after a head emit
    nothing).  An int16 code is its low 16 bits, widened as unsigned."""
    cls = cls.to(torch.int64)
    q = q.to(torch.int64) & 0xFFFF if q.dtype == torch.int16 \
        else q.to(torch.int64)
    # ungrouped lengths: 0 -> 0; 3 -> 3; 5..13 -> cls-1; 14 -> 14; 15 -> 16
    lens = torch.where(cls >= 5, cls - 1, torch.where(cls == 3, 3, 0))
    lens = torch.where(cls == 14, 14, lens)
    lens = torch.where(cls == 15, 16, lens)
    vals = q
    qg = q & 15                     # grouped codes are <= 10
    R, L = q.shape
    for c, gsize, bits, mults in _GROUP_CLASSES:
        m = cls == c
        ordn = torch.cumsum(m, dim=1) - 1               # ordinal of members
        count = ordn[:, -1:] + 1
        # the members' codes by ordinal (non-members go to a spare slot)
        byord = torch.zeros((R, L + 1), dtype=torch.int64, device=q.device)
        byord.scatter_(1, torch.where(m, ordn, L), qg)
        head = m & (ordn % gsize == 0)
        hv = mults[0] * qg
        for k in range(1, len(mults)):
            nxt = ordn + k
            have = nxt < count
            got = torch.gather(byord, 1, torch.where(have, nxt, L))
            hv = hv + mults[k] * torch.where(have, got, 0)
        lens = torch.where(m, torch.where(head, bits, 0), lens)
        vals = torch.where(head, hv, vals)
    return lens, vals


def _exp_group_tokens(enc_exp, strat, gmax: int):
    """enc_exp [..., 256] int64, strat [...] -> [..., gmax] 7-bit grouped
    exponent deltas for each row's own strategy, padded to the D15 count
    (strided slices per group size, one select)."""
    outs = []
    tmax = 3 * gmax
    for gsize in (1, 2, 4):
        sl = enc_exp[..., 1::gsize]
        if sl.shape[-1] < tmax:
            sl = torch.cat([sl, sl.new_zeros(sl.shape[:-1]
                                             + (tmax - sl.shape[-1],))], -1)
        cur = sl[..., :tmax]
        prev = torch.cat([enc_exp[..., 0:1], cur[..., :-1]], dim=-1)
        d3 = (cur - prev + 2).reshape(cur.shape[:-1] + (gmax, 3))
        outs.append((d3[..., 0] * 5 + d3[..., 1]) * 5 + d3[..., 2])
    g1, g2, g4 = outs
    s = strat[..., None]
    return torch.where(s == 1, g1, torch.where(s == 2, g2, g4))


def tokens(cfg, bap, qmant, enc_exp, strat, csnr, fsnr):
    """Flat frame fields [N, ...] -> (lens, vals) int64 [N, T]: every
    frame's token stream in schedule order (host/pack.py:pack_frame's
    write order)."""
    p = _plan(cfg, bap.device)
    nch, nf = cfg.channels, cfg.nfchans
    lfe_ch = nf if cfg.lfe else -1
    N = bap.shape[0]
    dev = bap.device
    strat = strat.to(torch.int64)                         # [N, 6, ch]
    reuse = strat == T.EXP_REUSE
    # the live coefficients, compacted in channel order
    live = p["live"]
    L = live.numel()
    mant_lens, mant_vals = _mant_tokens(
        bap.reshape(N * 6, -1).index_select(1, live),
        qmant.reshape(N * 6, -1).index_select(1, live))
    mant_lens = mant_lens.reshape(N, 6, L)
    mant_vals = mant_vals.reshape(N, 6, L)
    e64 = enc_exp.to(torch.int64)
    grp7 = _exp_group_tokens(e64, strat, p["gmax"])       # [N,6,ch,gmax]
    # each (block, channel)'s group count under its strategy
    ngrp = torch.gather(p["ngroups"].expand(N, 6, -1, -1), 3,
                        strat[..., None].clamp(max=3))[..., 0]
    garange = torch.arange(p["gmax"], device=dev)
    glen = torch.where(reuse[..., None] | (garange >= ngrp[..., None]), 0, 7)

    lens_parts, vals_parts = [], []
    pend = []

    def const(length, value):
        pend.append((length, value))

    def flush():
        if pend:
            t = torch.tensor(pend, dtype=torch.int64, device=dev)
            lens_parts.append(t[:, 0].expand(N, -1))
            vals_parts.append(t[:, 1].expand(N, -1))
            pend.clear()

    def dyn(lens, vals):
        flush()
        lens_parts.append(lens.reshape(N, -1))
        vals_parts.append(vals.reshape(N, -1))

    def full(x, n=1):
        return torch.full((N, n), x, dtype=torch.int64, device=dev)

    pend += _header_tokens(cfg)
    for blk in range(6):
        for _ in range(nf):
            const(1, 0)                   # blksw: always 512-pt
        for _ in range(nf):
            const(1, 1)                   # dithflag
        const(1, 0)                       # dynrnge
        if blk == 0:
            const(1, 1)                   # cplstre
            const(1, 0)                   # cplinu
        else:
            const(1, 0)
        if cfg.acmod == 2:
            if blk == 0:
                const(1, 1)               # rematstr
                for _ in range(4):
                    const(1, 0)
            else:
                const(1, 0)
        dyn(full(2, nf), strat[:, blk, :nf])
        if cfg.lfe:
            dyn(full(1), strat[:, blk, lfe_ch:])
        dyn(torch.where(reuse[:, blk, :nf], 0, 6), full(50, nf))  # chbwcod
        for ch in range(nch):
            r = reuse[:, blk, ch:ch + 1]
            dyn(torch.where(r, 0, 4), e64[:, blk, ch, 0:1])        # first exp
            dyn(glen[:, blk, ch], grp7[:, blk, ch])
            if ch != lfe_ch:
                dyn(torch.where(r, 0, 2), full(0))                 # gainrng
        baie = 1 if blk == 0 else 0
        const(1, baie)
        if baie:
            for ln, v in ((2, 2), (2, 1), (2, 1), (2, 2), (3, 4)):
                const(ln, v)
        const(1, baie)                    # snroffste
        if baie:
            dyn(full(6), csnr.to(torch.int64)[:, None])
            for _ in range(nch):
                dyn(full(4), fsnr.to(torch.int64)[:, None])
                const(3, 4)               # fgaincod
        const(1, 0)                       # deltbaie
        const(1, 0)                       # skiple
        dyn(mant_lens[:, blk], mant_vals[:, blk])
    flush()
    lens = torch.cat(lens_parts, dim=1)
    vals = torch.cat(vals_parts, dim=1)
    # token lengths are at most 16, so the mask's shift is in range
    return lens, vals & ((torch.ones_like(lens) << lens) - 1)


def deposit(cfg, lens, vals, off):
    """Tokens at bit offsets `off` -> frame bytes [N, total] int64 (no
    CRC yet; the last two bytes zero).  A token of length l at offset o
    is placed in a 48-bit window starting at word o >> 5 (o & 31 + l <= 47),
    whose top 32 bits add into that word and low 16 into the next."""
    total = cfg.frame_size * 2
    N = lens.shape[0]
    nwords = total // 4 + 2
    w = torch.clamp(off >> 5, max=nwords - 2)
    window = vals << (48 - (off & 31) - lens)
    words = torch.zeros((N, nwords), dtype=torch.int64, device=lens.device)
    words.scatter_add_(1, w, window >> 16)
    words.scatter_add_(1, w + 1, (window & 0xFFFF) << 16)
    shifts = torch.tensor([24, 16, 8, 0], device=lens.device)
    out = ((words[..., None] >> shifts) & 0xFF).reshape(N, -1)[:, :total]
    # the reference's overshoot: the payload truncates at total-2, where
    # crc2 goes (host/pack.py:pack_frame)
    out[:, total - 2:] = 0
    return out


def _xor_fold(x):
    """XOR-reduce the last axis (halving, log2 steps)."""
    while x.shape[-1] > 1:
        n = x.shape[-1]
        if n % 2:
            x = torch.cat([x, x.new_zeros(x.shape[:-1] + (1,))], dim=-1)
            n += 1
        x = x[..., : n // 2] ^ x[..., n // 2:]
    return x[..., 0]


def crc_finish(cfg, frame):
    """frame [N, total] int64 bytes -> the finished frames, uint8, with
    crc1 in bytes 2-3 and crc2 in the last two."""
    p = _plan(cfg, frame.device)
    fs58, total = p["fs58"], p["total"]

    def crc(region, table):
        pos = torch.arange(region.shape[1], device=frame.device) * 256
        return _xor_fold(table[pos + region])

    crc1 = crc(frame[:, 4:2 * fs58], p["crc1"])
    crc2 = crc(frame[:, 2 * fs58:total - 2], p["crc2"])
    frame[:, 2] = crc1 >> 8
    frame[:, 3] = crc1 & 0xFF
    frame[:, total - 2] = crc2 >> 8
    frame[:, total - 1] = crc2 & 0xFF
    return frame.to(torch.uint8)


def pack_frames_ref(cfg, bap, qmant, enc_exp, strat, csnr, fsnr, clock=None):
    """Plain version of pack_frames_device (any device): tokens ->
    offsets -> deposit -> crc_finish over an int64 token stream, marking
    each stage on `clock`."""
    mark = clock.mark if clock is not None else (lambda name: None)
    lead = bap.shape[:-3]
    n = int(np.prod(lead)) if lead else 1

    def flat(x, k):
        return x.reshape((n,) + x.shape[x.dim() - k:])

    lens, vals = tokens(cfg, flat(bap, 3), flat(qmant, 3), flat(enc_exp, 3),
                        flat(strat, 2), csnr.reshape(n), fsnr.reshape(n))
    mark("pack: tokens")
    off = torch.cumsum(lens, dim=1) - lens
    mark("pack: offsets")
    frame = deposit(cfg, lens, vals, off)
    mark("pack: deposit")
    out = crc_finish(cfg, frame)
    mark("pack: CRC")
    return out.reshape(lead + (cfg.frame_size * 2,))


# ---------------------------------------------------------------------------
# the kernel route (csrc/pack.cu)
# ---------------------------------------------------------------------------

# csrc/pack.cu's table layout (int32): the first index of each section
_TAB_GMAX, _TAB_NB, _TAB_NSLOTS, _TAB_NG, _TAB_SPAN = 4, 8, 16, 24, 48
_TAB_CRC, _TAB_MULT1, _TAB_MULT2, _TAB_SLOTS = 72, 328, 360, 392
MAX_SLOTS = 96
# a frame's threads (one warp): the CRC chunks, one a lane
LANES = 32
_TAB_SIZE = _TAB_SLOTS + 6 * MAX_SLOTS
# in the order csrc/pack.cu:pack_frames_layout gives them
LAYOUT = (_TAB_GMAX, _TAB_NB, _TAB_NSLOTS, _TAB_NG, _TAB_SPAN, _TAB_CRC,
          _TAB_MULT1, _TAB_MULT2, _TAB_SLOTS, _TAB_SIZE, MAX_SLOTS)
# slot kinds: a constant; a constant that a reused channel omits
# (chbwcod, gainrng); the strategy; the first exponent; the exponent
# groups; the coarse and the fine snr offset
K_CONST, K_COND, K_STRAT, K_EXP0, K_GROUPS, K_CSNR, K_FSNR = range(7)


def _merged(slots):
    """Runs of constant slots joined into slots of at most 16 bits (the
    same bits in the same order)."""
    out = []
    for kind, ch, ln, v in slots:
        v &= (1 << ln) - 1
        if (kind == K_CONST and out and out[-1][0] == K_CONST
                and out[-1][2] + ln <= 16):
            _, _, l0, v0 = out[-1]
            out[-1] = (K_CONST, 0, l0 + ln, (v0 << ln) | v)
        else:
            out.append((kind, ch, ln, v))
    return out


def schedule(cfg):
    """Each block's side-info slots in write order (tokens' order; the
    header leads block 0): (kind, channel, bits, value) tuples, constant
    runs merged.  A K_COND, K_EXP0 or K_GROUPS slot is 0 bits long for a
    reused channel; K_GROUPS is 7 bits a group of its channel's strategy;
    the live mantissa bins follow each block's slots."""
    nch, nf = cfg.channels, cfg.nfchans
    lfe_ch = nf if cfg.lfe else -1
    blocks = []
    for blk in range(6):
        s = [(K_CONST, 0, ln, v) for ln, v in _header_tokens(cfg)] \
            if blk == 0 else []
        s += [(K_CONST, 0, 1, 0)] * nf          # blksw: always 512-pt
        s += [(K_CONST, 0, 1, 1)] * nf          # dithflag
        s.append((K_CONST, 0, 1, 0))            # dynrnge
        s += ([(K_CONST, 0, 1, 1), (K_CONST, 0, 1, 0)] if blk == 0
              else [(K_CONST, 0, 1, 0)])        # cplstre (cplinu)
        if cfg.acmod == 2:                      # rematstr (rematflg)
            s += ([(K_CONST, 0, 1, 1)] + [(K_CONST, 0, 1, 0)] * 4
                  if blk == 0 else [(K_CONST, 0, 1, 0)])
        s += [(K_STRAT, c, 2, 0) for c in range(nf)]
        if cfg.lfe:
            s.append((K_STRAT, lfe_ch, 1, 0))
        s += [(K_COND, c, 6, 50) for c in range(nf)]        # chbwcod
        for ch in range(nch):
            s += [(K_EXP0, ch, 4, 0), (K_GROUPS, ch, 0, 0)]
            if ch != lfe_ch:
                s.append((K_COND, ch, 2, 0))                # gainrng
        baie = 1 if blk == 0 else 0
        s.append((K_CONST, 0, 1, baie))
        if baie:
            s += [(K_CONST, 0, ln, v) for ln, v in
                  ((2, 2), (2, 1), (2, 1), (2, 2), (3, 4))]
        s.append((K_CONST, 0, 1, baie))         # snroffste
        if baie:
            s.append((K_CSNR, 0, 6, 0))
            for _ in range(nch):
                s += [(K_FSNR, 0, 4, 0), (K_CONST, 0, 3, 4)]  # fgaincod
        s += [(K_CONST, 0, 1, 0)] * 2           # deltbaie, skiple
        blocks.append(_merged(s))
    return blocks


def _crc_multipliers(a: int, e: int, threads: int, mult: int):
    """Per lane of csrc/pack.cu:crc_part over bytes [a, e), cut into
    `threads` chunks: mult x x^(8 x the bytes after its chunk) mod the CRC
    polynomial."""
    chunk = -(-(e - a) // threads)
    out = np.zeros(threads, np.int64)
    for t in range(threads):
        end = min(a + (t + 1) * chunk, e)
        after = e - end if a + t * chunk < e else 0
        out[t] = mul_poly(mult, pow_poly(2, 8 * after, CRC16_POLY),
                          CRC16_POLY)
    return out


@lru_cache(maxsize=16)
def kernel_table(cfg) -> np.ndarray:
    """csrc/pack.cu's per-config table, int32 [_TAB_SIZE] (the layout is
    the kernel's TAB_* constants)."""
    nch = cfg.channels
    nb = [int(n) for n in cfg.nb_coefs]
    gmax = max(_ngroups(nb[0], 1), 0)
    tab = np.zeros(_TAB_SIZE, np.int64)
    tab[_TAB_GMAX] = gmax
    tab[_TAB_NB:_TAB_NB + nch] = nb
    for c in range(nch):
        for s, gs in ((1, 1), (2, 2), (3, 4)):
            ng = min(max(_ngroups(nb[c], gs), 0), gmax)
            tab[_TAB_NG + 4 * c + s] = ng
            # the exponent bytes the group walk reads, from byte 0
            tab[_TAB_SPAN + 4 * c + s] = min(256,
                                             max(1, 2 + gs * (3 * ng - 1)))
    tab[_TAB_CRC:_TAB_CRC + 256] = crc_table()
    total = cfg.frame_size * 2
    fs58 = (cfg.frame_size >> 1) + (cfg.frame_size >> 3)
    crc_inv = pow_poly(CRC16_POLY >> 1, 16 * fs58 - 16, CRC16_POLY)
    tab[_TAB_MULT1:_TAB_MULT1 + LANES] = _crc_multipliers(4, 2 * fs58,
                                                          LANES, crc_inv)
    tab[_TAB_MULT2:_TAB_MULT2 + LANES] = _crc_multipliers(2 * fs58,
                                                          total - 2, LANES, 1)
    for blk, slots in enumerate(schedule(cfg)):
        if len(slots) > MAX_SLOTS:
            raise ValueError(f"block {blk} has {len(slots)} slots, the "
                             f"kernel takes {MAX_SLOTS}")
        tab[_TAB_NSLOTS + blk] = len(slots)
        base = _TAB_SLOTS + blk * MAX_SLOTS
        for i, (kind, ch, ln, v) in enumerate(slots):
            assert ln <= 16 and 0 <= v < 1 << 16 and ch < 8
            tab[base + i] = v | ln << 16 | ch << 21 | kind << 24
    return tab.astype(np.int32)


@lru_cache(maxsize=16)
def _kernel_table_on(cfg, device: torch.device):
    return torch.from_numpy(kernel_table(cfg)).to(device)


def _bind(lib):
    p, i = C.c_void_p, C.c_int
    lib.pack_frames_launch.restype = i
    lib.pack_frames_launch.argtypes = [p, p, p, p, p, p, p, i, i, p,
                                       C.c_longlong, i, i, p]
    lib.pack_frames_warps.restype = i
    lib.pack_frames_warps.argtypes = [i, i]
    lib.pack_frames_resident.restype = i
    lib.pack_frames_resident.argtypes = [i, i]
    lib.pack_frames_layout.restype = i
    lib.pack_frames_layout.argtypes = [p]
    lib.pack_frames_error_string.restype = C.c_char_p
    lib.pack_frames_error_string.argtypes = [i]


def cta_warps(cfg) -> int:
    """The warps of one P1 CTA for cfg, a frame each at a time
    (csrc/pack.cu:cta_warps: 8 up to two channels, 16 above, fewer where
    the frames' shared memory would not fit a CTA)."""
    return _lib().pack_frames_warps(cfg.channels, cfg.frame_size * 2)


def resident_frames(cfg) -> int:
    """The frames P1 holds at once on one SM of the current card for cfg
    and the main path's int16 codes (its CTAs an SM, by registers and
    shared memory, times their warps)."""
    lib = _lib()
    n = lib.pack_frames_resident(cfg.channels, cfg.frame_size * 2)
    if n <= 0:
        raise RuntimeError("pack_frames_resident failed: "
                           + lib.pack_frames_error_string(-n).decode())
    return n


def _lib():
    lib = _cuda.load("pack", _bind)
    layout = (C.c_int * 16)()
    n = lib.pack_frames_layout(layout)
    if tuple(layout[:n]) != LAYOUT:
        raise RuntimeError("csrc/pack.cu's table layout differs from "
                           "ops/pack_device.py's")
    return lib


def _check(cfg, bap, qmant, enc_exp, strat, csnr, fsnr):
    """The kernel's contract, on both devices: -> (lead shape, frames)."""
    dev = bap.device
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"pack_frames_device runs on cuda or cpu, not {dev}")
    named = (("bap", bap, (torch.int8,)),
             ("qmant", qmant, (torch.int32, torch.int16)),
             ("enc_exp", enc_exp, (torch.uint8,)),
             ("strat", strat, (torch.int32,)),
             ("csnr", csnr, (torch.int32,)), ("fsnr", fsnr, (torch.int32,)))
    for name, t, dtypes in named:
        if t.dtype not in dtypes:
            raise TypeError(f"{name} is {t.dtype}, expected one of "
                            f"{dtypes}")
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, bap on {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    nch = cfg.channels
    if bap.dim() < 3 or tuple(bap.shape[-3:]) != (6, nch, 256):
        raise ValueError(f"bap has shape {tuple(bap.shape)}, expected "
                         f"[..., 6, {nch}, 256]")
    lead = tuple(bap.shape[:-3])
    for name, t, shape in (("qmant", qmant, bap.shape),
                           ("enc_exp", enc_exp, bap.shape),
                           ("strat", strat, lead + (6, nch)),
                           ("csnr", csnr, lead), ("fsnr", fsnr, lead)):
        if tuple(t.shape) != tuple(shape):
            raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                             f"{tuple(shape)}")
    for name, t in (("bap", bap), ("qmant", qmant), ("enc_exp", enc_exp)):
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")
    return lead, int(np.prod(lead)) if lead else 1


def pack_frames_device(cfg, bap=None, qmant=None, enc_exp=None, strat=None,
                       csnr=None, fsnr=None, clock=None):
    """Frame fields -> finished frames, on their device; with no fields,
    the packer fn(bap, qmant, enc_exp, strat, csnr, fsnr, clock=None) of
    `cfg` (the JAX package's calling form).  Some fields but not all raise
    TypeError.

      bap     [..., 6, nch, 256] int8 (classes 0..15 on the live bins)
      qmant   [..., 6, nch, 256] int32, or int16 (the codes' low 16 bits,
                                 read as unsigned: Q1's 16-bit form)
      enc_exp [..., 6, nch, 256] uint8
      strat   [..., 6, nch]      int32 (0 reuse, 1 D15, 2 D25, 3 D45)
      csnr    [...]              int32
      fsnr    [...]              int32
      ->      [..., frame_size*2] uint8

    Every tensor contiguous and on one device, the first three 16-byte
    aligned.  CUDA tensors launch P1 once; CPU ones run pack_frames_ref;
    no frames, nothing.  A frame whose tokens overrun it (the encoder's
    ok false) holds the first total - 2 bytes of its bit stream and CRC2,
    as the plain version and the native packer write it.

    clock: an object with mark(name), called after the pack ("pack") or,
    on the CPU, after each of the plain version's stages."""
    fields = (bap, qmant, enc_exp, strat, csnr, fsnr)
    if all(f is None for f in fields) and clock is None:
        def packer(bap, qmant, enc_exp, strat, csnr, fsnr, clock=None):
            return _pack(cfg, bap, qmant, enc_exp, strat, csnr, fsnr, clock)
        return packer
    if any(f is None for f in fields):
        raise TypeError("pack_frames_device takes the six fields (bap, "
                        "qmant, enc_exp, strat, csnr, fsnr) or none")
    return _pack(cfg, *fields, clock)


def _pack(cfg, bap, qmant, enc_exp, strat, csnr, fsnr, clock):
    global launches_pack
    lead, n = _check(cfg, bap, qmant, enc_exp, strat, csnr, fsnr)
    dev = bap.device
    total = cfg.frame_size * 2
    if n == 0:
        return torch.empty(lead + (total,), dtype=torch.uint8, device=dev)
    if dev.type == "cpu":
        return pack_frames_ref(cfg, bap, qmant, enc_exp, strat, csnr, fsnr,
                               clock)
    out = torch.empty(lead + (total,), dtype=torch.uint8, device=dev)
    lib = _lib()
    tab = _kernel_table_on(cfg, dev)
    fs58 = (cfg.frame_size >> 1) + (cfg.frame_size >> 3)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.pack_frames_launch(
            bap.data_ptr(), qmant.data_ptr(), enc_exp.data_ptr(),
            strat.data_ptr(), csnr.data_ptr(), fsnr.data_ptr(),
            tab.data_ptr(), total, fs58, out.data_ptr(), n, cfg.channels,
            qmant.element_size(), stream)
    if rc != 0:
        raise RuntimeError("pack_frames (P1) kernel launch failed: "
                           + lib.pack_frames_error_string(rc).decode())
    launches_pack += 1
    if clock is not None:
        clock.mark("pack")
    return out
