"""The plain reference encoder: int16 PCM -> AC-3 frames, byte for byte
the reference encoder's (fccHandler/Bellard ac3enc, ac3enc.cpp).

A frozen copy of the port's plain versions, kept under the benchmark so
that no later change to the program moves it: the int16 window,
block-float normalize and fixed-point MDCT (``mdct``), the exponent
extraction, strategy, reuse folding and coding, the masking curve and the
SNR-offset search with its bap (``alloc``), the quantizer, and the
one-frame Python packer (``pack``).  Eager PyTorch over a lane axis: no
kernel, no native library.
"""
from __future__ import annotations

from dataclasses import dataclass
from functools import lru_cache

import numpy as np
import torch

from . import alloc as AL
from . import tables as T
from .mdct import extract_exponents, mdct512, window_norm_block
from .pack import pack_frame


FRAME_BITS_INC = (0, 0, 2, 2, 2, 4, 2, 4)
ACMOD_BY_NCH = (1, 2, 3, 6, 7, 7)      # ac3enc.cpp:1029-1036

# lane-frames per call of the frame core: a multi-frame encode of B lanes
# runs max(1, CORE_ROWS // B) frames a call (the core does not depend on
# the carry, so any grouping gives the same bytes).  Fewer, larger calls
# launch fewer small ops; peak memory grows with the rows (on an H100, 5.1
# at 16,384 rows: about 10 GB, set by the MDCT; chip_smoke.py's encode
# phase times the forms and gives each stage's peak)
CORE_ROWS = 16384


@dataclass(frozen=True)
class EncoderConfig:
    channels: int                      # 1..6 (6 => 5.1)
    fscod: int
    halfratecod: int
    frmsizecod: int
    frame_size: int                    # in 16-bit words
    bit_rate: int                      # kbit/s (full-rate table value)

    @property
    def acmod(self) -> int:
        return ACMOD_BY_NCH[self.channels - 1]

    @property
    def lfe(self) -> bool:
        return self.channels == 6

    @property
    def nfchans(self) -> int:
        return min(self.channels, 5)

    @property
    def nb_coefs(self):
        n = [223] * self.nfchans
        if self.lfe:
            n.append(7)
        return tuple(n)

    @property
    def sample_rate(self) -> int:
        return int(T.SAMPLE_RATES[self.fscod]) >> self.halfratecod


def make_config(freq: int, bitrate: int, channels: int) -> EncoderConfig:
    """AC3_encode_init parameter selection (ac3enc.cpp:1019-1110)."""
    if not 1 <= channels <= 6:
        raise ValueError("channels must be 1..6")
    fscod = halfratecod = None
    for hr in range(3):
        for j in range(3):
            if (int(T.SAMPLE_RATES[j]) >> hr) == freq:
                fscod, halfratecod = j, hr
                break
        if fscod is not None:
            break
    if fscod is None:
        raise ValueError(f"unsupported sample rate {freq}")
    kbps = bitrate // 1000
    idx = None
    for i in range(19):
        if (int(T.BIT_RATES[i]) >> halfratecod) == kbps:
            idx = i
            break
    if idx is None:
        raise ValueError(f"unsupported bitrate {bitrate}")
    frame_size = kbps * 1000 * T.FRAME_SAMPLES // (freq * 16)
    return EncoderConfig(channels=channels, fscod=fscod,
                         halfratecod=halfratecod, frmsizecod=idx << 1,
                         frame_size=frame_size, bit_rate=int(T.BIT_RATES[idx]))



def _frame_constants(cfg: EncoderConfig):
    """(fixed side-info bits, available bits) of a frame (ac3enc.cpp:
    881-916); the only dynamic side info is 8 bits per non-REUSE fbw
    (block, channel) for chbwcod+gainrng, plus the exponents."""
    nf, nch = cfg.nfchans, cfg.channels
    fixed = 65 + FRAME_BITS_INC[cfg.acmod]
    for _ in range(6):
        fixed += nf * 2 + 2
        if cfg.acmod == 2:
            fixed += 1
        fixed += 2 * nf
        if cfg.lfe:
            fixed += 1
        fixed += 1 + 1 + 2
    fixed += 1
    fixed += 2 * 4 + 3 + 6 + nch * (4 + 3)
    fixed += 2 + 16
    return fixed, 16 * cfg.frame_size


@lru_cache(maxsize=16)
def _mask_tables(cfg: EncoderConfig, device: torch.device):
    """(live bins of each channel [ch] int32, is_lfe [ch], hearing
    threshold [50] int32) on `device`."""
    nb = torch.as_tensor(cfg.nb_coefs, dtype=torch.int32, device=device)
    is_lfe = torch.zeros(cfg.channels, dtype=torch.bool, device=device)
    if cfg.lfe:
        is_lfe[cfg.nfchans] = True
    hth = torch.as_tensor(T.HTH[:, cfg.fscod].astype(np.int32),
                          device=device)
    return nb, is_lfe, hth



def _csnr_fixup(res, csnroffst):
    """The carried-csnroffst bookkeeping of one frame: ok <=> the
    reference's down pass finds a fit from the carried start
    (M >= csnr & 3); cstar = M then.  On !ok every caller raises (the
    reference prints its error and aborts the frame), so the fields of
    such lanes are don't-cares."""
    M = res.pop("M")
    ok = M >= (csnroffst & 3)
    cstar = torch.where(ok, M, csnroffst)
    return dict(res, csnroffst=cstar, ok=ok, new_csnr=cstar)


def _blocks(samples, nch):
    """samples [..., 1536, nch] -> blocks [..., 6, nch, 256] int32."""
    lead = samples.shape[:-2]
    return samples.to(torch.int32).reshape(lead + (6, 256, nch)) \
        .transpose(-1, -2)


EXP_NEW = 1
LFE_BINS = 7         # the LFE's live bins (its nb_coefs)
NB = 223             # a full-band channel's live bins (EncoderConfig's)


def encode_exp_static(exp, nb_coefs: int, gsize: int):
    """encode_exp for one static (nb_coefs, group size).

    exp [..., 256] int32 -> (encoded [..., 256], nbits int).

    The reference's iterative +-2 delta relaxation (ac3enc.cpp:730-747)
    converges to the largest 2-Lipschitz array below the group minima:
    c_i = min(v_i, c_{i-1} + 2), whose closed form
    f_i = 2i + cummin_{j<=i}(v_j - 2j), and the same backward."""
    dev = exp.device
    ngroups = ((nb_coefs + gsize * 3 - 4) // (3 * gsize)) * 3
    k = torch.as_tensor(1 + np.arange(ngroups)[:, None] * gsize
                        + np.arange(gsize)[None, :], device=dev)
    gmin = exp[..., k].amin(dim=-1)                       # [..., ngroups]
    dc = torch.clamp(exp[..., 0:1], max=15)
    v = torch.cat([dc, gmin], dim=-1)                     # [..., ngroups+1]
    j2 = torch.arange(0, 2 * (ngroups + 1), 2, dtype=exp.dtype, device=dev)
    f = torch.cummin(v - j2, dim=-1).values + j2
    g = torch.cummin((f + j2).flip(-1), dim=-1).values.flip(-1) - j2
    out = torch.zeros_like(exp)
    out[..., 0] = g[..., 0]
    out[..., 1:1 + ngroups * gsize] = torch.repeat_interleave(
        g[..., 1:], gsize, dim=-1)
    return out, 4 + (ngroups // 3) * 7


def strategy(exp, lfe: bool):
    """exp [N, 6, ch, 256] -> (new [N, 6, ch] bool: the block starts a
    run, strat [N, 6, ch] int32), ac3enc.cpp:617-668; the last channel is
    the LFE if lfe."""
    N, nch = exp.shape[0], exp.shape[2]
    nf = nch - int(lfe)
    dev = exp.device
    diff = (exp[:, 1:] - exp[:, :-1]).abs().sum(dim=-1)      # [N, 5, ch]
    new = torch.cat([torch.ones((N, 1, nch), dtype=torch.bool, device=dev),
                     diff > 1000], dim=1)                     # [N, 6, ch]
    # next_new[i] = min{j > i : new[j]} (6 if none)
    running = torch.full((N, nch), 6, dtype=torch.int32, device=dev)
    nxt = [None] * 6
    for i in range(5, -1, -1):
        nxt[i] = running
        running = torch.where(new[:, i], i, running)
    strat = []
    for i in range(6):
        runlen = nxt[i] - i
        code = torch.where(runlen == 1, T.EXP_D45,
                           torch.where(runlen <= 3, T.EXP_D25, T.EXP_D15))
        s_i = torch.where(new[:, i], code, T.EXP_REUSE)
        if lfe:
            s_i[:, nf] = torch.where(new[:, i, nf], EXP_NEW, T.EXP_REUSE)
        strat.append(s_i)
    return new, torch.stack(strat, dim=1).to(torch.int32)


def encode_exponents(exp, new, strat, nb: int, lfe: bool):
    """Reuse folding + exponent coding: -> (enc_exp [N, 6, ch, 256] int32,
    exponent bits [N]); full-band channels have nb live bins, the LFE (the
    last channel if lfe) LFE_BINS."""
    N, nch = exp.shape[0], exp.shape[2]
    nf = nch - int(lfe)
    nbs = (nb,) * nf + (LFE_BINS,) * int(lfe)
    dev = exp.device
    # run id + exponent_min fold over each run (ac3enc.cpp:1730-1749)
    rid = torch.zeros((N, nch), dtype=torch.int32, device=dev)
    run_id = []
    for i in range(6):
        rid = torch.where(new[:, i], i, rid)
        run_id.append(rid)
    run_id = torch.stack(run_id, dim=1)                       # [N, 6, ch]
    live = (torch.arange(256, device=dev)[None, :]
            < torch.as_tensor(nbs, device=dev)[:, None])      # [ch, 256]
    folded = exp.clone()
    for i in range(6):
        same = run_id == run_id[:, i:i + 1]
        fmin = torch.where(same[..., None], exp, 25).amin(dim=1)
        folded[:, i] = torch.where(live, fmin, exp[:, i])

    enc_exp = torch.zeros_like(exp)
    exp_bits = torch.zeros((N,), dtype=torch.int32, device=dev)
    fbw = folded[:, :, :nf]
    for g, scode in ((1, T.EXP_D15), (2, T.EXP_D25), (4, T.EXP_D45)):
        e_s, bits_s = encode_exp_static(fbw, nb, g)
        sel = strat[:, :, :nf] == scode                       # [N, 6, nf]
        enc_exp[:, :, :nf] = torch.where(sel[..., None], e_s,
                                         enc_exp[:, :, :nf])
        exp_bits += sel.sum(dim=(1, 2), dtype=torch.int32) * bits_s
    if lfe:                                           # D15 only, 7 bins
        e_s, bits_s = encode_exp_static(folded[:, :, nf], LFE_BINS, 1)
        sel = strat[:, :, nf] == EXP_NEW
        enc_exp[:, :, nf] = torch.where(sel[..., None], e_s,
                                        enc_exp[:, :, nf])
        exp_bits += sel.sum(dim=1, dtype=torch.int32) * bits_s
    # reuse blocks take the block before's encoded exponents
    for i in range(1, 6):
        reuse = strat[:, i] == T.EXP_REUSE
        enc_exp[:, i] = torch.where(reuse[..., None], enc_exp[:, i - 1],
                                    enc_exp[:, i])
    return enc_exp, exp_bits


def exponents_ref(coef, exp_samples, nb, lfe):
    """Plain version of exponents (any device): the eager chain, coef
    zeroed in place where it overranges."""
    exp, zeroed = extract_exponents(coef, exp_samples)
    coef.copy_(zeroed)
    new, strat = strategy(exp, lfe)
    enc_exp, exp_bits = encode_exponents(exp, new, strat, nb, lfe)
    return enc_exp.to(torch.int8), strat, exp_bits


# the encoder's curve constants (ac3enc.cpp: fgaincod 4, sgaincod 1,
# fdcycod 1, sdcycod 2, dbpbcod 2, floorcod 4); the decays are shifted
# right by halfratecod
FGAIN, SGAIN = int(T.FGAINTAB[4]), int(T.SGAINTAB[1])
FDECAY, SDECAY = int(T.FDECAYTAB[1]), int(T.SDECAYTAB[2])
DBKNEE, FLOOR = int(T.DBKNEETAB[2]), int(T.FLOORTAB[4])



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



def _wrap32(x):
    """int64 -> the value of (int32)x, kept in int64."""
    return ((x + 0x80000000) & 0xFFFFFFFF) - 0x80000000


def _shl32(x, s):
    """int32 x << s as XLA defines it for any count: a count outside
    [0, 31] gives 0.  x, s int64; the count is clamped before the shift,
    so no device sees an over-wide one."""
    ok = (s >= 0) & (s < 32)
    return torch.where(ok, _wrap32(x << torch.clamp(s, 0, 31)), 0)


def _sar32(x, s):
    """int32 x >> s (arithmetic) as XLA defines it: a count outside
    [0, 31] fills with the sign."""
    return x >> torch.where((s < 0) | (s > 31), 31, s)


@lru_cache(maxsize=8)
def _quant_tables(device: torch.device):
    """Per bap class: symmetric levels (classes 1-5, else 0), asymmetric
    bits (classes 6-15, else 1), as int64 tensors."""
    levels = np.zeros(16, np.int64)
    levels[1:6] = (3, 5, 7, 11, 15)
    qbits = np.ones(16, np.int64)
    for cls in range(6, 16):
        qbits[cls] = cls - 1 if cls < 14 else (14 if cls == 14 else 16)
    return (torch.tensor(levels, device=device),
            torch.tensor(qbits, device=device))


def quantize_ref(coef, enc_exp, global_exp, bap, codes=torch.int32):
    """Plain version of quantize (any device), codes in either form.

    Each coefficient is quantized by its own class (a per-element table
    lookup of levels or bits, not one pass per class); every int32 step
    of the reference wraps as it does there."""
    levels_t, qbits_t = _quant_tables(coef.device)
    cls = bap.to(torch.int64)
    c = coef.to(torch.int64)
    e = (enc_exp - global_exp[..., None]).to(torch.int64)
    # symmetric: levels 3, 5, 7, 11, 15
    levels = levels_t[cls]
    x = _shl32(_wrap32(c.abs()), e)
    v = (_wrap32(levels * x) >> 24) + 1 >> 1
    half = levels >> 1
    sym = torch.where(c >= 0, half + v, half - v)
    # asymmetric: qbits-bit two's complement, saturated at the top
    qbits = qbits_t[cls]
    lshift = e + qbits - 24
    v = torch.where(lshift >= 0, _shl32(c, torch.clamp(lshift, min=0)),
                    _sar32(c, torch.clamp(-lshift, min=0)))
    v = _wrap32(v + 1) >> 1
    one = torch.ones_like(qbits)
    m = one << (qbits - 1)
    v = torch.where(v >= m, m - 1, v)
    asym = v & ((one << qbits) - 1)
    out = torch.where(cls >= 6, asym, torch.where(cls >= 1, sym, 0))
    if codes == torch.int16:
        # the low 16 bits, as the int16 of that pattern
        return (((out + 0x8000) & 0xFFFF) - 0x8000).to(torch.int16)
    return out.to(torch.int32)



def window_mdct_ref(prev, cur):
    """window_norm_block, then mdct512."""
    windowed, _, exp_samples = window_norm_block(prev, cur)
    return mdct512(windowed), exp_samples


def frame_core(cfg: EncoderConfig, cur, prev):
    """(cur, prev) [N, 6, ch, 256] int32 -> the frame fields of N
    lane-frames ("M" the largest feasible coarse offset)."""
    nf = cfg.nfchans
    coef, exp_samples = window_mdct_ref(prev.contiguous(), cur.contiguous())
    enc_exp, strat, exp_bits = exponents_ref(coef, exp_samples,
                                             cfg.nb_coefs[0], cfg.lfe)
    enc8 = enc_exp.view(torch.uint8)
    fbw_new = (strat[:, :, :nf] != T.EXP_REUSE).sum(dim=(1, 2),
                                                    dtype=torch.int32)
    fixed, total = _frame_constants(cfg)
    avail = total - (fixed + exp_bits + 8 * fbw_new)
    M, fstar, bap = mask_search_ref(enc8, avail,
                                    *_mask_tables(cfg, cur.device),
                                    cfg.halfratecod)
    qmant = quantize_ref(coef, enc_exp, exp_samples, bap)
    return dict(bap=bap, qmant=qmant, enc_exp=enc8, strat=strat,
                M=M, fsnroffst=fstar, new_last=cur[:, 5])


def encode_lanes(cfg: EncoderConfig, samples, last, csnr=None):
    """samples [L, F, 1536, nch] int16 (interleaved), last [L, nch, 256]
    int32 (each lane's block before its first frame) -> (frames [L, F]
    as bytes, ok [L, F] bool numpy, fields {name: [L, F, ...] numpy}).

    csnr (the carried coarse offset, [L] int32) starts at the encoder's
    40; each frame's bytes depend only on its own blocks and the block
    before (frame_core), the carry only decides ``ok``."""
    L, F = samples.shape[:2]
    dev = samples.device
    cur = _blocks(samples, cfg.channels)                  # [L,F,6,ch,256]
    first = last[:, None]
    before = torch.cat([first, cur[:, :-1, 5]], dim=1)    # [L,F,ch,256]
    prev = torch.cat([before[:, :, None], cur[:, :, :5]], dim=2)
    res = frame_core(cfg, cur.reshape((L * F,) + cur.shape[2:]),
                     prev.reshape((L * F,) + prev.shape[2:]))
    res = {k: v.reshape((L, F) + v.shape[1:]) for k, v in res.items()}
    if csnr is None:
        csnr = torch.full((L,), 40, dtype=torch.int32, device=dev)
    M = res.pop("M")
    steps = []
    for f in range(F):
        steps.append(_csnr_fixup({"M": M[:, f]}, csnr))
        csnr = steps[-1]["new_csnr"]
    for k in ("csnroffst", "ok"):
        res[k] = torch.stack([s[k] for s in steps], dim=1)
    host = {k: v.cpu().numpy() for k, v in res.items() if k != "new_last"}
    flat = {k: v.reshape((L * F,) + v.shape[2:]) for k, v in host.items()}
    frames = [[pack_frame(cfg, flat, l * F + f) for f in range(F)]
              for l in range(L)]
    return frames, host["ok"], host
