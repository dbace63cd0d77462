"""Batched AC-3 decode math on tensors: the scan-free steady pipeline.

The host pre-pass (native parser) emits dense per-block frequency planes;
this module turns a chunk of them into PCM.  ``_pipeline_steady``
reproduces a52_block's math for chunks in which every block takes the
same strategy (checked on the host by ``steady_ok``): dequantized planes,
stereo rematrixing, the downmix-before-IMDCT vs IMDCT-then-downmix
decision with its ``downmixed`` carry fixups, the 128-float OLA delay per
channel, and the exact mixer orderings from downmix.c.

Every function takes the lane axis explicitly: tensors are
[B, n, ...] (lanes, blocks), the carry is (delay [B, 6, 128] f32,
downmixed [B] bool).
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from .. import tables as T
from ..ops.downmix import downmix, upmix
from ..ops.filterbank import mats_on

# ---------------------------------------------------------------------------
# Package-wide decode accuracy policy (same names and default as the JAX
# package).
#
#   "reference" (default): the order-exact IMDCT, bit-identical to the
#       compiled float liba52.  Not ported yet: building a pipeline in this
#       mode raises NotImplementedError (ROADMAP A2, the order-exact slice).
#   "fast": the matmul filterbank (+ the fused steady kernel).  Contract:
#       max <= 0.02, mean <= 0.001, sigma <= 0.002 in 16-bit units against
#       the reference decoder.
#
# Resolved when a pipeline is built: set it before constructing decoders.
ACCURACY = "reference"

EXACT_NOT_PORTED = ("the order-exact IMDCT (ACCURACY='reference') is not "
                    "ported yet: ROADMAP A2; call set_accuracy('fast')")


def set_accuracy(mode: str):
    """Set the package decode accuracy policy ("reference" | "fast")."""
    global ACCURACY
    assert mode in ("reference", "fast"), mode
    ACCURACY = mode


def default_exact() -> bool:
    return ACCURACY == "reference"


@dataclass(frozen=True)
class StreamFormat:
    """Static specialization key for the decode pipeline."""
    acmod: int
    output: int          # negotiated output incl. A52_LFE bit
    slev_zero: bool
    chanbias: int

    @property
    def nfchans(self) -> int:
        return int(T.NFCHANS[self.acmod])

    @property
    def nf_out(self) -> int:
        return int(T.NFCHANS[self.output & T.A52_CHANNEL_MASK])

    @property
    def lfe_out(self) -> bool:
        return bool(self.output & T.A52_LFE)

    @property
    def nch_out(self) -> int:
        return self.nf_out + (1 if self.lfe_out else 0)

    @property
    def identity_mix(self) -> bool:
        """True when the time-domain mixer is a no-op for this format
        (output mode == acmod, or STEREO->DOLBY) and no channel takes its
        bias from the mix (chanbias == 0).  Such passthrough decodes
        qualify for the premixed fast path too: the host premix is
        rematrix-only."""
        out = self.output & T.A52_CHANNEL_MASK
        if self.nf_out != self.nfchans or self.chanbias != 0:
            return False
        return out == self.acmod or (self.acmod == T.A52_STEREO
                                     and out == T.A52_DOLBY)


def _lanes_first(fn, planes, *args, **kw):
    """Apply a channel-first mixer to [B, C, ...] planes."""
    return fn(planes.movedim(1, 0), *args, **kw).movedim(0, 1)


def _pipeline_steady(fmt: StreamFormat, carry, blocks,
                     long_only: bool = False, premixed: bool = False,
                     exact: bool = False):
    """Scan-free steady decode of one chunk for B lanes.

    When every block takes the same strategy, the OLA delay chain is a
    pure one-block shift (delay[i+1] = d[i]), so the whole chunk is
    elementwise after the hoisted matrix products.

    Validity (checked on the host by `steady_ok`):
      * reduces (freq path): blksw uniform across coded channels in every
        block -- the path never flips to time-domain;
      * passthrough (time path): no zero-coeff channel.
    The entry-state fixups (upmix/downmix of the carried delay) are applied
    once, exactly as the block scan's first step would.

    blocks: freq [B, n, 6, 256] (premixed: [B, n, nf_out(+LFE), 256], LFE
    last), blksw [B, n, 5] bool, bias [B, n], remat [B, n, 256] bool
    (stereo, not premixed), coeff [B, n, 5].
    -> ((delay, downmixed), pcm [B, n, nch_out, 256] float32, LFE first).

    long_only=True (no short block anywhere in the chunk, host-checked)
    skips the all-zero short-matrix product.
    """
    if exact:
        raise NotImplementedError(EXACT_NOT_PORTED)
    delay, downmixed = carry
    freq = blocks["freq"]
    w_long, w_short, win, win_r = mats_on(freq.device)
    reduces = fmt.nf_out < fmt.nfchans

    def split_fb(coeffs, blksw):
        if long_only:
            zd = torch.matmul(coeffs, w_long)
        else:
            blk = blksw[..., None]
            zd = (torch.matmul(torch.where(blk, 0.0, coeffs), w_long)
                  + torch.matmul(torch.where(blk, coeffs, 0.0), w_short))
        return zd[..., :256], zd[..., 256:]

    def ola(z, delay, bias):
        dfold = torch.cat([delay, delay.flip(-1)], dim=-1)
        return z * win + dfold * win_r + bias

    def chain(d, d0):
        # delay seen by block i is block i-1's output delay; i=0 sees d0
        return torch.cat([d0[:, None], d[:, :-1]], dim=1)

    if premixed:
        assert reduces or fmt.identity_mix, \
            "premixed blocks require the freq path or an identity mix"
    if fmt.acmod == T.A52_STEREO and not premixed:
        s0, s1 = freq[:, :, 0], freq[:, :, 1]
        m = blocks["remat"]
        freq = torch.stack([torch.where(m, s0 + s1, s0),
                            torch.where(m, s0 - s1, s1)]
                           + list(freq[:, :, 2:].unbind(2)), dim=2)
    blksw = blocks["blksw"]
    bias = blocks["bias"][:, :, None, None]              # [B, n, 1, 1]
    fbw = None if premixed else freq[:, :, :5]
    zero = torch.zeros((), dtype=freq.dtype, device=freq.device)
    outs = []
    new_delay = delay.clone()

    if fmt.lfe_out:
        lfe_plane = freq[:, :, fmt.nf_out] if premixed else freq[:, :, 5]
        z_l, d_l = split_fb(lfe_plane, torch.zeros_like(blksw[..., 0]))
        lfe = ola(z_l, chain(d_l, delay[:, 5]), bias[:, :, 0])
        new_delay[:, 5] = d_l[:, -1]
        outs.append(lfe[:, :, None])

    nfo = fmt.nf_out
    if reduces:
        if premixed:
            f_freq = freq[:, :, :nfo]
        else:
            f_freq = downmix(fbw.movedim(2, 0), fmt.acmod, fmt.output, zero,
                             slev_zero=fmt.slev_zero).movedim(0, 2)[:, :, :nfo]
        blk0 = blksw[:, :, :1].expand(-1, -1, nfo)
        z_f, d_f = split_fb(f_freq, blk0)
        # entry fixup: a carry from a time-path block holds per-channel
        # delays; downmix them once (the scan's first-step behaviour)
        d_mix = _lanes_first(downmix, delay[:, :5], fmt.acmod, fmt.output,
                             zero, slev_zero=fmt.slev_zero)
        d0 = torch.where(downmixed[:, None, None], delay[:, :5], d_mix)
        out = ola(z_f, chain(d_f, d0[:, :nfo]), bias)
        new_delay[:, :nfo] = d_f[:, -1]
        # planes nf_out..4 stay stale, exactly like the block scan
        new_delay[:, nfo:5] = d0[:, nfo:]
        flag = torch.ones_like(downmixed)
    elif premixed:
        # passthrough premix (identity mix, chanbias == 0): the host
        # applied rematrixing and ships only the real planes; upmix, bias
        # masking and the output mix are no-ops for this format, and the
        # unused upper delay planes are what the generic path computes
        # for all-zero planes (exactly 0)
        z_t, d_t = split_fb(freq[:, :, :nfo], blksw[:, :, :nfo])
        out = ola(z_t, chain(d_t, delay[:, :nfo]), bias)
        new_delay[:, :nfo] = d_t[:, -1]
        new_delay[:, nfo:5] = 0.0
        flag = torch.zeros_like(downmixed)
    else:
        z_t, d_t = split_fb(fbw, blksw)
        d_up = _lanes_first(upmix, delay[:, :5], fmt.acmod, fmt.output)
        d0 = torch.where(downmixed[:, None, None], d_up, delay[:, :5])
        bias_mask = torch.tensor([bool((fmt.chanbias >> i) & 1)
                                  for i in range(5)], device=freq.device)
        bias_vec = torch.where(bias_mask[:, None], zero, bias)
        t_out = ola(z_t, chain(d_t, d0), bias_vec)          # [B, n, 5, 256]
        out = downmix(t_out.movedim(2, 0), fmt.acmod, fmt.output,
                      blocks["bias"][:, :, None],
                      slev_zero=fmt.slev_zero).movedim(0, 2)[:, :, :nfo]
        new_delay[:, :5] = d_t[:, -1]
        flag = torch.zeros_like(downmixed)
    pcm = torch.cat(outs + [out], dim=2) if outs else out
    return (new_delay, flag), pcm


def premix_blocks(fmt: StreamFormat, blocks) -> dict:
    """Host-side downmix for the steady freq path (numpy): applies
    rematrixing and the mixer sums with the same IEEE f32 adds as the
    device expressions, and keeps only the nf_out (+LFE) planes.  Only
    valid together with the steady path (steady_ok); the LFE plane, when
    present, comes last.  Identity-mix formats qualify too (the mix is
    then a no-op and the premix is rematrix-only)."""
    assert fmt.nf_out < fmt.nfchans or fmt.identity_mix, \
        "premix requires the freq (reduces) path or an identity mix"
    freq = np.asarray(blocks["freq"])                  # [..., n, 6, 256]
    if fmt.acmod == T.A52_STEREO:
        m = np.asarray(blocks["remat"])
        s0 = freq[..., 0, :]
        s1 = freq[..., 1, :]
        freq = freq.copy()
        freq[..., 0, :] = np.where(m, s0 + s1, s0)
        freq[..., 1, :] = np.where(m, s0 - s1, s1)
    planes = np.moveaxis(freq, -2, 0)                  # [6, ..., 256]
    mixed = downmix(planes[:5], fmt.acmod, fmt.output,
                    np.float32(0.0), slev_zero=fmt.slev_zero)
    keep = [np.asarray(mixed[i]) for i in range(fmt.nf_out)]
    if fmt.lfe_out:
        keep.append(np.asarray(planes[5]))
    pre = np.moveaxis(np.stack(keep), 0, -2)           # [..., n, nfo(+1), 256]
    out = dict(blocks)
    out["freq"] = np.ascontiguousarray(pre)
    return out


def steady_ok(fmt: StreamFormat, blocks) -> bool:
    """Host-side eligibility check for _pipeline_steady (numpy blocks,
    arbitrary leading batch axes)."""
    blksw = np.asarray(blocks["blksw"])
    nf = fmt.nfchans
    if fmt.nf_out < fmt.nfchans:
        return bool((blksw[..., :nf] == blksw[..., :1]).all())
    return bool((np.asarray(blocks["coeff"])[..., :nf] != 0.0).all())
