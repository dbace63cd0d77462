"""AC-3 decode math on tensors: the steady and block-scan bodies, and the
single-stream decoder.

The host pre-pass (native parser) emits dense per-block frequency planes;
this module turns a chunk of them into PCM, reproducing a52_block's math:
dequantized planes, stereo rematrixing, the downmix-before-IMDCT vs
IMDCT-then-downmix decision with its ``downmixed`` carry fixups, the
128-float OLA delay per channel, and the exact mixer orderings from
downmix.c.  ``_pipeline_steady`` serves chunks in which every block takes
the same strategy (checked on the host by ``steady_ok``) without a
sequential loop; ``_pipeline_body`` serves any chunk, one block step at a
time after the hoisted transforms.

The batched bodies take the lane axis explicitly: tensors are
[B, n, ...] (lanes, blocks), the carry is (delay [B, 6, 128] f32,
downmixed [B] bool).  One stream (``block_pipeline``, ``Decoder``) runs
the block scan with a lane axis of 1; ``_block_step`` is one block of it,
written out: the plain version of the fixed-point decode's kernel B1QS
(``fixed_block_pipeline``, int32 Q30) runs it block by block with its
own filterbank, and the tests hold a scan of it to the block scan.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from .. import tables as T
from ..host import parse as P
from ..ops.downmix import downmix, upmix
from ..ops.filterbank import filterbank, mats_on
from ..ops.imdct_exact import split_fb_exact
from ..utils.device import resolve_device

# ---------------------------------------------------------------------------
# Package-wide decode accuracy policy (same names and default as the JAX
# package).
#
#   "reference" (default): the order-exact IMDCT (ops.imdct_exact, the
#       B1 kernel on the card), bit-identical to the compiled float liba52.
#   "fast": the matmul filterbank (+ the fused steady kernel).  Contract:
#       max <= 0.02, mean <= 0.001, sigma <= 0.002 in 16-bit units against
#       the reference decoder.
#
# Resolved when a pipeline is built: set it before constructing decoders.
ACCURACY = "reference"


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


def _block_step(fmt: StreamFormat, carry, blk, filterbank=filterbank):
    """One a52_block worth of device math for one stream.

    carry = (delay [6, 128] f32, downmixed 0-d bool); blk: freq [6, 256]
    (host dequant), blksw [5] bool, coeff [5], remat [256] bool, bias 0-d
    -> (carry, pcm [nch_out, 256], LFE first).  `filterbank` may be
    swapped for the order-exact ops.imdct_exact.filterbank_exact, which
    reproduces the reference's float output bit for bit, or for
    filterbank_fixed (int32 Q30 freq, delay and bias: every where and
    mix below keeps freq's dtype)."""
    delay, downmixed = carry
    nf = fmt.nfchans
    bias = blk["bias"]
    freq = blk["freq"]
    zero = torch.zeros((), dtype=freq.dtype, device=freq.device)
    mix = dict(acmod=fmt.acmod, output=fmt.output)

    if fmt.acmod == T.A52_STEREO:
        s0, s1 = freq[0], freq[1]
        m = blk["remat"]
        freq = torch.cat([torch.where(m, s0 + s1, s0)[None],
                          torch.where(m, s0 - s1, s1)[None], freq[2:]])

    # LFE: always a long block, always the stream's bias
    lfe_time = None
    new_delay = delay.clone()
    if fmt.lfe_out:
        lfe_time, new_delay[5] = filterbank(
            freq[5], delay[5], torch.zeros((), dtype=torch.bool,
                                           device=freq.device), bias)

    fbw = freq[:5]
    blksw = blk["blksw"]
    coeff = blk["coeff"]

    # TIME path: IMDCT of the coded channels, then the time-domain mix
    delay_t = torch.where(downmixed, upmix(delay[:5], **mix), delay[:5])
    bias_mask = torch.tensor([bool((fmt.chanbias >> i) & 1)
                              for i in range(5)], device=freq.device)
    t_out, t_dnew = filterbank(fbw, delay_t, blksw,
                               torch.where(bias_mask, zero, bias))
    zero_ch = (coeff == 0.0)[:, None]
    t_out = torch.where(zero_ch, bias, t_out)
    t_dnew = torch.where(zero_ch, delay_t, t_dnew)
    t_mixed = downmix(t_out, bias=bias, slev_zero=fmt.slev_zero, **mix)

    if fmt.nf_out >= nf:
        # the reference always takes the time path here (parse.c:881-886)
        out = t_mixed
        new_delay[:5] = t_dnew
        carry = (new_delay, torch.zeros_like(downmixed))
    else:
        # FREQ path: the mix in the frequency domain, IMDCT of the outputs
        f_freq = downmix(fbw, bias=zero, slev_zero=fmt.slev_zero, **mix)
        delay_f = torch.where(downmixed, delay[:5],
                              downmix(delay[:5], bias=zero,
                                      slev_zero=fmt.slev_zero, **mix))
        f_out, f_dnew = filterbank(f_freq, delay_f, blksw[0].expand(5),
                                   bias.expand(5))
        uniform = (blksw[:nf] == blksw[0]).all()
        out = torch.where(uniform, f_out, t_mixed)
        new_delay[:5] = torch.where(uniform, f_dnew, t_dnew)
        carry = (new_delay, uniform)

    planes = [out[i] for i in range(fmt.nf_out)]
    if fmt.lfe_out:
        planes = [lfe_time] + planes
    return carry, torch.stack(planes)


def _lanes_first(fn, planes, *args, **kw):
    """Apply a channel-first mixer to [B, C, ...] planes."""
    return fn(planes.movedim(1, 0), *args, **kw).movedim(0, 1)


def _filterbank_ops(device, exact: bool):
    """(split_fb, ola) of one accuracy mode on `device`.

    split_fb(coeffs [..., 256], blksw [...] bool or None: every row long)
    -> (z [..., 256], d [..., 128]): exact=True the order-exact transform
    (ops.imdct_exact), else the matmul filterbank in full FP32.

    ola(z, delay, bias) = (z*win + dfold*win_r) + bias, each op rounding
    its own result: eager PyTorch never contracts a product into the add
    that follows it, so this is the reference's own evaluation order in
    both modes.  (Never addcmul or torch.compile here: both fuse the
    multiply into the add and move the exact mode by an ulp.)"""
    w_long, w_short, win, win_r = mats_on(device)
    if exact:
        def split_fb(coeffs, blksw):
            return split_fb_exact(
                coeffs.contiguous(),
                None if blksw is None else blksw.contiguous())
    else:
        def split_fb(coeffs, blksw):
            if blksw is None:
                # a strided view (a plane slice) does not fold into one
                # [rows, 256] product: matmul would broadcast w_long and
                # run a batched GEMM of a few rows per (lane, block)
                zd = torch.matmul(coeffs.contiguous(), w_long)
            else:
                blk = blksw[..., None]
                zd = (torch.matmul(torch.where(blk, 0.0, coeffs), w_long)
                      + torch.matmul(torch.where(blk, coeffs, 0.0), w_short))
            return zd[..., :256], zd[..., 256:]

    def ola(z, delay, bias):
        dfold = torch.cat([delay, delay.flip(-1)], dim=-1)
        return z * win + dfold * win_r + bias

    return split_fb, ola


def _remat(fmt: StreamFormat, blocks):
    """Stereo rematrixing of full [B, n, 6, 256] planes (a no-op for other
    modes)."""
    freq = blocks["freq"]
    if fmt.acmod != T.A52_STEREO:
        return freq
    s0, s1 = freq[:, :, 0], freq[:, :, 1]
    m = blocks["remat"]
    return torch.stack([torch.where(m, s0 + s1, s0),
                        torch.where(m, s0 - s1, s1)]
                       + list(freq[:, :, 2:].unbind(2)), dim=2)


def _pipeline_steady(fmt: StreamFormat, carry, blocks,
                     long_only: bool = False, premixed: bool = False,
                     exact: bool = False):
    """Scan-free steady decode of one chunk for B lanes.

    When every block takes the same strategy, the OLA delay chain is a
    pure one-block shift (delay[i+1] = d[i]), so the whole chunk is
    elementwise after the hoisted transforms.

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
    skips the short transform.  exact=True (ACCURACY="reference") takes
    the order-exact transform: its delay output does not depend on the
    entering delay either, so the chunk structure is the same and the
    output is bit-identical to the reference float build.
    """
    delay, downmixed = carry
    freq = blocks["freq"]
    split_fb, ola = _filterbank_ops(freq.device, exact)
    reduces = fmt.nf_out < fmt.nfchans

    def chain(d, d0):
        # delay seen by block i is block i-1's output delay; i=0 sees d0
        return torch.cat([d0[:, None], d[:, :-1]], dim=1)

    if premixed:
        assert reduces or fmt.identity_mix, \
            "premixed blocks require the freq path or an identity mix"
    else:
        freq = _remat(fmt, blocks)
    blksw = None if long_only else blocks["blksw"]
    bias = blocks["bias"][:, :, None, None]              # [B, n, 1, 1]
    fbw = None if premixed else freq[:, :, :5]
    zero = torch.zeros((), dtype=freq.dtype, device=freq.device)
    outs = []
    new_delay = delay.clone()

    if fmt.lfe_out:
        lfe_plane = freq[:, :, fmt.nf_out] if premixed else freq[:, :, 5]
        z_l, d_l = split_fb(lfe_plane, None)             # always long
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
        blk0 = None if long_only else blksw[:, :, :1].expand(-1, -1, nfo)
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
        z_t, d_t = split_fb(freq[:, :, :nfo],
                            None if long_only else blksw[:, :, :nfo])
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


def _pipeline_body(fmt: StreamFormat, carry, blocks, exact: bool = False):
    """Decode of any chunk for B lanes: a52_block's strategy per block.

    The transforms of every block are hoisted out of the sequential part
    (each one's delay output is independent of the entering delay), so
    they run once per chunk on all lanes x blocks x channels; the loop
    over the chunk's blocks then carries the OLA delay and the
    ``downmixed`` layout flag with elementwise work only, all lanes in
    each step.  Per block: the time path (IMDCT of the coded channels,
    zero-coefficient channels keep their delay and emit the bias, then the
    time-domain mix) and, for a reducing mix, the freq path (mix, then
    IMDCT of the output channels), chosen per lane by whether blksw is
    uniform across the coded channels.

    blocks as for _pipeline_steady (full planes, not premixed).
    -> ((delay, downmixed), pcm [B, n, nch_out, 256] float32, LFE first).
    """
    delay, downmixed = carry
    freq = _remat(fmt, blocks)                           # [B, n, 6, 256]
    split_fb, ola = _filterbank_ops(freq.device, exact)
    nf, nfo = fmt.nfchans, fmt.nf_out
    reduces = nfo < nf
    blksw, bias = blocks["blksw"], blocks["bias"]        # [B, n, 5], [B, n]
    zero_ch = (blocks["coeff"] == 0.0)[..., None]        # [B, n, 5, 1]
    fbw = freq[:, :, :5]
    zero = torch.zeros((), dtype=freq.dtype, device=freq.device)
    mix = dict(acmod=fmt.acmod, output=fmt.output)

    z_t, d_t = split_fb(fbw, blksw)
    if reduces:
        # only the nf_out output channels are transformed on this path
        # (parse.c:918-936); upper delay planes stay stale
        f_freq = downmix(fbw.movedim(2, 0), bias=zero, slev_zero=fmt.slev_zero,
                         **mix).movedim(0, 2)[:, :, :nfo]
        z_f, d_f = split_fb(f_freq, blksw[:, :, :1].expand(-1, -1, nfo))
        uniform = (blksw[:, :, :nf] == blksw[:, :, :1]).all(-1)   # [B, n]
    if fmt.lfe_out:
        z_l, d_l = split_fb(freq[:, :, 5], None)          # always long
    bias_mask = torch.tensor([bool((fmt.chanbias >> i) & 1) for i in range(5)],
                             device=freq.device)[:, None]

    pcms = []
    for i in range(freq.shape[1]):
        b = bias[:, i, None, None]                       # [B, 1, 1]
        d5 = delay[:, :5]
        outs = []
        if fmt.lfe_out:
            outs.append(ola(z_l[:, i], delay[:, 5], b[:, 0])[:, None])
        delay_t = torch.where(downmixed[:, None, None],
                              _lanes_first(upmix, d5, **mix), d5)
        t_out = ola(z_t[:, i], delay_t, torch.where(bias_mask, zero, b))
        t_out = torch.where(zero_ch[:, i], b, t_out)
        t_dnew = torch.where(zero_ch[:, i], delay_t, d_t[:, i])
        t_mixed = _lanes_first(downmix, t_out, bias=b[:, 0],
                               slev_zero=fmt.slev_zero, **mix)[:, :nfo]
        if reduces:
            delay_f = torch.where(
                downmixed[:, None, None], d5,
                _lanes_first(downmix, d5, bias=zero,
                             slev_zero=fmt.slev_zero, **mix))
            f_out = ola(z_f[:, i], delay_f[:, :nfo], b)
            u = uniform[:, i, None, None]
            out = torch.where(u, f_out, t_mixed)
            d_f_full = torch.cat([d_f[:, i], delay_f[:, nfo:]], dim=1)
            d5 = torch.where(u, d_f_full, t_dnew)
            downmixed = uniform[:, i]
        else:
            out = t_mixed
            d5 = t_dnew
            downmixed = torch.zeros_like(downmixed)
        d_lfe = d_l[:, i, None] if fmt.lfe_out else delay[:, 5:]
        delay = torch.cat([d5, d_lfe], dim=1)
        pcms.append(torch.cat(outs + [out], dim=1))
    return (delay, downmixed), torch.stack(pcms, dim=1)


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


def premix_blocks_device(fmt: StreamFormat, blocks) -> dict:
    """Tensor twin of premix_blocks for the raw-H2D path: the planes
    already live on the device after ops.unpack_device, so rematrixing and
    the mixer sums run there as the same elementwise expressions
    (ops.downmix, the same IEEE f32 evaluation order): planes bitwise equal
    to the host premix.  blocks: freq [B, n, 6, 256] (+ remat for stereo);
    -> the same dict without remat, freq [B, n, nf_out(+LFE), 256] with
    the LFE plane last."""
    assert fmt.nf_out < fmt.nfchans or fmt.identity_mix, \
        "premix requires the freq (reduces) path or an identity mix"
    planes = _remat(fmt, blocks).movedim(-2, 0)         # [6, B, n, 256]
    zero = torch.zeros((), dtype=planes.dtype, device=planes.device)
    mixed = downmix(planes[:5], fmt.acmod, fmt.output, zero,
                    slev_zero=fmt.slev_zero)
    keep = [mixed[i] for i in range(fmt.nf_out)]
    if fmt.lfe_out:
        keep.append(planes[5])
    out = {k: v for k, v in blocks.items() if k != "remat"}
    out["freq"] = torch.stack(keep, dim=-2)             # [B, n, P, 256]
    return out


def steady_ok(fmt: StreamFormat, blocks) -> bool:
    """Host-side eligibility check for _pipeline_steady (numpy blocks,
    arbitrary leading batch axes)."""
    blksw = np.asarray(blocks["blksw"])
    nf = fmt.nfchans
    if fmt.nf_out < fmt.nfchans:
        return bool((blksw[..., :nf] == blksw[..., :1]).all())
    return bool((np.asarray(blocks["coeff"])[..., :nf] != 0.0).all())


def _one_lane(body):
    """A lanes-first chunk body as (carry, blocks) -> (carry, pcm) of one
    stream: carry = (delay [6, 128] f32, downmixed 0-d bool) tensors;
    blocks with a leading nblk axis (numpy arrays or tensors; they go to
    the carry's device) take a lane axis of 1."""
    def run(carry, blocks):
        delay, downmixed = carry
        lanes = {k: torch.as_tensor(v, device=delay.device)[None]
                 for k, v in blocks.items()}
        (delay, downmixed), pcm = body((delay[None], downmixed[None]), lanes)
        return (delay[0], downmixed[0]), pcm[0]

    return run


def steady_pipeline(fmt: StreamFormat, long_only: bool = False,
                    premixed: bool = False, exact: bool = False):
    """(carry, blocks) -> (carry, pcm [nblk, nch_out, 256]) for one stream:
    the scan-free ``_pipeline_steady`` with a lane axis of 1 (see
    _one_lane), in place of the JAX package's jit.  Valid on chunks that
    pass steady_ok; exact=False (the JAX package's default here) takes
    the fast transform."""
    return _one_lane(lambda carry, blocks: _pipeline_steady(
        fmt, carry, blocks, long_only=long_only, premixed=premixed,
        exact=bool(exact)))


def block_pipeline(fmt: StreamFormat, exact: bool | None = None):
    """(carry, blocks) -> (carry, pcm [nblk, nch_out, 256]) for one stream:
    the block scan ``_pipeline_body`` with a lane axis of 1 (see
    _one_lane), in place of the JAX package's jit; the Decoder calls it
    once a frame.  exact (default: the package ACCURACY policy) selects
    the order-exact transform (B1 on the card)."""
    if exact is None:
        exact = default_exact()
    return _one_lane(lambda carry, blocks: _pipeline_body(
        fmt, carry, blocks, exact=bool(exact)))


def fixed_block_pipeline(fmt: StreamFormat):
    """(carry, blocks) -> (carry, pcm int32 [nblk, nch_out, 256]): the
    LIBA52_FIXED decode of one stream, int32 Q30 throughout.

    The same _block_step orchestration as the float scan (the path
    decision, the downmix/upmix fixups of the carried delay, zero-coeff
    channels), block after block, with the order-exact Q30 filterbank
    (the reference's MUL, a52_internal.h:144-150).  On a CUDA carry the
    whole chain is one launch of kernel B1QS (ops.fixed_chain.fixed_chain:
    every block's splits, Q30 overlap-adds, fixups and mixes, the carry in
    shared memory; no B1Q launch, no eager _block_step); on a CPU carry
    its plain version runs _block_step block by block.  The host pre-pass
    (native ac3h_sdec_parse_fixed) has dequantized and rematrixed, so
    blocks carry remat False; the fixed build's bias is always 0 (BIASV,
    native/ac3sample.inc).

    blocks: freq int32 [n, 6, 256], blksw bool [n, 5], coeff 0/1 [n, 5]
    (compared with 0 as _block_step does; float32 goes to the kernel as
    it is), remat bool [n, 256] (False), bias int32 [n] (zeros), numpy
    arrays or tensors (they go to the carry's device).
    carry: (delay int32 [6, 128], downmixed 0-d bool)."""
    from ..ops import fixed_chain as FC

    def run(carry, blocks):
        dev = carry[0].device
        blocks = {k: torch.as_tensor(v, device=dev)
                  for k, v in blocks.items()}
        if blocks["coeff"].dtype != torch.float32:
            blocks["coeff"] = (blocks["coeff"] != 0).to(torch.float32)
        return FC.fixed_chain(fmt, carry, blocks)

    return run


def init_fixed_carry(device=None):
    """The fixed decode's zero carry: (delay int32 [6, 128], downmixed
    True), on `device` (None: the CUDA card; raises without one)."""
    device = resolve_device(device)
    return (torch.zeros((6, 128), dtype=torch.int32, device=device),
            torch.ones((), dtype=torch.bool, device=device))


def init_carry(batch_shape=(), device=None):
    """Zero OLA delay and downmixed=True, on `device` (None: the CUDA
    card; raises without one)."""
    device = resolve_device(device)
    return (torch.zeros(tuple(batch_shape) + (6, 128), dtype=torch.float32,
                        device=device),
            torch.ones(tuple(batch_shape), dtype=torch.bool, device=device))


def _stack_blocks(frames) -> dict:
    """Stack host FrameData blocks into numpy arrays [nblk, ...]."""
    blocks = [b for f in frames for b in f.blocks]
    bias = np.float32(frames[0].bias)
    return {
        # host-side dequant: the same IEEE f32 multiplies as the device's
        "freq": np.stack([(b.q * b.a) * b.b for b in blocks]),
        "blksw": np.stack([b.blksw for b in blocks]),
        "coeff": np.stack([b.coeff for b in blocks]),
        "remat": np.stack([b.remat_mask for b in blocks]),
        "bias": np.full(len(blocks), bias, np.float32),
    }


def frame_format(f) -> StreamFormat:
    """StreamFormat of a host.parse.FrameData (chanbias depends on the
    (acmod, output) pair alone, so any block's will do)."""
    return StreamFormat(acmod=f.acmod, output=f.output,
                        slev_zero=bool(f.slev == 0.0),
                        chanbias=int(f.blocks[0].chanbias))


class Decoder:
    """Single-stream decoder with the a52_* API shape: the Python parser
    (host.parse.A52Parser) on the host, the block scan on the device.

    >>> dec = Decoder()
    >>> pcm, fmt = dec.decode_stream(es_bytes,
    ...                              flags=T.A52_STEREO | T.A52_ADJUST_LEVEL)
    >>> pcm.shape                                 # float32 [nblk, nch, 256]

    exact (None: the package ACCURACY policy, default "reference", bit for
    bit the compiled float liba52); exact=False takes the matmul
    filterbank (the fast-mode contract).  device: None -> the CUDA card
    (raises without one); "cpu" runs the plain PyTorch versions.

    The format may change from frame to frame (acmod, output mode, slev);
    the carry (OLA delay and downmixed flag) persists across the change,
    as the reference's single a52_state_t does.  Each frame is one
    block_pipeline call, as in the JAX package."""

    def __init__(self, exact: bool | None = None, device=None):
        self.device = resolve_device(device)
        self.parser = P.A52Parser()
        self._carry = None
        self._fmt = None
        self._exact = default_exact() if exact is None else exact

    def syncinfo(self, buf: bytes):
        return P.syncinfo(buf)

    def dynrng(self, callback=None):
        """a52_dynrng (parse.c:207-216): None disables DRC; a callable
        re-enables it with fn(range) -> range remapping."""
        self.parser.s.dynrnge = callable(callback)
        if callable(callback):
            self.parser.s.dynrng_call = callback

    def set_drc_enabled(self, enabled: bool):
        self.parser.s.dynrnge = enabled

    def decode_frames(self, frames_bytes, flags, level=1.0, bias=0.0):
        """Decode a list of raw frames -> (float32 [nblk, nch_out, 256]
        numpy, the last frame's StreamFormat)."""
        frames = [self.parser.decode_frame(fb, flags, level, bias)
                  for fb in frames_bytes]
        if self._carry is None:
            self._carry = init_carry(device=self.device)
        outs = []
        for f in frames:
            self._fmt = frame_format(f)
            self._carry, pcm = block_pipeline(self._fmt, exact=self._exact)(
                self._carry, _stack_blocks([f]))
            outs.append(pcm)
        return torch.cat(outs).cpu().numpy(), self._fmt

    def decode_stream(self, es: bytes, flags, level=1.0, bias=0.0):
        """Frame-sync state machine over an elementary stream."""
        frames = []
        pos = 0
        while pos + 7 <= len(es):
            size = P.syncinfo(es[pos:pos + 7])[0]
            if size == 0:
                pos += 1
                continue
            if pos + size > len(es):
                break
            frames.append(es[pos:pos + size])
            pos += size
        if not frames:
            return np.zeros((0, 0, 256), np.float32), None
        return self.decode_frames(frames, flags, level, bias)
