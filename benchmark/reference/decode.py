"""The plain reference decode: frame bytes -> int16 PCM, liba52's float
output bit for bit.

A frozen copy of the port's plain single-stream path (the Python parser
``A52Parser``, the block scan ``_block_step`` with the order-exact
filterbank, the int16 conversion), kept under the benchmark so that no
later change to the program moves it.  One block at a time, one lane at a
time: slow, plain, and independent of every kernel, the native parsers
and the batched pipelines that the benchmark times.

``decode_lanes`` starts each lane's parser at a given dither LFSR state: the
only state of liba52 that outlives a frame besides the 128-sample OLA
delay (a frame's block 0 carries new exponents and bit allocation for
every channel, so nothing else of the parser's state reaches the next
frame).  ``ParseCount`` counts the fields the parse reads, which the
benchmark's gather roofline takes as the device unpack's least work.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from . import tables as T
from .downmix import downmix, upmix
from .imdct import filterbank_exact
from .parse import A52Parser, syncinfo


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


def _block_step(fmt: StreamFormat, carry, blk, filterbank=filterbank_exact):
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


class _CountingReader:
    """A BitReader proxy that counts the fields read through it."""

    def __init__(self, br, counter):
        self._br, self._c = br, counter

    def read(self, n):
        self._c.fields += 1
        return self._br.read(n)

    def read_signed(self, n):
        self._c.fields += 1
        return self._br.read_signed(n)


class ParseCount(A52Parser):
    """A52Parser that counts, per frame, the exponent groups and mantissa
    words it reads (``fields``) and the dither draws (``draws``)."""

    def __init__(self):
        super().__init__()
        self.fields = 0
        self.draws = 0

    def _dither(self):
        self.draws += 1
        return super()._dither()

    def _coeff_get(self, br, *args):
        return super()._coeff_get(_CountingReader(br, self), *args)

    def _parse_exponents(self, br, *args):
        return A52Parser._parse_exponents(_CountingReader(br, self), *args)


def split_frames(es: bytes) -> list:
    """An elementary stream of whole frames -> the list of frame bytes."""
    out, pos = [], 0
    while pos + 7 <= len(es):
        size = syncinfo(es[pos:pos + 7])[0]
        if size == 0 or pos + size > len(es):
            raise ValueError(f"no whole frame at byte {pos}")
        out.append(es[pos:pos + size])
        pos += size
    return out


def decode_lanes(lanes, flags: int, level: float, bias: float,
                 lfsr_states, device="cpu"):
    """Decode many lanes' frames in order, each from a zero OLA delay, its
    parser starting at dither LFSR state lfsr_states[i]: lanes [L] lists
    of the same number of frame bytes, all of one format a frame -> pcm
    [L, n, 6, nch, 256] float32 at `bias`, the LFE plane first when the
    output has one.  The one-stream block step runs batched over the lanes
    through torch.func.vmap, which changes no operation."""
    L, n = len(lanes), len(lanes[0])
    parsers = []
    for st in lfsr_states:
        p = A52Parser()
        p.s.lfsr_state = int(st)
        parsers.append(p)
    delay = torch.zeros((L, 6, 128), dtype=torch.float32, device=device)
    downmixed = torch.ones((L,), dtype=torch.bool, device=device)
    outs = []
    for j in range(n):
        frames = [p.decode_frame(lanes[i][j], flags, level, bias)
                  for i, p in enumerate(parsers)]
        fmts = {frame_format(f) for f in frames}
        if len(fmts) != 1:
            raise ValueError(f"frame {j}: the lanes' formats differ: {fmts}")
        fmt = fmts.pop()
        stacked = [_stack_blocks([f]) for f in frames]
        blocks = {k: torch.from_numpy(np.stack([b[k] for b in stacked]))
                  .to(device) for k in stacked[0]}
        step = torch.func.vmap(lambda c, b: _block_step(fmt, c, b))
        pcm = []
        for i in range(T.NB_BLOCKS):
            (delay, downmixed), out = step(
                (delay, downmixed), {k: v[:, i] for k, v in blocks.items()})
            pcm.append(out)
        outs.append(torch.stack(pcm, dim=1))
    return torch.stack(outs, dim=1)
