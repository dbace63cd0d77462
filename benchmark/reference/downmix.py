"""Channel downmix / upmix on tensors.

Each (acmod, output) pair gets the reference's exact mixer expression
(downmix.c:332-619), written as elementwise adds in the *same
floating-point evaluation order*, so outputs are bit-identical to liba52
and to the JAX package.  Dispatch is Python-static on (acmod, output,
slev_zero).

``planes`` is [C, ...] with the channel axis first (C coded channels; the
trailing axes are 256 samples, or 128 for the OLA delay fixups, behind
any batch axes).  Returns a new array of the same shape with the mixed
channels written (unused upper planes left as they were, as in the
reference).  ``downmix`` takes torch tensors or numpy arrays (the host
premix uses the same expressions); ``bias`` must broadcast against one
plane.
"""
from __future__ import annotations

import torch

from . import tables as T

_CM = T.A52_CHANNEL_MASK


def _apply(s, idx_vals):
    """Copy of s with planes [(index, value), ...] written."""
    s = s.clone() if isinstance(s, torch.Tensor) else s.copy()
    for i, v in idx_vals:
        s[i] = v
    return s


def downmix(planes, acmod: int, output: int, bias, clev_unused=None,
            slev_zero: bool = False):
    """a52_downmix (downmix.c:480-619) with exact add ordering.
    clev_unused keeps the JAX package's fifth slot; neither mixer reads
    it."""
    out = output & _CM
    key = (acmod, out)
    s = planes

    def upd(idx_vals):
        return _apply(s, idx_vals)

    if key == (T.A52_CHANNEL, T.A52_CHANNEL2):
        return upd([(0, s[1])])

    if key in ((T.A52_CHANNEL, T.A52_MONO), (T.A52_STEREO, T.A52_MONO)):
        return upd([(0, s[0] + (s[1] + bias))])

    if key == (T.A52_2F1R, T.A52_MONO):
        if slev_zero:
            return upd([(0, s[0] + (s[1] + bias))])
        return upd([(0, s[0] + (s[1] + s[2] + bias))])

    if key == (T.A52_3F, T.A52_MONO):
        return upd([(0, s[0] + (s[1] + s[2] + bias))])

    if key == (T.A52_3F1R, T.A52_MONO):
        if slev_zero:
            return upd([(0, s[0] + (s[1] + s[2] + bias))])
        return upd([(0, s[0] + (s[1] + s[2] + s[3] + bias))])

    if key == (T.A52_2F2R, T.A52_MONO):
        if slev_zero:
            return upd([(0, s[0] + (s[1] + bias))])
        return upd([(0, s[0] + (s[1] + s[2] + s[3] + bias))])

    if key == (T.A52_3F2R, T.A52_MONO):
        if slev_zero:
            return upd([(0, s[0] + (s[1] + s[2] + bias))])
        return upd([(0, s[0] + (s[1] + s[2] + s[3] + s[4] + bias))])

    if key == (T.A52_MONO, T.A52_DOLBY):
        return upd([(1, s[0])])

    if key in ((T.A52_3F, T.A52_STEREO), (T.A52_3F, T.A52_DOLBY)):
        common = s[1] + bias
        return upd([(0, s[0] + common), (1, s[2] + common)])

    if key == (T.A52_2F1R, T.A52_STEREO):
        if slev_zero:
            return s
        common = s[2] + bias
        return upd([(0, s[0] + common), (1, s[1] + common)])

    if key == (T.A52_2F1R, T.A52_DOLBY):
        surround = s[2]
        return upd([(0, s[0] + (-surround + bias)),
                    (1, s[1] + (surround + bias))])

    if key == (T.A52_3F1R, T.A52_STEREO):
        if slev_zero:
            common = s[1] + bias
            return upd([(0, s[0] + common), (1, s[2] + common)])
        common = s[1] + s[3] + bias
        return upd([(0, s[0] + common), (1, s[2] + common)])

    if key == (T.A52_3F1R, T.A52_DOLBY):
        common = s[1] + bias
        surround = s[3]
        return upd([(0, s[0] + (common - surround)),
                    (1, s[2] + common + surround)])

    if key == (T.A52_2F2R, T.A52_STEREO):
        if slev_zero:
            return s
        return upd([(0, s[0] + (s[2] + bias)), (1, s[1] + (s[3] + bias))])

    if key == (T.A52_2F2R, T.A52_DOLBY):
        surround = s[2] + s[3]
        return upd([(0, s[0] + (-surround + bias)),
                    (1, s[1] + (surround + bias))])

    if key == (T.A52_3F2R, T.A52_STEREO):
        if slev_zero:
            common = s[1] + bias
            return upd([(0, s[0] + common), (1, s[2] + common)])
        common = s[1] + bias
        return upd([(0, s[0] + (common + s[3])),
                    (1, common + s[2] + s[4])])

    if key == (T.A52_3F2R, T.A52_DOLBY):
        common = s[1] + bias
        surround = s[3] + s[4]
        return upd([(0, s[0] + (common - surround)),
                    (1, s[2] + common + surround)])

    if key == (T.A52_3F1R, T.A52_3F):
        # mix21to2(samples, samples+512): left=ch0, right=ch2, surround=ch3
        if slev_zero:
            return s
        common = s[3] + bias
        return upd([(0, s[0] + common), (2, s[2] + common)])

    if key == (T.A52_3F2R, T.A52_3F):
        if slev_zero:
            return s
        return upd([(0, s[0] + (s[3] + bias)), (2, s[2] + (s[4] + bias))])

    if key == (T.A52_3F1R, T.A52_2F1R):
        common = s[1] + bias
        return upd([(0, s[0] + common), (1, s[2] + common), (2, s[3])])

    if key == (T.A52_2F2R, T.A52_2F1R):
        return upd([(2, s[2] + (s[3] + bias))])

    if key == (T.A52_3F2R, T.A52_2F1R):
        common = s[1] + bias
        return upd([(0, s[0] + common), (1, s[2] + common),
                    (2, s[3] + s[4] + bias)])

    if key == (T.A52_3F2R, T.A52_3F1R):
        return upd([(3, s[3] + (s[4] + bias))])

    if key == (T.A52_2F1R, T.A52_2F2R):
        return upd([(3, s[2])])

    if key == (T.A52_3F1R, T.A52_2F2R):
        common = s[1] + bias
        return upd([(0, s[0] + common), (1, s[2] + common), (2, s[3])])

    if key == (T.A52_3F2R, T.A52_2F2R):
        common = s[1] + bias
        return upd([(0, s[0] + common), (1, s[2] + common),
                    (2, s[3]), (3, s[4])])

    if key == (T.A52_3F1R, T.A52_3F2R):
        return upd([(4, s[3])])

    return s  # identity pairs


def upmix(planes: torch.Tensor, acmod: int, output: int) -> torch.Tensor:
    """a52_upmix (downmix.c:621-685): undo the in-place downmix layout."""
    out = output & _CM
    key = (acmod, out)
    s = planes
    z = torch.zeros_like(s[0])

    def upd(idx_vals):
        return _apply(s, idx_vals)

    if key == (T.A52_CHANNEL, T.A52_CHANNEL2):
        return upd([(1, s[0])])

    if out == T.A52_MONO:
        nf = int(T.NFCHANS[acmod])
        return upd([(i, z) for i in range(1, nf)])

    if out in (T.A52_STEREO, T.A52_DOLBY):
        if acmod in (T.A52_3F, T.A52_3F1R, T.A52_3F2R):
            ops = [(2, s[1]), (1, z)]
            if acmod in (T.A52_3F1R, T.A52_3F2R):
                ops = [(3, z)] + ops
            if acmod == T.A52_3F2R:
                ops = [(4, z)] + ops
            return upd(ops)
        if acmod in (T.A52_2F1R, T.A52_2F2R):
            ops = [(2, z)]
            if acmod == T.A52_2F2R:
                ops = [(3, z)] + ops
            return upd(ops)
        return s

    if key in ((T.A52_3F1R, T.A52_3F), (T.A52_2F2R, T.A52_2F1R)):
        return upd([(3, z)])
    if key == (T.A52_3F2R, T.A52_3F):
        return upd([(4, z), (3, z)])
    if key == (T.A52_3F2R, T.A52_3F1R):
        return upd([(4, z)])

    if key == (T.A52_3F1R, T.A52_2F1R):
        return upd([(3, s[2]), (2, s[1]), (1, z)])
    if key == (T.A52_3F2R, T.A52_2F1R):
        return upd([(4, z), (3, s[2]), (2, s[1]), (1, z)])
    if key == (T.A52_3F2R, T.A52_2F2R):
        return upd([(4, s[3]), (3, s[2]), (2, s[1]), (1, z)])

    return s
