"""Frame-header probe and output-mode negotiation (host side, numpy).

Only what ``BatchedDecoder`` needs to plan a chunk before the native
parser runs: ``syncinfo`` (liba52 parse.c:86-129) and ``downmix_init``
(downmix.c:34-160).  The per-frame Python parser is not part of the port.
"""
from __future__ import annotations

import numpy as np

from .. import tables as T

_F = np.float32


def syncinfo(buf: bytes):
    """Probe a 7-byte header.  Returns (framesize, flags, srate, bitrate)
    or (0, 0, 0, 0) when out of sync.  Parity: parse.c:86-129."""
    if len(buf) < 7 or buf[0] != 0x0B or buf[1] != 0x77:
        return 0, 0, 0, 0
    if buf[5] >= 0x60:
        return 0, 0, 0, 0
    half = int(T.HALFRATE[buf[5] >> 3])
    acmod = buf[6] >> 5
    lfeon_bit = (0x10, 0x10, 0x04, 0x04, 0x04, 0x01, 0x04, 0x01)[acmod]
    flags = (T.A52_DOLBY if (buf[6] & 0xF8) == 0x50 else acmod) \
        | (T.A52_LFE if (buf[6] & lfeon_bit) else 0)
    frmsizecod = buf[4] & 63
    if frmsizecod >= 38:
        return 0, 0, 0, 0
    bitrate = int(T.BIT_RATES[frmsizecod >> 1])
    fscod = buf[4] >> 6
    if fscod == 3:
        return 0, 0, 0, 0
    size = T.frame_size_bytes(fscod, frmsizecod)
    return size, flags, int(T.SAMPLE_RATES[fscod]) >> half, (bitrate * 1000) >> half


# rows: requested output 0..10; cols: input acmod 0..7 (downmix.c:37-60)
_DOWNMIX_TABLE = np.array([
    [T.A52_CHANNEL, T.A52_DOLBY, T.A52_STEREO, T.A52_STEREO,
     T.A52_STEREO, T.A52_STEREO, T.A52_STEREO, T.A52_STEREO],
    [T.A52_MONO] * 8,
    [T.A52_CHANNEL, T.A52_DOLBY, T.A52_STEREO, T.A52_STEREO,
     T.A52_STEREO, T.A52_STEREO, T.A52_STEREO, T.A52_STEREO],
    [T.A52_CHANNEL, T.A52_DOLBY, T.A52_STEREO, T.A52_3F,
     T.A52_STEREO, T.A52_3F, T.A52_STEREO, T.A52_3F],
    [T.A52_CHANNEL, T.A52_DOLBY, T.A52_STEREO, T.A52_STEREO,
     T.A52_2F1R, T.A52_2F1R, T.A52_2F1R, T.A52_2F1R],
    [T.A52_CHANNEL, T.A52_DOLBY, T.A52_STEREO, T.A52_STEREO,
     T.A52_2F1R, T.A52_3F1R, T.A52_2F1R, T.A52_3F1R],
    [T.A52_CHANNEL, T.A52_DOLBY, T.A52_STEREO, T.A52_3F,
     T.A52_2F2R, T.A52_2F2R, T.A52_2F2R, T.A52_2F2R],
    [T.A52_CHANNEL, T.A52_DOLBY, T.A52_STEREO, T.A52_3F,
     T.A52_2F2R, T.A52_3F2R, T.A52_2F2R, T.A52_3F2R],
    [T.A52_CHANNEL1, T.A52_MONO] + [T.A52_MONO] * 6,
    [T.A52_CHANNEL2, T.A52_MONO] + [T.A52_MONO] * 6,
    [T.A52_CHANNEL, T.A52_DOLBY, T.A52_STEREO, T.A52_DOLBY,
     T.A52_DOLBY, T.A52_DOLBY, T.A52_DOLBY, T.A52_DOLBY],
], dtype=np.int32)


def downmix_init(input_mode: int, flags: int, level: float,
                 clev: float, slev: float):
    """Returns (output_mode, adjusted_level) or (-1, level) on error."""
    output = flags & T.A52_CHANNEL_MASK
    if output > T.A52_DOLBY:
        return -1, level
    output = int(_DOWNMIX_TABLE[output][input_mode & 7])
    # NB: the reference compares the float clev against the *double*
    # LEVEL_3DB literal (downmix.c:70), so the 3F promotion can never fire
    # in the float build; the comparison is replayed literally.
    if output == T.A52_STEREO and (
            input_mode == T.A52_DOLBY
            or (input_mode == T.A52_3F and float(clev) == T.LEVEL_3DB)):
        output = T.A52_DOLBY

    if flags & T.A52_ADJUST_LEVEL:
        # Exact type replay of the reference's DIV()/LEVEL() macros
        # (downmix.c:73-157): `DIV(1, ...)` with float operands is a float
        # division, double literals promote the whole expression to double,
        # and inner (1+clev) sums happen in float.
        inp = input_mode & 7
        key = (inp, output)
        c = _F(clev)
        s = _F(slev)
        L3, LP3 = T.LEVEL_3DB, T.LEVEL_PLUS3DB   # double constants
        f1 = _F(1.0)
        adjust = None
        if key == (T.A52_3F, T.A52_MONO):
            adjust = _F(L3 / float(f1 + c))
        elif key in ((T.A52_STEREO, T.A52_MONO), (T.A52_2F2R, T.A52_2F1R),
                     (T.A52_3F2R, T.A52_3F1R)):
            adjust = _F(L3)
        elif key == (T.A52_3F2R, T.A52_2F1R):
            adjust = _F(L3) if c < _F(T.LEVEL_PLUS3DB - 1) \
                else _F(f1 / (f1 + c))                     # float division
        elif key in ((T.A52_3F, T.A52_STEREO), (T.A52_3F1R, T.A52_2F1R),
                     (T.A52_3F1R, T.A52_2F2R), (T.A52_3F2R, T.A52_2F2R)):
            adjust = _F(f1 / (f1 + c))                     # float division
        elif key == (T.A52_2F1R, T.A52_MONO):
            adjust = _F(LP3 / float(_F(2.0) + s))
        elif key in ((T.A52_2F1R, T.A52_STEREO), (T.A52_3F1R, T.A52_3F)):
            adjust = _F(1.0 / (1.0 + float(s) * L3))
        elif key == (T.A52_3F1R, T.A52_MONO):
            adjust = _F(L3 / (float(f1 + c) + float(s) * 0.5))
        elif key == (T.A52_3F1R, T.A52_STEREO):
            adjust = _F(1.0 / (float(f1 + c) + float(s) * L3))
        elif key == (T.A52_2F2R, T.A52_MONO):
            adjust = _F(L3 / float(f1 + s))
        elif key in ((T.A52_2F2R, T.A52_STEREO), (T.A52_3F2R, T.A52_3F)):
            adjust = _F(f1 / (f1 + s))                     # float division
        elif key == (T.A52_3F2R, T.A52_MONO):
            adjust = _F(L3 / float(f1 + c + s))
        elif key == (T.A52_3F2R, T.A52_STEREO):
            adjust = _F(f1 / (f1 + c + s))                 # float division
        elif key == (T.A52_MONO, T.A52_DOLBY):
            adjust = _F(LP3)
        elif key in ((T.A52_3F, T.A52_DOLBY), (T.A52_2F1R, T.A52_DOLBY)):
            adjust = _F(1.0 / (1.0 + L3))
        elif key in ((T.A52_3F1R, T.A52_DOLBY), (T.A52_2F2R, T.A52_DOLBY)):
            adjust = _F(1.0 / (1.0 + 2.0 * L3))
        elif key == (T.A52_3F2R, T.A52_DOLBY):
            adjust = _F(1.0 / (1.0 + 3.0 * L3))
        if adjust is not None:
            level = _F(_F(level) * adjust)
    return output, _F(level)
