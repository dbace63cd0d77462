"""Host pre-pass: AC-3 frame parsing into dense per-block tensors.

This is the serial, bit-granular half of the decoder (syncinfo, BSI,
side-info, exponents, bit allocation, mantissa-code extraction, dither
LFSR).  It emits, per block, dense arrays the device path consumes:

    freq[ch, k] = (q[ch, k] * a[ch, k]) * b[ch, k]

where the (q, a, b) factorization preserves the reference's exact float32
multiplication orderings (liba52 parse.c:321-334 COEFF and the coupling
paths at parse.c:435-556), so the device reconstruction is bit-exact.

Behavioural parity references: a52dec-0.7.5-cvs/liba52/
parse.c (a52_syncinfo:86, a52_frame:131, a52_block:558, coeff_get:336,
coeff_get_coupling:435) and downmix.c (a52_downmix_init:34,
a52_downmix_coeff:162).  The implementation is original: one spec-form
allocator, dataclass state, dense outputs.

The per-coefficient walk is plain Python and numpy: this is the
oracle-grade parser (``BatchedDecoder(parser="python" | "raw_py")``,
``models.decoder.Decoder``); the throughput path is the native parser
(host.native).
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from .. import tables as T
from .alloc import bit_allocate, decode_side_params, decode_snroffset
from .bitio import BitReader

SF32 = T.SCALE_FACTOR.astype(np.float32)
_F = np.float32

# quantizer LUTs in float32 (values are integers; exact in f32)
Q10, Q11, Q12 = (t.astype(np.float32) for t in (T.Q_1_0, T.Q_1_1, T.Q_1_2))
Q20, Q21, Q22 = (t.astype(np.float32) for t in (T.Q_2_0, T.Q_2_1, T.Q_2_2))
Q3 = T.Q_3.astype(np.float32)
Q40, Q41 = T.Q_4_0.astype(np.float32), T.Q_4_1.astype(np.float32)
Q5 = T.Q_5.astype(np.float32)

_REMATRIX_BAND = (25, 37, 61, 253)


class FrameError(ValueError):
    """Malformed frame side-info (maps to liba52 returning 1)."""


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


# ---------------------------------------------------------------------------
# Output-mode negotiation (downmix.c:34-160)
# ---------------------------------------------------------------------------

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
    # in the float build; we replay that comparison literally.
    if output == T.A52_STEREO and (
            input_mode == T.A52_DOLBY
            or (input_mode == T.A52_3F and float(clev) == T.LEVEL_3DB)):
        output = T.A52_DOLBY

    if flags & T.A52_ADJUST_LEVEL:
        # Exact type replay of the reference's DIV()/LEVEL() macro soup
        # (downmix.c:73-157): `DIV(1, ...)` with float operands is a *float*
        # division, double literals promote the whole expression to double,
        # and inner (1+clev) sums happen in float.  Each deviation is 1 ulp
        # of output, so the types below are load-bearing.
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


def downmix_coeff(acmod: int, output: int, level, clev, slev):
    """Per-channel frequency/time mix levels (downmix.c:162-330).

    Returns (coeff[5] float32, chanbias bitmask) or raises FrameError.
    """
    level = _F(level)
    lvl3 = _F(float(level) * T.LEVEL_3DB)     # MUL_C(level, LEVEL_3DB)
    coeff = np.zeros(5, dtype=np.float32)
    out = output & T.A52_CHANNEL_MASK
    key = (acmod, out)

    def m(a, b):          # MUL_L: float32 * float32
        return _F(_F(a) * _F(b))

    def mc(a, c):         # MUL_C: float32 * double-constant
        return _F(float(_F(a)) * c)

    same = {(T.A52_CHANNEL, T.A52_CHANNEL), (T.A52_MONO, T.A52_MONO),
            (T.A52_STEREO, T.A52_STEREO), (T.A52_3F, T.A52_3F),
            (T.A52_2F1R, T.A52_2F1R), (T.A52_3F1R, T.A52_3F1R),
            (T.A52_2F2R, T.A52_2F2R), (T.A52_3F2R, T.A52_3F2R),
            (T.A52_STEREO, T.A52_DOLBY)}
    if key in same:
        coeff[:] = level
        return coeff, 0
    if key == (T.A52_CHANNEL, T.A52_MONO):
        coeff[0] = coeff[1] = mc(level, T.LEVEL_6DB)
        return coeff, 3
    if key == (T.A52_STEREO, T.A52_MONO):
        coeff[0] = coeff[1] = lvl3
        return coeff, 3
    if key == (T.A52_3F, T.A52_MONO):
        coeff[0] = coeff[2] = lvl3
        coeff[1] = mc(m(lvl3, clev), T.LEVEL_PLUS6DB)
        return coeff, 7
    if key == (T.A52_2F1R, T.A52_MONO):
        coeff[0] = coeff[1] = lvl3
        coeff[2] = m(lvl3, slev)
        return coeff, 7
    if key == (T.A52_2F2R, T.A52_MONO):
        coeff[0] = coeff[1] = lvl3
        coeff[2] = coeff[3] = m(lvl3, slev)
        return coeff, 15
    if key == (T.A52_3F1R, T.A52_MONO):
        coeff[0] = coeff[2] = lvl3
        coeff[1] = mc(m(lvl3, clev), T.LEVEL_PLUS6DB)
        coeff[3] = m(lvl3, slev)
        return coeff, 15
    if key == (T.A52_3F2R, T.A52_MONO):
        coeff[0] = coeff[2] = lvl3
        coeff[1] = mc(m(lvl3, clev), T.LEVEL_PLUS6DB)
        coeff[3] = coeff[4] = m(lvl3, slev)
        return coeff, 31
    if key == (T.A52_MONO, T.A52_DOLBY):
        coeff[0] = lvl3
        return coeff, 0
    if key == (T.A52_3F, T.A52_DOLBY):
        coeff[0] = coeff[2] = coeff[3] = coeff[4] = level
        coeff[1] = lvl3
        return coeff, 7
    if key in ((T.A52_3F, T.A52_STEREO), (T.A52_3F1R, T.A52_2F1R),
               (T.A52_3F2R, T.A52_2F2R)):
        coeff[0] = coeff[2] = coeff[3] = coeff[4] = level
        coeff[1] = m(level, clev)
        return coeff, 7
    if key == (T.A52_2F1R, T.A52_DOLBY):
        coeff[0] = coeff[1] = level
        coeff[2] = lvl3
        return coeff, 7
    if key == (T.A52_2F1R, T.A52_STEREO):
        coeff[0] = coeff[1] = level
        coeff[2] = m(lvl3, slev)
        return coeff, 7
    if key == (T.A52_3F1R, T.A52_DOLBY):
        coeff[0] = coeff[2] = level
        coeff[1] = coeff[3] = lvl3
        return coeff, 15
    if key == (T.A52_3F1R, T.A52_STEREO):
        coeff[0] = coeff[2] = level
        coeff[1] = m(level, clev)
        coeff[3] = m(lvl3, slev)
        return coeff, 15
    if key == (T.A52_2F2R, T.A52_DOLBY):
        coeff[0] = coeff[1] = level
        coeff[2] = coeff[3] = lvl3
        return coeff, 15
    if key == (T.A52_2F2R, T.A52_STEREO):
        coeff[0] = coeff[1] = level
        coeff[2] = coeff[3] = m(level, slev)
        return coeff, 15
    if key == (T.A52_3F2R, T.A52_DOLBY):
        coeff[0] = coeff[2] = level
        coeff[1] = coeff[3] = coeff[4] = lvl3
        return coeff, 31
    if key == (T.A52_3F2R, T.A52_2F1R):
        coeff[0] = coeff[2] = level
        coeff[1] = m(level, clev)
        coeff[3] = coeff[4] = lvl3
        return coeff, 31
    if key == (T.A52_3F2R, T.A52_STEREO):
        coeff[0] = coeff[2] = level
        coeff[1] = m(level, clev)
        coeff[3] = coeff[4] = m(level, slev)
        return coeff, 31
    if key == (T.A52_3F1R, T.A52_3F):
        coeff[0] = coeff[1] = coeff[2] = level
        coeff[3] = m(lvl3, slev)
        return coeff, 13
    if key == (T.A52_3F2R, T.A52_3F):
        coeff[0] = coeff[1] = coeff[2] = level
        coeff[3] = coeff[4] = m(level, slev)
        return coeff, 29
    if key == (T.A52_2F2R, T.A52_2F1R):
        coeff[0] = coeff[1] = level
        coeff[2] = coeff[3] = lvl3
        return coeff, 12
    if key == (T.A52_3F2R, T.A52_3F1R):
        coeff[0] = coeff[1] = coeff[2] = level
        coeff[3] = coeff[4] = lvl3
        return coeff, 24
    if key == (T.A52_2F1R, T.A52_2F2R):
        coeff[0] = coeff[1] = level
        coeff[2] = lvl3
        return coeff, 0
    if key == (T.A52_3F1R, T.A52_2F2R):
        coeff[0] = coeff[2] = level
        coeff[1] = m(level, clev)
        coeff[3] = lvl3
        return coeff, 7
    if key == (T.A52_3F1R, T.A52_3F2R):
        coeff[0] = coeff[1] = coeff[2] = level
        coeff[3] = lvl3
        return coeff, 0
    if key == (T.A52_CHANNEL, T.A52_CHANNEL1):
        coeff[0] = level
        coeff[1] = 0
        return coeff, 0
    if key == (T.A52_CHANNEL, T.A52_CHANNEL2):
        coeff[0] = 0
        coeff[1] = level
        return coeff, 0
    raise FrameError(f"unreachable downmix pair {key}")


# ---------------------------------------------------------------------------
# Per-stream decoder state (the a52_state_t analogue; a pure-data pytree-able
# dataclass -- this is the checkpoint/resume unit)
# ---------------------------------------------------------------------------

@dataclass
class ChannelBA:
    bai: int = 0                    # fsnroffst[4] | fgaincod[3]
    deltbae: int = T.DELTA_BIT_NONE
    deltba: np.ndarray = field(default_factory=lambda: np.zeros(50, np.int8))


@dataclass
class DecoderState:
    fscod: int = 0
    halfrate: int = 0
    acmod: int = 0
    lfeon: int = 0
    clev: np.float32 = _F(0)
    slev: np.float32 = _F(0)
    output: int = 0
    level: np.float32 = _F(0)
    bias: np.float32 = _F(0)
    dynrnge: bool = True
    dynrng: np.float32 = _F(0)
    dynrng_call = None

    chincpl: int = 0
    phsflginu: int = 0
    cplstrtmant: int = 0
    cplendmant: int = 0
    cplbndstrc: int = 0
    cplstrtbnd: int = 0
    ncplbnd: int = 0
    cplco: np.ndarray = field(
        default_factory=lambda: np.zeros((5, 18), np.float32))
    rematflg: int = 0
    endmant: np.ndarray = field(default_factory=lambda: np.zeros(5, np.int32))
    bai: int = 0
    csnroffst: int = 0
    cplba: ChannelBA = field(default_factory=ChannelBA)
    ba: list = field(default_factory=lambda: [ChannelBA() for _ in range(5)])
    lfeba: ChannelBA = field(default_factory=ChannelBA)
    cplfleak: int = 0               # raw 3-bit code
    cplsleak: int = 0

    # deltba in effect at each row's LAST bit allocation (rows 0-4 fbw,
    # 5 cpl): the reference caches bap across blocks, so a frame-boundary
    # deltbae reset does NOT change bap until something re-dirties the
    # allocation -- raw-H2D meta must ship the cached-alloc inputs
    eff_deltba: np.ndarray = field(
        default_factory=lambda: np.zeros((7, 50), np.int8))

    cpl_exp: np.ndarray = field(default_factory=lambda: np.zeros(256, np.uint8))
    cpl_bap: np.ndarray = field(default_factory=lambda: np.zeros(256, np.int8))
    fbw_exp: np.ndarray = field(default_factory=lambda: np.zeros((5, 256), np.uint8))
    fbw_bap: np.ndarray = field(default_factory=lambda: np.zeros((5, 256), np.int8))
    lfe_exp: np.ndarray = field(default_factory=lambda: np.zeros(7, np.uint8))
    lfe_bap: np.ndarray = field(default_factory=lambda: np.zeros(7, np.int8))

    lfsr_state: int = 1
    downmixed: int = 1


@dataclass
class BlockData:
    """Dense device inputs for one block: freq[ch,k] = (q*a)*b."""
    q: np.ndarray            # [6, 256] float32, quantizer values
    a: np.ndarray            # [6, 256] float32
    b: np.ndarray            # [6, 256] float32
    blksw: np.ndarray        # [5] bool
    coeff: np.ndarray        # [5] float32 downmix levels for this block
    chanbias: int
    remat_mask: np.ndarray   # [256] bool (stereo rematrix flip band mask)
    lfe_scale: np.float32    # dynrng (level used for LFE coeffs)


@dataclass
class FrameData:
    acmod: int
    lfeon: int
    output: int
    nfchans: int
    bias: np.float32
    slev: np.float32
    blocks: list


class A52Parser:
    """Stateful per-stream parser (one instance ~ one a52_state_t)."""

    def __init__(self, record_raw: bool = False,
                 sideinfo_only: bool = False):
        self.s = DecoderState()
        # raw-H2D mode: record per-block bit offsets + resolved side-info so
        # the device can unpack mantissas straight from the frame bytes
        # (ops.unpack_device).  rec[-1] is the current block's meta dict.
        self.rec = [] if (record_raw or sideinfo_only) else None
        # sideinfo_only skips the per-coefficient mantissa walk entirely:
        # the bit cursor jumps over the mantissa field by a vectorized
        # width sum (same coded-order lattice as the device unpack) and
        # BlockData carries zero planes -- the device reconstructs them
        # from the raw bytes.  ~10x less host work per block.
        self.sideinfo_only = sideinfo_only

    # -- a52_frame ---------------------------------------------------------
    def frame(self, buf: bytes, flags: int, level: float, bias: float):
        s = self.s
        CLEV = [T.LEVEL_3DB, T.LEVEL_45DB, T.LEVEL_6DB, T.LEVEL_45DB]
        SLEV = [T.LEVEL_3DB, T.LEVEL_6DB, 0.0, T.LEVEL_6DB]
        s.fscod = buf[4] >> 6
        s.halfrate = int(T.HALFRATE[buf[5] >> 3])
        s.acmod = acmod = buf[6] >> 5
        br = BitReader(buf, start_bit=6 * 8)
        br.skip(3)
        if acmod == 2 and br.read(2) == 2:
            acmod = T.A52_DOLBY
        s.clev = _F(0)
        s.slev = _F(0)
        if (acmod & 1) and acmod != 1:
            s.clev = _F(CLEV[br.read(2)])
        if acmod & 4:
            s.slev = _F(SLEV[br.read(2)])
        s.lfeon = br.read(1)

        out, level = downmix_init(acmod, flags, level, s.clev, s.slev)
        if out < 0:
            raise FrameError("bad output mode")
        s.output = out
        if s.lfeon and (flags & T.A52_LFE):
            s.output |= T.A52_LFE
        s.level = _F(float(_F(level)) * 2.0)   # MUL_C(level, 2), imdct comp.
        s.dynrng = s.level
        s.bias = _F(bias)
        s.cplba.deltbae = T.DELTA_BIT_NONE
        for i in range(5):
            s.ba[i].deltbae = T.DELTA_BIT_NONE

        chaninfo = 1 if acmod == 0 else 0
        for _ in range(chaninfo + 1):
            br.skip(5)
            if br.read(1):
                br.skip(8)
            if br.read(1):
                br.skip(8)
            if br.read(1):
                br.skip(7)
        br.skip(2)
        if br.read(1):
            br.skip(14)
        if br.read(1):
            br.skip(14)
        if br.read(1):
            addbsil = br.read(6)
            br.skip(8 * (addbsil + 1))
        return br, s.output

    def decode_frame(self, buf: bytes, flags: int, level: float = 1.0,
                     bias: float = 0.0) -> FrameData:
        br, output = self.frame(buf, flags, level, bias)
        s = self.s
        blocks = [self._block(br) for _ in range(T.NB_BLOCKS)]
        return FrameData(acmod=s.acmod, lfeon=s.lfeon, output=s.output,
                         nfchans=int(T.NFCHANS[s.acmod]), bias=s.bias,
                         slev=s.slev, blocks=blocks)

    # -- dither ------------------------------------------------------------
    def _dither(self) -> np.float32:
        s = self.s
        lut = T.dither_lut()
        nstate = int(lut[s.lfsr_state >> 8] ^ ((s.lfsr_state << 8) & 0xFFFF))
        s.lfsr_state = nstate
        v = nstate - 65536 if nstate >= 32768 else nstate   # int16 view
        return _F((3 * v) >> 2)

    # -- coeff_get ---------------------------------------------------------
    def _coeff_get(self, br, q, a, b, ch, exp, bap, level, dither, end, quant):
        factor = np.empty(25, dtype=np.float32)
        np.multiply(SF32, _F(level), out=factor)
        for i in range(end):
            bp = int(bap[i])
            if bp == 0:
                if dither:
                    q[ch, i] = self._dither()
                    a[ch, i] = factor[exp[i]]
                    b[ch, i] = _F(1)
                continue
            if bp == 1:
                if quant["q1_ptr"] >= 0:
                    v = quant["q1"][quant["q1_ptr"]]
                    quant["q1_ptr"] -= 1
                else:
                    code = br.read(5)
                    quant["q1_ptr"] = 1
                    quant["q1"][0] = Q12[code]
                    quant["q1"][1] = Q11[code]
                    v = Q10[code]
            elif bp == 2:
                if quant["q2_ptr"] >= 0:
                    v = quant["q2"][quant["q2_ptr"]]
                    quant["q2_ptr"] -= 1
                else:
                    code = br.read(7)
                    quant["q2_ptr"] = 1
                    quant["q2"][0] = Q22[code]
                    quant["q2"][1] = Q21[code]
                    v = Q20[code]
            elif bp == 3:
                v = Q3[br.read(3)]
            elif bp == 4:
                if quant["q4_ptr"] == 0:
                    quant["q4_ptr"] = -1
                    v = quant["q4"]
                else:
                    code = br.read(7)
                    quant["q4_ptr"] = 0
                    quant["q4"] = Q41[code]
                    v = Q40[code]
            elif bp == 5:
                v = Q5[br.read(4)]
            else:
                nbits = int(T.BAP_BITS[bp])
                v = _F(br.read_signed(nbits) << (16 - nbits))
            q[ch, i] = v
            a[ch, i] = factor[exp[i]]
            b[ch, i] = _F(1)

    def _coeff_get_coupling(self, br, q, a, b, nfchans, coeff, dithflag, quant):
        s = self.s
        exp, bap = s.cpl_exp, s.cpl_bap
        cplco = np.zeros(5, dtype=np.float32)
        i = s.cplstrtmant
        bnd = 0
        cplbndstrc = s.cplbndstrc
        while i < s.cplendmant:
            i_end = i + 12
            while cplbndstrc & 1:
                cplbndstrc >>= 1
                i_end += 12
            cplbndstrc >>= 1
            for ch in range(nfchans):
                cplco[ch] = _F(s.cplco[ch][bnd] * coeff[ch])  # MUL_L
            bnd += 1
            while i < i_end:
                bp = int(bap[i])
                if bp == 0:
                    for ch in range(nfchans):
                        if (s.chincpl >> ch) & 1:
                            if dithflag[ch]:
                                # (scale_factor[exp] * cplco[ch]) * dither
                                q[ch, i] = self._dither()
                                a[ch, i] = _F(SF32[exp[i]] * cplco[ch])
                                b[ch, i] = _F(1)
                    i += 1
                    continue
                if bp == 1:
                    if quant["q1_ptr"] >= 0:
                        v = quant["q1"][quant["q1_ptr"]]
                        quant["q1_ptr"] -= 1
                    else:
                        code = br.read(5)
                        quant["q1_ptr"] = 1
                        quant["q1"][0] = Q12[code]
                        quant["q1"][1] = Q11[code]
                        v = Q10[code]
                elif bp == 2:
                    if quant["q2_ptr"] >= 0:
                        v = quant["q2"][quant["q2_ptr"]]
                        quant["q2_ptr"] -= 1
                    else:
                        code = br.read(7)
                        quant["q2_ptr"] = 1
                        quant["q2"][0] = Q22[code]
                        quant["q2"][1] = Q21[code]
                        v = Q20[code]
                elif bp == 3:
                    v = Q3[br.read(3)]
                elif bp == 4:
                    if quant["q4_ptr"] == 0:
                        quant["q4_ptr"] = -1
                        v = quant["q4"]
                    else:
                        code = br.read(7)
                        quant["q4_ptr"] = 0
                        quant["q4"] = Q41[code]
                        v = Q40[code]
                elif bp == 5:
                    v = Q5[br.read(4)]
                else:
                    nbits = int(T.BAP_BITS[bp])
                    v = _F(br.read_signed(nbits) << (16 - nbits))
                # samples[ch][i] = (cplcoeff=v*sf[exp]) * cplco[ch]
                for ch in range(nfchans):
                    if (s.chincpl >> ch) & 1:
                        q[ch, i] = v
                        a[ch, i] = SF32[exp[i]]
                        b[ch, i] = cplco[ch]
                i += 1

    # -- a52_block ----------------------------------------------------------
    def _block(self, br: BitReader) -> BlockData:
        s = self.s
        rec = None
        if self.rec is not None:
            # raw-H2D meta: bit offsets + resolved side-info per block so
            # the device can unpack mantissas from the frame bytes itself
            # (consumed by ops.unpack_device; all offsets frame-relative)
            rec = {
                "exp_off": np.full(7, -1, np.int32),      # 0-4 fbw, 5 cpl, 6 lfe
                "expstr": np.zeros(7, np.int32),
                "ngrps": np.zeros(7, np.int32),
                "cplco_off": np.full(5, -1, np.int32),
                "phs_off": -1,
                "raw_ok": True,
            }
            self.rec.append(rec)
        nfchans = int(T.NFCHANS[s.acmod])
        blksw = np.array([br.read(1) for _ in range(nfchans)], dtype=bool)
        blksw = np.concatenate([blksw, np.zeros(5 - nfchans, bool)])
        dithflag = [br.read(1) for _ in range(nfchans)]

        chaninfo = 1 if s.acmod == 0 else 0
        for _ in range(chaninfo + 1):
            if br.read(1):                      # dynrnge
                dynrng = br.read_signed(8)
                if s.dynrnge:
                    rng = _F(((dynrng & 0x1F) | 0x20) << 13) * SF32[3 - (dynrng >> 5)]
                    if s.dynrng_call is not None:
                        rng = _F(s.dynrng_call(rng))
                    s.dynrng = _F(s.level * _F(rng))

        if br.read(1):                          # cplstre
            s.chincpl = 0
            if br.read(1):                      # cplinu
                for i in range(nfchans):
                    s.chincpl |= br.read(1) << i
                if s.acmod in (0, 1):
                    raise FrameError("coupling in mono")
                if s.acmod == 2:
                    s.phsflginu = br.read(1)
                cplbegf = br.read(4)
                cplendf = br.read(4)
                if cplendf + 3 - cplbegf < 0:
                    raise FrameError("bad coupling band config")
                ncplsubnd = cplendf + 3 - cplbegf
                s.ncplbnd = ncplsubnd
                s.cplstrtbnd = int(T.CPL_BNDTAB[cplbegf])
                s.cplstrtmant = cplbegf * 12 + 37
                s.cplendmant = cplendf * 12 + 73
                s.cplbndstrc = 0
                for i in range(ncplsubnd - 1):
                    if br.read(1):
                        s.cplbndstrc |= 1 << i
                        s.ncplbnd -= 1

        if s.chincpl:
            cplcoe = 0
            for i in range(nfchans):
                if (s.chincpl >> i) & 1:
                    if br.read(1):              # cplcoe
                        cplcoe = 1
                        if rec is not None:
                            rec["cplco_off"][i] = br.pos
                        mstrcplco = 3 * br.read(2)
                        for j in range(s.ncplbnd):
                            cplcoexp = br.read(4)
                            cplcomant = br.read(4)
                            if cplcoexp == 15:
                                cplcomant <<= 14
                            else:
                                cplcomant = (cplcomant | 0x10) << 13
                            s.cplco[i][j] = _F(cplcomant) * SF32[cplcoexp + mstrcplco]
            if s.acmod == 2 and s.phsflginu and cplcoe:
                if rec is not None:
                    rec["phs_off"] = br.pos
                for j in range(s.ncplbnd):
                    if br.read(1):
                        s.cplco[1][j] = -s.cplco[1][j]

        if s.acmod == 2 and br.read(1):         # rematstr
            s.rematflg = 0
            end = s.cplstrtmant if s.chincpl else 253
            i = 0
            while True:
                s.rematflg |= br.read(1) << i
                if _REMATRIX_BAND[i] >= end:
                    break
                i += 1

        cplexpstr = T.EXP_REUSE
        lfeexpstr = T.EXP_REUSE
        if s.chincpl:
            cplexpstr = br.read(2)
        chexpstr = [br.read(2) for _ in range(nfchans)]
        if s.lfeon:
            lfeexpstr = br.read(1)

        for i in range(nfchans):
            if chexpstr[i] != T.EXP_REUSE:
                if (s.chincpl >> i) & 1:
                    s.endmant[i] = s.cplstrtmant
                else:
                    chbwcod = br.read(6)
                    if chbwcod > 60:
                        raise FrameError("bad chbwcod")
                    s.endmant[i] = chbwcod * 3 + 73

        do_bit_alloc = 0
        if cplexpstr != T.EXP_REUSE:
            do_bit_alloc = 64
            ncplgrps = (s.cplendmant - s.cplstrtmant) // (3 << (cplexpstr - 1))
            if rec is not None:
                rec["exp_off"][5] = br.pos
                rec["expstr"][5] = cplexpstr
                rec["ngrps"][5] = ncplgrps
            cplabsexp = br.read(4) << 1
            self._parse_exponents(br, cplexpstr, ncplgrps, cplabsexp,
                                  s.cpl_exp, s.cplstrtmant)
        for i in range(nfchans):
            if chexpstr[i] != T.EXP_REUSE:
                do_bit_alloc |= 1 << i
                grp_size = 3 << (chexpstr[i] - 1)
                nchgrps = (int(s.endmant[i]) + grp_size - 4) // grp_size
                if rec is not None:
                    rec["exp_off"][i] = br.pos
                    rec["expstr"][i] = chexpstr[i]
                    rec["ngrps"][i] = nchgrps
                s.fbw_exp[i][0] = br.read(4)
                self._parse_exponents(br, chexpstr[i], nchgrps,
                                      int(s.fbw_exp[i][0]), s.fbw_exp[i], 1)
                br.skip(2)                      # gainrng
        if lfeexpstr != T.EXP_REUSE:
            do_bit_alloc |= 32
            if rec is not None:
                rec["exp_off"][6] = br.pos
                rec["expstr"][6] = T.EXP_D15
                rec["ngrps"][6] = 2
            s.lfe_exp[0] = br.read(4)
            self._parse_exponents(br, lfeexpstr, 2, int(s.lfe_exp[0]),
                                  s.lfe_exp, 1)

        if br.read(1):                          # baie
            do_bit_alloc = 127
            s.bai = br.read(11)
        if br.read(1):                          # snroffste
            do_bit_alloc = 127
            s.csnroffst = br.read(6)
            if s.chincpl:
                s.cplba.bai = br.read(7)
            for i in range(nfchans):
                s.ba[i].bai = br.read(7)
            if s.lfeon:
                s.lfeba.bai = br.read(7)
        if s.chincpl and br.read(1):            # cplleake
            do_bit_alloc |= 64
            s.cplfleak = br.read(3)
            s.cplsleak = br.read(3)

        if br.read(1):                          # deltbaie
            do_bit_alloc = 127
            if s.chincpl:
                s.cplba.deltbae = br.read(2)
            for i in range(nfchans):
                s.ba[i].deltbae = br.read(2)
            if s.chincpl and s.cplba.deltbae == T.DELTA_BIT_NEW:
                self._parse_deltba(br, s.cplba.deltba)
            for i in range(nfchans):
                if s.ba[i].deltbae == T.DELTA_BIT_NEW:
                    self._parse_deltba(br, s.ba[i].deltba)

        if do_bit_alloc:
            if self._zero_snr_offsets(nfchans):
                s.cpl_bap[:] = 0
                s.fbw_bap[:] = 0
                s.lfe_bap[:] = 0
            else:
                params = decode_side_params(s.bai, s.halfrate)
                if s.chincpl and (do_bit_alloc & 64):
                    s.eff_deltba[5] = (
                        s.cplba.deltba
                        if s.cplba.deltbae != T.DELTA_BIT_NONE else 0)
                    s.cpl_bap[:] = bit_allocate(
                        s.cpl_exp, s.cplstrtmant, s.cplendmant,
                        decode_snroffset(s.csnroffst, s.cplba.bai >> 3),
                        int(T.FGAINTAB[s.cplba.bai & 7]),
                        fscod=s.fscod, halfratecod=s.halfrate,
                        cplfleak=s.cplfleak, cplsleak=s.cplsleak,
                        deltba=(s.cplba.deltba
                                if s.cplba.deltbae != T.DELTA_BIT_NONE else None),
                        **params)
                for i in range(nfchans):
                    if do_bit_alloc & (1 << i):
                        s.eff_deltba[i] = (
                            s.ba[i].deltba
                            if s.ba[i].deltbae != T.DELTA_BIT_NONE else 0)
                        s.fbw_bap[i][:] = bit_allocate(
                            s.fbw_exp[i], 0, int(s.endmant[i]),
                            decode_snroffset(s.csnroffst, s.ba[i].bai >> 3),
                            int(T.FGAINTAB[s.ba[i].bai & 7]),
                            fscod=s.fscod, halfratecod=s.halfrate,
                            deltba=(s.ba[i].deltba
                                    if s.ba[i].deltbae != T.DELTA_BIT_NONE else None),
                            **params)
                if s.lfeon and (do_bit_alloc & 32):
                    s.lfeba.deltbae = T.DELTA_BIT_NONE
                    exp7 = np.zeros(256, np.uint8)
                    exp7[:7] = s.lfe_exp
                    s.lfe_bap[:] = bit_allocate(
                        exp7, 0, 7,
                        decode_snroffset(s.csnroffst, s.lfeba.bai >> 3),
                        int(T.FGAINTAB[s.lfeba.bai & 7]),
                        is_lfe=True, fscod=s.fscod, halfratecod=s.halfrate,
                        **params)[:7]

        if br.read(1):                          # skiple
            br.skip(8 * br.read(9))

        coeff, chanbias = downmix_coeff(s.acmod, s.output, s.dynrng,
                                        s.clev, s.slev)

        if rec is not None:
            # resolved (post-REUSE) side-info the device allocator needs
            endm = s.endmant.copy()
            endm[nfchans:] = 0          # unused channels carry stale state
            rec.update(
                deltba=s.eff_deltba.copy(),
                acmod=s.acmod, output=s.output,      # host-only: fmt keys
                slev_zero=int(s.slev == 0.0),
                man_off=br.pos,
                endmant=endm,
                chincpl=s.chincpl, phsflginu=s.phsflginu,
                cplstrt=s.cplstrtmant, cplend=s.cplendmant,
                cplbndstrc=s.cplbndstrc, ncplbnd=s.ncplbnd,
                cplstrtbnd=s.cplstrtbnd,
                bai=s.bai, csnroffst=s.csnroffst,
                cplbai=s.cplba.bai,
                babai=np.array([s.ba[i].bai for i in range(5)], np.int32),
                lfebai=s.lfeba.bai,
                cplfleak=s.cplfleak, cplsleak=s.cplsleak,
                dith=np.array(dithflag + [0] * (5 - nfchans), np.int32),
                blksw=blksw[:5].astype(np.int32),
                coeff=coeff.copy(), chanbias=chanbias,
                rematflg=s.rematflg if s.acmod == 2 else 0,
                lfe_scale=s.dynrng, lfeon=s.lfeon,
                lfe_out=1 if (s.output & T.A52_LFE) else 0,
                fscod=s.fscod, halfrate=s.halfrate,
            )

        q = np.zeros((6, 256), dtype=np.float32)
        a = np.zeros((6, 256), dtype=np.float32)
        b = np.zeros((6, 256), dtype=np.float32)
        if self.sideinfo_only:
            # jump the cursor over the whole mantissa field: widths are a
            # pure function of (bap, endmant, coupling config) -- the same
            # coded-order lattice the device unpack rebuilds on chip
            br.skip(self._mantissa_bits())
            lfe_scale = s.dynrng if (s.lfeon and (s.output & T.A52_LFE)) \
                else _F(0)
            remat_mask = self._remat_mask()
            return BlockData(q=q, a=a, b=b, blksw=blksw, coeff=coeff,
                             chanbias=chanbias, remat_mask=remat_mask,
                             lfe_scale=lfe_scale)
        quant = {"q1_ptr": -1, "q2_ptr": -1, "q4_ptr": -1,
                 "q1": np.zeros(2, np.float32), "q2": np.zeros(2, np.float32),
                 "q4": _F(0)}
        done_cpl = False
        for i in range(nfchans):
            self._coeff_get(br, q, a, b, i, s.fbw_exp[i], s.fbw_bap[i],
                            coeff[i], dithflag[i], int(s.endmant[i]), quant)
            if (s.chincpl >> i) & 1 and not done_cpl:
                done_cpl = True
                self._coeff_get_coupling(br, q, a, b, nfchans, coeff,
                                         dithflag, quant)

        remat_mask = self._remat_mask()

        lfe_scale = _F(0)
        if s.lfeon:
            if s.output & T.A52_LFE:
                exp7 = np.zeros(256, np.uint8)
                exp7[:7] = s.lfe_exp
                bap7 = np.zeros(256, np.int8)
                bap7[:7] = s.lfe_bap
                self._coeff_get(br, q, a, b, 5, exp7, bap7, s.dynrng, 0, 7, quant)
                lfe_scale = s.dynrng
            else:
                tmp = np.zeros((6, 256), np.float32)
                exp7 = np.zeros(256, np.uint8)
                exp7[:7] = s.lfe_exp
                bap7 = np.zeros(256, np.int8)
                bap7[:7] = s.lfe_bap
                self._coeff_get(br, tmp, tmp, tmp, 0, exp7, bap7, 0, 0, 7, quant)

        return BlockData(q=q, a=a, b=b, blksw=blksw, coeff=coeff,
                         chanbias=chanbias, remat_mask=remat_mask,
                         lfe_scale=lfe_scale)

    # -- helpers -------------------------------------------------------------
    def _remat_mask(self) -> np.ndarray:
        """Stereo rematrix band mask per rematflg (parse.c:837-865)."""
        s = self.s
        remat_mask = np.zeros(256, dtype=bool)
        if s.acmod == 2:
            end = int(min(s.endmant[0], s.endmant[1]))
            j = 13
            rematflg = s.rematflg
            for bnd_i in range(4):
                band = _REMATRIX_BAND[bnd_i]
                if rematflg & (1 << bnd_i):
                    hi = min(band, end)
                    remat_mask[j:hi] = True
                j = band
                if j >= end:
                    break
        return remat_mask

    def _mantissa_bits(self) -> int:
        """Total bit width of the block's mantissa field, vectorized.

        Rebuilds the coded-order lattice (fbw channels with the coupling
        walk spliced after the first coupled channel, LFE last) and sums
        per-slot widths: grouped quantizers (bap 1/2/4) read a code only
        at group positions 0 mod 3/3/2 across the whole block
        (quantizer_set_t, parse.c:43-50); bap 0 reads nothing.  Mirrors
        ops.unpack_device.unpack_mantissas' width model."""
        s = self.s
        nfchans = int(T.NFCHANS[s.acmod])
        bins = np.arange(256)
        parts = []
        done_cpl = False
        for ch in range(nfchans):
            parts.append(np.where(bins < int(s.endmant[ch]),
                                  s.fbw_bap[ch], 0))
            if (s.chincpl >> ch) & 1 and not done_cpl:
                done_cpl = True
                actc = (bins >= s.cplstrtmant) & (bins < s.cplendmant)
                parts.append(np.where(actc, s.cpl_bap, 0))
        if s.lfeon:
            lfe = np.zeros(256, np.int32)
            lfe[:7] = s.lfe_bap
            parts.append(lfe)
        b = np.concatenate(parts).astype(np.int32)
        n1 = int((b == 1).sum())
        n2 = int((b == 2).sum())
        n4 = int((b == 4).sum())
        w = int(T.BAP_BITS[b].sum())     # plain classes; 0 for 0/1/2/4
        return (w + 5 * ((n1 + 2) // 3) + 7 * ((n2 + 2) // 3)
                + 7 * ((n4 + 1) // 2))

    @staticmethod
    def _parse_exponents(br, expstr, ngrps, exponent, dest, start):
        """parse.c:218-270; writes decoded exponents into dest[start:]."""
        fan = {T.EXP_D15: 1, T.EXP_D25: 2, T.EXP_D45: 4}[expstr]
        pos = start
        for _ in range(ngrps):
            exps = br.read(7)
            for delta_tab in (T.EXP_1, T.EXP_2, T.EXP_3):
                # the reference accumulates in a uint8_t (parse.c:218-231):
                # a negative-going delta wraps to ~255 and trips the >24
                # range check; replicate the wrap for rejection parity
                exponent = (exponent + int(delta_tab[exps])) & 0xFF
                if exponent > 24:
                    raise FrameError("exponent out of range")
                dest[pos:pos + fan] = exponent
                pos += fan

    @staticmethod
    def _parse_deltba(br, deltba):
        deltba[:] = 0
        deltnseg = br.read(3)
        j = 0
        for _ in range(deltnseg + 1):
            j += br.read(5)
            deltlen = br.read(4)
            delta = br.read(3)
            delta -= 3 if delta >= 4 else 4
            if not deltlen:
                continue
            if j + deltlen >= 50:
                raise FrameError("deltba overrun")
            deltba[j:j + deltlen] = delta
            j += deltlen

    def _zero_snr_offsets(self, nfchans: int) -> bool:
        s = self.s
        if s.csnroffst:
            return False
        if s.chincpl and (s.cplba.bai >> 3):
            return False
        if s.lfeon and (s.lfeba.bai >> 3):
            return False
        return all(not (s.ba[i].bai >> 3) for i in range(nfchans))
