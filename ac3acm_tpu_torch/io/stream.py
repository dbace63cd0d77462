"""Streaming codec layer: the ACM driver shell reborn as a Python API.

Capability parity with src/AC3ACM.cpp minus the Windows plumbing:

  * the format model -- 342 AC-3 formats (3 rates x 6 channel configs x 19
    bitrates) and the PCM formats, with validation and the frame-size /
    nAvgBytesPerSec rules incl. the 44.1 kHz refinement
    (AC3ACM.cpp:113-163, 432-487, 958-967),
  * format_suggest in both directions with the 64/96 kbps-per-channel
    default-bitrate rule (AC3ACM.cpp:751-1029),
  * Ac3ToPcmStream: incremental decode with byte-wise resync, partial-frame
    input carry and undelivered-block output carry
    (stream_convert_ac3, AC3ACM.cpp:1430-1628),
  * PcmToAc3Stream: incremental encode with a partial-frame input carry
    (stream_convert_pcm) through the WAVE-order -> AC-3-order channel map
    (create_channel_map, AC3ACM.cpp:1631-1662),
  * the AC3ASM MapTab interleave orders for decoded PCM
    (AC3ASM.asm:39-117 and the CONVERTn comments).
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .. import tables as T
from ..utils.config import CodecConfig

SAMPLE_RATES = (32000, 44100, 48000)         # ACM ordering (srates[3])

# frame sizes in 16-bit words per (bitrate index, rate): generated from the
# framing formulas (equals AC3ACM.cpp's framesizes[19][4] table)
FRAMESIZES = np.array(
    [[T.frame_size_bytes(2, i << 1) // 2,    # 32 kHz
      T.frame_size_bytes(1, i << 1) // 2,    # 44.1 kHz (even parity)
      T.frame_size_bytes(0, i << 1) // 2,    # 48 kHz
      int(T.BIT_RATES[i])] for i in range(19)], dtype=np.int32)

# MapTab plane->interleave orders (AC3ASM.asm CONVERTn comments); key is the
# decoder output mode incl. LFE bit, value[i] = source plane for slot i.
ACM_ORDER = {
    T.A52_MONO: [0], T.A52_CHANNEL1: [0], T.A52_CHANNEL2: [0],
    T.A52_CHANNEL: [0, 1], T.A52_STEREO: [0, 1], T.A52_DOLBY: [0, 1],
    T.A52_MONO | T.A52_LFE: [1, 0],
    T.A52_STEREO | T.A52_LFE: [1, 2, 0],
    T.A52_DOLBY | T.A52_LFE: [1, 2, 0],
    T.A52_CHANNEL | T.A52_LFE: [1, 2, 0],
    T.A52_3F: [0, 2, 1],
    T.A52_2F1R: [0, 1, 2],
    T.A52_2F1R | T.A52_LFE: [1, 2, 0, 3],
    T.A52_3F | T.A52_LFE: [1, 3, 2, 0],
    T.A52_2F2R: [0, 1, 2, 3],
    T.A52_3F1R: [0, 2, 1, 3],
    T.A52_2F2R | T.A52_LFE: [1, 2, 0, 3, 4],
    T.A52_3F1R | T.A52_LFE: [1, 3, 2, 0, 4],
    T.A52_3F2R: [0, 2, 1, 3, 4],
    T.A52_3F2R | T.A52_LFE: [1, 3, 2, 0, 4, 5],
}

# WAVE interleave order -> AC-3 coded channel order (create_channel_map)
def create_channel_map(nch: int) -> np.ndarray:
    maps = {1: [0], 2: [0, 1], 4: [0, 1, 2, 3],
            3: [0, 2, 1], 5: [0, 2, 1, 3, 4], 6: [0, 2, 1, 4, 5, 3]}
    return np.array(maps[nch], dtype=np.int64)


@dataclass(frozen=True)
class Ac3Format:
    channels: int
    sample_rate: int
    bitrate: int          # kbit/s

    def __post_init__(self):
        if not self.is_valid():
            raise ValueError(f"invalid AC-3 format {self}")

    def is_valid(self) -> bool:
        return (1 <= self.channels <= 6
                and self.sample_rate in SAMPLE_RATES
                and self.bitrate in [int(b) for b in T.BIT_RATES])

    @property
    def block_align(self) -> int:
        i = [int(b) for b in T.BIT_RATES].index(self.bitrate)
        col = {32000: 0, 44100: 1, 48000: 2}[self.sample_rate]
        return int(FRAMESIZES[i][col]) * 2

    @property
    def avg_bytes_per_sec(self) -> int:
        # 44.1 kHz refinement (AC3ACM.cpp:958-967)
        if self.sample_rate == 44100:
            return (self.block_align * 44100 + 768) // 1536
        return self.bitrate * 125


@dataclass(frozen=True)
class PcmFormat:
    channels: int
    sample_rate: int
    bits: int = 16

    def is_valid(self) -> bool:
        return (1 <= self.channels <= 6 and self.sample_rate in SAMPLE_RATES
                and self.bits == 16)


def enumerate_ac3_formats():
    """All 342 standard AC-3 formats (formattag/format_details parity)."""
    for rate in (48000, 44100, 32000):
        for ch in range(1, 7):
            for b in T.BIT_RATES:
                yield Ac3Format(ch, rate, int(b))


def guess_frame_size(block_align: int = 0, avg_bytes: int = 0,
                     sample_rate: int = 48000) -> int:
    """ac3_framesize (AC3ACM.cpp:432-487): frame bytes from either field."""
    col = {32000: 0, 44100: 1, 48000: 2}[sample_rate]
    for i in range(19):
        size = int(FRAMESIZES[i][col]) * 2
        if block_align and block_align in (size, size + 2):
            return size
        if avg_bytes:
            if sample_rate == 44100:
                if avg_bytes == (size * 44100 + 768) // 1536:
                    return size
            elif avg_bytes == int(FRAMESIZES[i][3]) * 125:
                return size
    return 0


def suggest_pcm(src: Ac3Format, cfg: CodecConfig | None = None) -> PcmFormat:
    """AC3 -> PCM suggestion: same rate; stereo unless multichannel."""
    from ..utils.trace import log_format_negotiation
    cfg = cfg or CodecConfig()
    ch = src.channels if cfg.multichannel else min(src.channels, 2)
    dst = PcmFormat(channels=ch, sample_rate=src.sample_rate)
    log_format_negotiation("ac3->pcm", src, dst)
    return dst


def suggest_ac3(src: PcmFormat, cfg: CodecConfig | None = None) -> Ac3Format:
    """PCM -> AC3 suggestion: 64 or 96 kbps per channel (USE64 rule)."""
    from ..utils.trace import log_format_negotiation
    cfg = cfg or CodecConfig()
    per = 64 if cfg.default_bitrate_per_channel <= 64 else 96
    kbps = per * src.channels
    rates = [int(b) for b in T.BIT_RATES]
    kbps = min((b for b in rates if b >= kbps), default=640)
    dst = Ac3Format(src.channels, src.sample_rate, kbps)
    log_format_negotiation("pcm->ac3", src, dst)
    return dst


# ---------------------------------------------------------------------------
# streaming converters
# ---------------------------------------------------------------------------

class Ac3ToPcmStream:
    """Incremental AC-3 -> int16 PCM with resync + block carry.

    stream_convert_ac3 parity: level 1.0, bias 384, A52_ADJUST_LEVEL; output
    mode from the config flags (MULTICHANNEL / DOLBYSURROUND); byte-wise
    resync on damaged input; partial frames held across convert() calls.
    """

    def __init__(self, dst_channels: int | None = None,
                 cfg: CodecConfig | None = None, exact: bool = False,
                 device=None):
        """exact=True decodes with the order-exact filterbank (bit-identical
        float replay of the reference); the default is the matmul
        filterbank, as in the JAX package.  device: None -> the CUDA card
        (raises without one); "cpu" runs the plain PyTorch versions."""
        from ..models.decoder import Decoder
        self.cfg = cfg or CodecConfig()
        self.dec = Decoder(exact=exact, device=device)
        if not self.cfg.dynamic_range:
            self.dec.set_drc_enabled(False)
        self.buf = b""
        self.dst_channels = dst_channels

    def _request_flags(self, coded_flags: int) -> int:
        # AC3ACM.cpp:1519-1550 decision tree
        if self.dst_channels == 1:
            want = T.A52_MONO
        elif self.dst_channels == 2 or not self.cfg.multichannel:
            want = T.A52_DOLBY if self.cfg.dolby_surround else T.A52_STEREO
        else:
            want = coded_flags
        return want | T.A52_ADJUST_LEVEL

    def convert(self, data: bytes) -> np.ndarray:
        """Feed bytes; returns interleaved int16 [n, nch] (may be empty)."""
        from ..host.parse import syncinfo
        from ..utils.trace import log as _tracelog
        self.buf += data
        frames = []
        coded_flags = None
        pos = 0
        skipped = 0
        while pos + 7 <= len(self.buf):
            size, flags, _, _ = syncinfo(self.buf[pos:pos + 7])
            if size == 0:
                pos += 1
                skipped += 1
                continue
            if pos + size > len(self.buf):
                break
            if coded_flags is None:
                coded_flags = flags
            frames.append(self.buf[pos:pos + size])
            pos += size
        self.buf = self.buf[pos:]
        if skipped:
            # AC3ACM_LOGFILE analogue of the byte-wise resync scan
            _tracelog.info("resync: skipped %d bytes to next syncword",
                           skipped)
        if not frames:
            return np.zeros((0, self.dst_channels or 2), np.int16)
        req = self._request_flags(coded_flags)
        _tracelog.debug("decode stream: coded_flags=%#x request=%#x "
                        "frames=%d", coded_flags, req, len(frames))
        pcm, fmt = self.dec.decode_frames(frames, req, level=1.0, bias=384.0)
        order = ACM_ORDER[fmt.output & (T.A52_CHANNEL_MASK | T.A52_LFE)]
        planes = pcm[:, order, :]                       # [nblk, nch, 256]
        x = (planes.astype(np.float64) - 384.0) * 32768.0
        i16 = np.clip(np.round(x), -32768, 32767).astype(np.int16)
        return i16.transpose(0, 2, 1).reshape(-1, len(order))


class PcmToAc3Stream:
    """Incremental int16 PCM -> AC-3 (stream_convert_pcm parity).

    device: None -> the CUDA card (raises without one); "cpu" runs the
    plain PyTorch path."""

    def __init__(self, fmt: Ac3Format, cfg: CodecConfig | None = None,
                 device=None):
        from ..models.encoder import Encoder
        self.fmt = fmt
        self.chmap = create_channel_map(fmt.channels)
        self.enc = Encoder(fmt.sample_rate, fmt.bitrate * 1000, fmt.channels,
                           chmap=self.chmap, device=device)
        self.carry = np.zeros((0, fmt.channels), np.int16)

    def convert(self, pcm: np.ndarray) -> bytes:
        """Feed interleaved int16 [n, nch] in WAVE channel order."""
        pcm = np.concatenate([self.carry, np.asarray(pcm, np.int16)], axis=0)
        nfr = pcm.shape[0] // T.FRAME_SAMPLES
        out = self.enc.encode(pcm[: nfr * T.FRAME_SAMPLES]) if nfr else b""
        self.carry = pcm[nfr * T.FRAME_SAMPLES:]
        return out


def stream_copy(data: bytes, dst_capacity: int | None = None) -> bytes:
    """Same-format passthrough (stream_copy, AC3ACM.cpp:1801-1826): when
    source and destination formats match, conversion is a bounded copy."""
    if dst_capacity is not None and len(data) > dst_capacity:
        return bytes(data[:dst_capacity])
    return bytes(data)


def stream_size(src_is_ac3: bool, src_len: int, ac3: Ac3Format,
                pcm: PcmFormat, query_source: bool = True) -> int:
    """Worst-case buffer math (stream_size, AC3ACM.cpp:2139-2363).

    query_source=True: given a source buffer of src_len bytes, the
    destination size needed to hold all converted data.
    query_source=False: given a destination of src_len bytes, the largest
    source buffer size it can absorb.
    """
    frame_len = ac3.block_align
    pcm_frame = T.FRAME_SAMPLES * pcm.channels * 2
    if query_source:
        if src_is_ac3:
            nfr = max((src_len + frame_len - 1) // frame_len, 1)
            return nfr * pcm_frame
        nfr = max((src_len + pcm_frame - 1) // pcm_frame, 1)
        # +1 frame of slack for the partial-input carry
        return (nfr + 1) * frame_len
    if src_is_ac3:
        nfr = max(src_len // pcm_frame, 1)
        return nfr * frame_len
    nfr = max(src_len // frame_len, 1)
    return nfr * pcm_frame
