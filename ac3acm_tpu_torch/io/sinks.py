"""Audio output sinks (libao parity: audio_out_*.c).

Every sink implements the {setup, play, close} contract of the reference's
ao drivers (include/audio_out.h:26-33): `setup` picks the output mode /
level / bias for the decoder, `play` consumes one block of planar samples.

Channel interleave orders are the reference's exactly
(libao/convert2s16.c: convert2s16_wav / convert2s16_multi), including the
LFE-first plane convention and the wav speaker-mask table
(audio_out_wav.c:91-106).  A copy of the JAX package's sinks: they take
numpy planes, whatever device decoded them.
"""
from __future__ import annotations

import os
import struct
import sys

import numpy as np

from .. import tables as T

# plane order per output mode for wav-style interleave (convert2s16_wav):
# value = source plane index for each interleaved slot.
WAV_ORDER = {
    T.A52_MONO: [0], T.A52_CHANNEL1: [0], T.A52_CHANNEL2: [0],
    T.A52_CHANNEL: [0, 1], T.A52_STEREO: [0, 1], T.A52_DOLBY: [0, 1],
    T.A52_3F: [0, 2, 1],
    T.A52_2F1R: [0, 1, 2],
    T.A52_3F1R: [0, 2, 1, 3],
    T.A52_2F2R: [0, 1, 2, 3],
    T.A52_3F2R: [0, 2, 1, 3, 4],
    T.A52_MONO | T.A52_LFE: [1, 0],
    T.A52_CHANNEL1 | T.A52_LFE: [1, 0], T.A52_CHANNEL2 | T.A52_LFE: [1, 0],
    T.A52_CHANNEL | T.A52_LFE: [1, 2, 0],
    T.A52_STEREO | T.A52_LFE: [1, 2, 0], T.A52_DOLBY | T.A52_LFE: [1, 2, 0],
    T.A52_3F | T.A52_LFE: [1, 3, 2, 0],
    T.A52_2F1R | T.A52_LFE: [1, 2, 0, 3],
    T.A52_3F1R | T.A52_LFE: [1, 3, 2, 0, 4],
    T.A52_2F2R | T.A52_LFE: [1, 2, 0, 3, 4],
    T.A52_3F2R | T.A52_LFE: [1, 3, 2, 0, 4, 5],
}

# WAVE speaker masks per mode (audio_out_wav.c:93-95)
SPEAKER_TBL = [3, 4, 3, 7, 0x103, 0x107, 0x33, 0x37, 4, 4, 3]


def convert_s16(planes: np.ndarray, flags: int) -> np.ndarray:
    """Planar biased(+384) float32 [nch, 256] -> interleaved int16 in the
    wav channel order (the reference's IEEE bias-trick clip semantics)."""
    order = WAV_ORDER[flags & (T.A52_CHANNEL_MASK | T.A52_LFE)]
    x = planes[order]                        # [nout, 256]
    i16 = np.clip(np.round((x.astype(np.float64) - 384.0) * 32768.0),
                  -32768, 32767).astype(np.int16)
    return i16.T.reshape(-1)                 # interleaved


class Sink:
    name = "sink"

    def setup(self, sample_rate: int):
        """-> (flags, level, bias) requested from the decoder."""
        raise NotImplementedError

    def play(self, flags: int, planes: np.ndarray):
        raise NotImplementedError

    def close(self):
        pass


class FloatSink(Sink):
    """Raw float32 stereo (the regression-test oracle; audio_out_float.c)."""
    name = "float"

    def __init__(self, fp=None):
        self.fp = fp or sys.stdout.buffer

    def setup(self, sample_rate):
        return T.A52_STEREO, 1.0, 0.0

    def play(self, flags, planes):
        self.fp.write(planes[:2].T.astype("<f4").tobytes())


class NullSink(Sink):
    name = "null"

    def __init__(self, flags=T.A52_STEREO):
        self.flags = flags
        self.blocks = 0

    def setup(self, sample_rate):
        return self.flags, 1.0, 384.0

    def play(self, flags, planes):
        self.blocks += 1


class PeakSink(Sink):
    """Max-amplitude meter (audio_out_peak.c)."""
    name = "peak"

    def __init__(self, flags=T.A52_STEREO):
        self.flags = flags
        self.peak = 0.0

    def setup(self, sample_rate):
        return self.flags, 1.0, 0.0

    def play(self, flags, planes):
        self.peak = max(self.peak, float(np.abs(planes).max()))

    def close(self):
        print(f"peak: {self.peak:.6f} ({self.peak * 32768:.1f}/32768)",
              file=sys.stderr)


class WavSink(Sink):
    """RIFF/WAVE writer incl. the 6-channel WAVEFORMATEXTENSIBLE header."""
    name = "wav"

    def __init__(self, fp, flags=T.A52_STEREO):
        self.fp = fp
        self.flags = flags
        self.sample_rate = 48000
        self.data_bytes = 0
        self.nch = None

    def setup(self, sample_rate):
        self.sample_rate = sample_rate
        return self.flags, 1.0, 384.0

    def _header(self, nch: int) -> bytes:
        sr = self.sample_rate
        speaker = SPEAKER_TBL[self.flags & T.A52_CHANNEL_MASK]
        if self.flags & T.A52_LFE:
            speaker |= 8
        data = 0xFFFFFFFF - 100 if self.data_bytes == 0 else self.data_bytes
        if nch > 2:
            fmt = struct.pack("<HHIIHHHHI16s", 0xFFFE, nch, sr, sr * 2 * nch,
                              2 * nch, 16, 22, 16, speaker,
                              b"\x01\x00\x00\x00\x00\x00\x10\x00"
                              b"\x80\x00\x00\xaa\x00\x38\x9b\x71")
        else:
            fmt = struct.pack("<HHIIHH", 1, nch, sr, sr * 2 * nch, 2 * nch, 16)
        hdr = b"RIFF" + struct.pack("<I", data + 20 + len(fmt)) + b"WAVE" \
            + b"fmt " + struct.pack("<I", len(fmt)) + fmt \
            + b"data" + struct.pack("<I", data)
        return hdr

    def play(self, flags, planes):
        i16 = convert_s16(planes, flags)
        if self.nch is None:
            self.nch = planes.shape[0]
            self.fp.write(self._header(self.nch))
        self.fp.write(i16.astype("<i2").tobytes())
        self.data_bytes += i16.nbytes

    def close(self):
        if self.nch is not None and self.fp.seekable():
            self.fp.seek(0)
            self.fp.write(self._header(self.nch))


class AifSink(Sink):
    """AIFF (big-endian) stereo writer (audio_out_aif.c)."""
    name = "aif"

    def __init__(self, fp, flags=T.A52_STEREO):
        self.fp = fp
        self.flags = flags
        self.sample_rate = 48000
        self.frames = 0
        self.started = False

    def setup(self, sample_rate):
        self.sample_rate = sample_rate
        return self.flags, 1.0, 384.0

    def _header(self):
        # the sample rate as an 80-bit extended float: the integer
        # normalized into a 32-bit mantissa
        sr = self.sample_rate
        m = sr
        e = 16383 + 31
        while not (m & 0x80000000):
            m <<= 1
            e -= 1
        ext = struct.pack(">HII", e, m, 0)
        nch = 2
        nbytes = self.frames * 2 * nch
        comm = b"COMM" + struct.pack(">IhIh", 18, nch, self.frames, 16) + ext
        ssnd = b"SSND" + struct.pack(">III", nbytes + 8, 0, 0)
        total = 4 + len(comm) + len(ssnd) + nbytes
        return b"FORM" + struct.pack(">I", total) + b"AIFF" + comm + ssnd

    def play(self, flags, planes):
        if not self.started:
            self.started = True
            self.fp.write(self._header())
        i16 = convert_s16(planes, flags)[: 2 * 256]
        self.fp.write(i16.astype(">i2").tobytes())
        self.frames += 256

    def close(self):
        if self.started and self.fp.seekable():
            self.fp.seek(0)
            self.fp.write(self._header())


class OssSink(Sink):
    """Live playback through OSS (/dev/dsp; audio_out_oss.c parity).

    Registered only when the device exists -- the reference compiles its
    platform drivers (oss/solaris/al/win) per-OS and the registry simply
    omits the rest (libao/audio_out.c:56-96); we gate at runtime instead.
    """
    name = "oss"

    def __init__(self, flags=T.A52_STEREO, device="/dev/dsp"):
        import ossaudiodev
        self.flags = flags
        self.dev = ossaudiodev.open(device, "w")
        self.dev.setfmt(ossaudiodev.AFMT_S16_LE)
        self.rate = None

    def setup(self, sample_rate):
        nch = 2
        if (self.flags & T.A52_CHANNEL_MASK) == T.A52_MONO:
            nch = 1
        self.dev.channels(nch)
        if self.rate != sample_rate:            # mode renegotiation (oss:123)
            self.dev.speed(sample_rate)
            self.rate = sample_rate
        return self.flags, 1.0, 384.0

    def play(self, flags, planes):
        self.dev.write(convert_s16(planes, flags).astype("<i2").tobytes())

    def close(self):
        self.dev.close()


def _have_oss() -> bool:
    try:
        import ossaudiodev  # noqa: F401
    except ImportError:
        return False
    return os.path.exists("/dev/dsp")


def make_sink(name: str, fp=None):
    """ao_drivers() registry parity (libao/audio_out.c:56-96)."""
    base = {
        "float": lambda: FloatSink(fp),
        "floatdolby": lambda: FloatSink(fp),
        "null": lambda: NullSink(T.A52_STEREO),
        "null4": lambda: NullSink(T.A52_2F2R),
        "null6": lambda: NullSink(T.A52_3F2R | T.A52_LFE),
        "peak": lambda: PeakSink(T.A52_STEREO),
        "peakdolby": lambda: PeakSink(T.A52_DOLBY),
        "wav": lambda: WavSink(fp, T.A52_STEREO),
        "wavdolby": lambda: WavSink(fp, T.A52_DOLBY),
        "wav6": lambda: WavSink(fp, T.A52_3F2R | T.A52_LFE),
        "aif": lambda: AifSink(fp, T.A52_STEREO),
        "aifdolby": lambda: AifSink(fp, T.A52_DOLBY),
    }
    if _have_oss():
        base.update({
            "oss": lambda: OssSink(T.A52_STEREO),
            "ossdolby": lambda: OssSink(T.A52_DOLBY),
        })
    if name not in base:
        raise ValueError(f"unknown output driver {name!r}; "
                         f"available: {', '.join(sorted(base))}")
    return base[name]()
