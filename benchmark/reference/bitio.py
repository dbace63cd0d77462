"""Host-side bit I/O.

The AC-3 bitstream is MSB-first big-endian.  The reader here is the host
pre-pass primitive (numpy-backed; the C++ native parser mirrors it).  Two
access styles:

  * sequential `read(n)` / `read_signed(n)` for side-info parsing, and
  * `gather(offsets, widths)` — vectorized extraction of many fields at
    once, used for mantissa unpacking where all field offsets are known
    after bit allocation (cumsum of widths).

Parity reference: a52dec-0.7.5-cvs/liba52/bitstream.{c,h}
(behaviour only; this is a different design — offset-addressed, not a
32-bit word cursor).
"""
from __future__ import annotations

import numpy as np


class BitReader:
    """MSB-first bit reader over a bytes-like buffer."""

    __slots__ = ("buf", "pos", "_arr")

    def __init__(self, buf, start_bit: int = 0):
        self.buf = bytes(buf)
        self.pos = start_bit
        self._arr = np.frombuffer(self.buf, dtype=np.uint8)

    def read(self, n: int) -> int:
        """Read n bits (0 <= n <= 32) as an unsigned int."""
        if n == 0:
            return 0
        p, self.pos = self.pos, self.pos + n
        byte0 = p >> 3
        nbytes = (p % 8 + n + 7) >> 3
        acc = 0
        for b in self.buf[byte0:byte0 + nbytes]:
            acc = (acc << 8) | b
        acc >>= (8 * nbytes - (p % 8) - n)
        return acc & ((1 << n) - 1)

    def read_signed(self, n: int) -> int:
        v = self.read(n)
        if v >= 1 << (n - 1):
            v -= 1 << n
        return v

    def skip(self, n: int) -> None:
        self.pos += n

    def gather(self, offsets: np.ndarray, widths: np.ndarray) -> np.ndarray:
        """Extract many bitfields at once.  widths <= 16.  Returns uint32."""
        offsets = np.asarray(offsets, dtype=np.int64)
        widths = np.asarray(widths, dtype=np.int64)
        byte0 = offsets >> 3
        # read 3 bytes starting at byte0 (covers bitpos%8 + 16 bits)
        b = self._arr
        n = len(b)
        i0 = np.minimum(byte0, n - 1)
        i1 = np.minimum(byte0 + 1, n - 1)
        i2 = np.minimum(byte0 + 2, n - 1)
        acc = (b[i0].astype(np.uint32) << 16) | (b[i1].astype(np.uint32) << 8) \
            | b[i2].astype(np.uint32)
        shift = 24 - (offsets & 7) - widths
        out = (acc >> shift.astype(np.uint32)) & ((1 << widths) - 1).astype(np.uint32)
        return out.astype(np.uint32)


def to_signed(v: np.ndarray, widths: np.ndarray) -> np.ndarray:
    """Two's-complement sign extension of gathered fields."""
    v = v.astype(np.int32)
    w = np.asarray(widths, dtype=np.int32)
    sign = np.int32(1) << (w - 1)
    return np.where(w > 0, (v ^ sign) - sign, 0).astype(np.int32)


class BitWriter:
    """MSB-first bit writer (encoder frame packer)."""

    __slots__ = ("chunks", "acc", "nbits")

    def __init__(self):
        self.chunks = bytearray()
        self.acc = 0
        self.nbits = 0

    def write(self, n: int, value: int) -> None:
        if n == 0:
            return
        value &= (1 << n) - 1
        self.acc = (self.acc << n) | value
        self.nbits += n
        while self.nbits >= 8:
            self.nbits -= 8
            self.chunks.append((self.acc >> self.nbits) & 0xFF)
        self.acc &= (1 << self.nbits) - 1

    def write_many(self, widths, values) -> None:
        for n, v in zip(widths, values):
            self.write(int(n), int(v))

    @property
    def bit_length(self) -> int:
        return 8 * len(self.chunks) + self.nbits

    def flush(self) -> bytes:
        """Zero-pad to a byte boundary and return the buffer."""
        if self.nbits:
            pad = 8 - self.nbits
            self.write(pad, 0)
        return bytes(self.chunks)
