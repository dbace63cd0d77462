"""Stream demultiplexers: AC-3 elementary streams out of MPEG PS / TS.

Equivalents of the reference's resumable demux state machine
(a52dec.c:311-539) and ts_loop, plus the raw-ES frame scanner the decoder
uses.  The scan core reports how far it safely consumed, so the
`PsDemux`/`TsDemux` classes can be fed arbitrary chunks (the NEEDBYTES /
DONEBYTES resumability of the reference) while the one-shot generators
cover whole-buffer use.  `extract_es` doubles as the `extract_a52` tool's
core (src/extract_a52.c parity).  A copy of the JAX package's demux, on
this package's own host.parse.syncinfo.
"""
from __future__ import annotations

from typing import Iterator

from ..host.parse import syncinfo

_MPEG1_SKIP = [0, 0, 4, 9, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0]


def _ps_scan(data: bytes, want: int) -> tuple[list[bytes], int, bool]:
    """-> (payloads, consumed, ended).  Stops at the first entity that
    runs past the buffer, reporting its start as `consumed` so a caller
    holding a partial stream can resume there."""
    out: list[bytes] = []
    pos = 0
    n = len(data)
    while True:
        if pos + 4 > n:
            return out, max(pos, 0), False
        if data[pos] or data[pos + 1] or data[pos + 2] != 1:
            pos += 1
            continue
        sid = data[pos + 3]
        if sid == 0xB9:                     # program end
            return out, n, True
        if sid == 0xBA:                     # pack header
            if pos + 5 > n:
                return out, pos, False
            if (data[pos + 4] & 0xC0) == 0x40:      # mpeg2
                if pos + 14 > n:
                    return out, pos, False
                pos += 14 + (data[pos + 13] & 7)
            elif (data[pos + 4] & 0xF0) == 0x20:    # mpeg1
                pos += 12
            else:
                pos += 5
            continue
        if sid < 0xB9:
            raise ValueError("video stream, not a system stream")
        if pos + 6 > n:
            return out, pos, False
        pes_len = (data[pos + 4] << 8) | data[pos + 5]
        end = pos + 6 + pes_len
        if end > n:
            return out, pos, False
        if sid != 0xBD:                     # not private stream 1: skip
            pos = end
            continue
        # private stream 1 PES (complete in buffer)
        if (data[pos + 6] & 0xC0) == 0x80:          # mpeg2 PES
            hlen = 9 + data[pos + 8]
        else:                                       # mpeg1 PES
            hlen = 6
            while hlen < 23 and pos + hlen < n and data[pos + hlen] == 0xFF:
                hlen += 1
            if (data[pos + hlen] & 0xC0) == 0x40:
                hlen += 2
            hlen += _MPEG1_SKIP[data[pos + hlen] >> 4] + 1
        sub = data[pos + hlen] if pos + hlen < n else -1
        payload_start = pos + hlen + 4      # substream id + 3 header bytes
        if sub == want:
            out.append(data[payload_start:end])
        pos = end


def ps_payloads(data: bytes, track: int = 0) -> Iterator[bytes]:
    """AC-3 payload chunks from an MPEG-1/2 program stream.

    track selects the substream (0x80 + track) inside private stream 1.
    """
    payloads, _, _ = _ps_scan(data, 0x80 + track)
    yield from payloads


def _ts_scan(data: bytes, pid: int) -> tuple[list[bytes], int]:
    """-> (payloads, consumed); trailing partial packet left unconsumed."""
    out: list[bytes] = []
    pos = data.find(b"\x47")
    if pos < 0:
        return out, len(data)
    n = len(data)
    while pos + 188 <= n:
        if data[pos] != 0x47:
            nxt = data.find(b"\x47", pos + 1)
            if nxt < 0:
                return out, n
            pos = nxt
            continue
        pkt = data[pos:pos + 188]
        pos += 188
        ppid = ((pkt[1] << 8) | pkt[2]) & 0x1FFF
        if ppid != pid:
            continue
        ofs = 4
        if pkt[3] & 0x20:                   # adaptation field
            ofs = 5 + pkt[4]
        if ofs >= 188:
            continue
        if pkt[1] & 0x40:                   # payload unit start: PES header
            p = pkt[ofs:]
            if len(p) < 9 or p[0] or p[1] or p[2] != 1:
                continue
            hlen = 9 + p[8]
            out.append(p[hlen:])
        else:
            out.append(pkt[ofs:])
    return out, pos


def ts_payloads(data: bytes, pid: int) -> Iterator[bytes]:
    """AC-3 PES payload chunks from an MPEG transport stream (188B packets)."""
    payloads, _ = _ts_scan(data, pid)
    yield from payloads


class PsDemux:
    """Resumable program-stream demux: feed() arbitrary chunks, get ES bytes.

    The reference demuxer keeps its parse state across read() buffers
    (a52dec.c:311-539 NEEDBYTES/DONEBYTES); here the unconsumed tail is
    carried so entities split across chunk boundaries reassemble.
    """

    def __init__(self, track: int = 0):
        self.want = 0x80 + track
        self.buf = b""
        self.ended = False

    def feed(self, chunk: bytes) -> bytes:
        if self.ended:
            return b""
        self.buf += chunk
        payloads, consumed, self.ended = _ps_scan(self.buf, self.want)
        self.buf = self.buf[consumed:]
        return b"".join(payloads)


class TsDemux:
    """Resumable transport-stream demux (chunked ts_payloads)."""

    def __init__(self, pid: int):
        self.pid = pid
        self.buf = b""

    def feed(self, chunk: bytes) -> bytes:
        self.buf += chunk
        payloads, consumed = _ts_scan(self.buf, self.pid)
        self.buf = self.buf[consumed:]
        return b"".join(payloads)


def es_frames(es: bytes, start: int = 0) -> Iterator[tuple[bytes, int, int]]:
    """Frame-sync scan over a raw elementary stream.

    Yields (frame_bytes, sample_rate, bit_rate); resyncs byte-wise on
    damage like the reference (a52dec.c:271-276).
    """
    pos = start
    n = len(es)
    while pos + 7 <= n:
        size, flags, srate, brate = syncinfo(es[pos:pos + 7])
        if size == 0:
            pos += 1
            continue
        if pos + size > n:
            return
        yield es[pos:pos + size], srate, brate
        pos += size


def extract_es(data: bytes, kind: str = "auto", track: int = 0,
               pid: int = 0) -> bytes:
    """Extract a raw AC-3 ES from a container (extract_a52 parity)."""
    if kind == "auto":
        if len(data) >= 4 and data[0] == 0x47 and len(data) % 188 == 0:
            kind = "ts"
        elif data[:4] == b"\x00\x00\x01\xba":
            kind = "ps"
        else:
            kind = "es"
    if kind == "es":
        return data
    if kind == "ps":
        return b"".join(ps_payloads(data, track))
    if kind == "ts":
        return b"".join(ts_payloads(data, pid))
    raise ValueError(f"unknown container kind {kind!r}")
