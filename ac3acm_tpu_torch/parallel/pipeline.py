"""Batched multi-stream decode: the framework's throughput path.

N streams of a common format are a leading lane axis through the decode
pipeline.  Per-lane carried state (OLA delay planes + downmixed flag) is
the checkpoint/resume unit: a plain tuple of tensors (utils.state).

Dispatch (``batched_pipeline``): a steady, long-only, premixed chunk that
is converted to int16 goes through the fused steady kernel
(ops.fused_steady); any other steady chunk through the plain
``_pipeline_steady``.  Non-steady chunks need the block scan, which is not
ported yet.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from .. import tables as T
from ..host.native import DenseBatchParser
from ..host.parse import downmix_init, syncinfo
from ..models.decoder import (EXACT_NOT_PORTED, StreamFormat,
                              _lanes_first, _pipeline_steady, default_exact,
                              steady_ok)
from ..ops.downmix import downmix
from ..ops.filterbank import convert_to_int16
from ..ops.fused_steady import fused_steady
from ..utils.device import resolve_device


def _expand_compact(blocks):
    """Reconstruct f32 premixed planes from the block-float H2D form:
    freq = man(int16) * scale(f32 per block, plane, 16-bin group).  The
    compact form halves host->device bytes; the product is exact."""
    if "freq_man" not in blocks:
        return blocks
    out = {k: v for k, v in blocks.items()
           if k not in ("freq_man", "freq_scale")}
    man, scale = blocks["freq_man"], blocks["freq_scale"]
    g = scale.shape[-1]
    grouped = man.reshape(man.shape[:-1] + (g, 256 // g))
    out["freq"] = (grouped.to(torch.float32)
                   * scale[..., None]).reshape(man.shape)
    return out


def _fused_run(fmt: StreamFormat):
    """Fused body for the (steady, long_only, premixed, int16) dispatch:
    matmul + OLA + int16 conversion in one kernel (ops.fused_steady), with
    the same entry fixups and carry layout as _pipeline_steady.

    Serves both premixed layouts: reducing mixes (freq path) and identity-
    mix passthrough (time path, fmt.identity_mix -- e.g. stereo->stereo),
    which differ only in the entry/exit delay fixups."""
    nfo = fmt.nf_out
    passthrough = not (nfo < fmt.nfchans)         # identity premix

    def run(carry, blocks):
        delay, downmixed = carry                  # [B,6,128], [B]
        blocks = _expand_compact(blocks)
        freq = blocks["freq"].contiguous()        # [B,n,P,256]; LFE last
        bias = blocks["bias"].contiguous()        # [B,n]
        if passthrough:
            # identity upmix: the time path's entry fixup is a no-op
            d0f = delay[:, :5]
        else:
            zero = torch.zeros((), dtype=delay.dtype, device=delay.device)
            # entry fixup: a carry from a time-path chunk holds per-channel
            # delays; downmix once (the block scan's first-step behaviour)
            d_mix = _lanes_first(downmix, delay[:, :5], fmt.acmod,
                                 fmt.output, zero, slev_zero=fmt.slev_zero)
            d0f = torch.where(downmixed[:, None, None], delay[:, :5], d_mix)
        parts = [d0f[:, :nfo]]
        if fmt.lfe_out:
            parts.append(delay[:, 5:6])
        d0 = torch.cat(parts, dim=1).contiguous()
        pcm, dlast = fused_steady(freq, d0, bias)
        if fmt.lfe_out:                           # pipeline emits LFE first
            pcm = torch.cat([pcm[:, :, nfo:], pcm[:, :, :nfo]], dim=2)
        new_delay = delay.clone()
        new_delay[:, :nfo] = dlast[:, :nfo]
        if passthrough:
            # unused planes get the zd of all-zero inputs, exactly 0
            new_delay[:, nfo:5] = 0.0
            flag = torch.zeros_like(downmixed)
        else:
            # planes nf_out..4 stay stale (post-fixup), like the block scan
            new_delay[:, nfo:5] = d0f[:, nfo:]
            flag = torch.ones_like(downmixed)
        if fmt.lfe_out:
            new_delay[:, 5] = dlast[:, nfo]
        return (new_delay, flag), pcm

    return run


def batched_pipeline(fmt: StreamFormat, emit_int16: bool = False,
                     steady: bool = False, long_only: bool = False,
                     premixed: bool = False, exact: bool | None = None,
                     fused: bool | None = None):
    """Returns fn: (carry, blocks) -> (carry, pcm).

    carry: (delay [B,6,128] f32, downmixed [B] bool) tensors.
    blocks: dict of tensors with leading [B, nblk, ...] axes, on the
    carry's device.
    pcm: [B, nblk, nch_out, 256] float32 (or int16 when emit_int16).

    steady=True selects the scan-free body (valid on chunks that pass
    models.decoder.steady_ok -- checked per call on the host);
    long_only=True additionally skips the short-block product.

    fused=None (default) sends every eligible chunk (steady + long_only +
    premixed + int16, fast mode) through the fused steady kernel;
    fused=False forces the plain steady body (A/B comparisons),
    fused=True asserts eligibility.

    exact (default: the package ACCURACY policy) selects the order-exact
    filterbank, which is not ported yet and raises.
    """
    if exact is None:
        exact = default_exact()
    if exact:
        raise NotImplementedError(EXACT_NOT_PORTED)
    if not steady:
        raise NotImplementedError(
            "non-steady chunks need the _pipeline_body scan: ROADMAP A4")
    eligible = long_only and premixed and emit_int16
    if fused is None:
        fused = eligible
    if fused:
        assert eligible, "the fused kernel requires steady+long_only+" \
                         "premixed+int16"
        return _fused_run(fmt)

    def run(carry, blocks):
        blocks = _expand_compact(blocks)
        carry, pcm = _pipeline_steady(fmt, carry, blocks,
                                      long_only=long_only, premixed=premixed)
        if emit_int16:
            pcm = convert_to_int16(pcm)
        return carry, pcm

    return run


def init_batched_carry(batch: int, device=None):
    """Zero OLA delay and downmixed=True per lane, on `device` (None: the
    CUDA card; raises without one)."""
    device = resolve_device(device)
    delay = torch.zeros((batch, 6, 128), dtype=torch.float32, device=device)
    downmixed = torch.ones((batch,), dtype=torch.bool, device=device)
    return delay, downmixed


# ---------------------------------------------------------------------------
# Host-side pool: N native parsers feeding the batched device pipeline
# ---------------------------------------------------------------------------

@dataclass
class StreamLane:
    buf: bytes = b""
    pos: int = 0
    # parsed-but-not-yet-emitted frames (uneven lane feeds leave a
    # remainder here; the next decode_available resumes with it)
    pending: list = field(default_factory=list)


class BatchedDecoder:
    """N same-format streams -> batched PCM on the device.

    The host half is the native dense parser: one ctypes call parses every
    lane (C++ threads, GIL released) and emits device-ready planes --
    dequantized frequency planes, premixed output planes when the chunk
    qualifies for the steady path.  The planes go to the device with
    torch.from_numpy(...).to(device); PCM comes back as a device tensor.

    A bad frame marks the lane invalid for that frame (its PCM is zeroed)
    instead of failing the batch (a52dec.c:271-306).

    device: None -> the CUDA card (raises without one); "cpu" runs the
    plain PyTorch versions of every kernel.  fused: see batched_pipeline.
    """

    def __init__(self, batch: int, flags: int, level: float = 1.0,
                 bias: float = 0.0, emit_int16: bool = False,
                 parser: str = "native", nthreads=None,
                 compact_h2d: bool = False, device=None,
                 fused: bool | None = None):
        if parser != "native":
            raise NotImplementedError(
                f"parser={parser!r} is not ported yet (python: ROADMAP A3, "
                "raw/raw_py: ROADMAP A6); use parser='native'")
        self.device = resolve_device(device)
        self.lanes = [StreamLane() for _ in range(batch)]
        self.flags = flags
        self.level = level
        self.bias = bias
        self.emit_int16 = emit_int16
        # block-float premixed planes over the link: int16 mantissa +
        # per-(block, plane, group) scale, ~2x fewer H2D bytes
        self.compact_h2d = compact_h2d
        self.fused = fused
        self._fmt = None
        self._carry = init_batched_carry(batch, self.device)
        self._dense = DenseBatchParser(batch, nthreads)
        self._pre_planes = None

    def feed(self, lane: int, data: bytes):
        ln = self.lanes[lane]
        ln.buf += data
        if ln.pos > (1 << 20):               # bounded-memory compaction
            ln.buf = ln.buf[ln.pos:]
            ln.pos = 0

    def decode_available(self, max_frames: int = 8):
        """Parse up to max_frames per lane, run the device pipeline once.

        Returns (pcm [B, nblk, nch, 256] device tensor, valid [B, nframes]
        bool numpy) or None if no lane had a complete frame.
        """
        return self._decode_available_native(max_frames)

    def _expected_pre_planes(self):
        """Output-plane count for the premixed steady path, derived from the
        next frame header + requested flags.  clev/slev only affect the
        STEREO<->DOLBY promotion, which has the same plane count, so zeros
        suffice for the negotiation here."""
        for lane in self.lanes:
            buf, pos = lane.buf, lane.pos
            while pos + 7 <= len(buf):
                size, sflags, _, _ = syncinfo(buf[pos:pos + 7])
                if size == 0:
                    pos += 1
                    continue
                acmod_in = sflags & T.A52_CHANNEL_MASK
                out, _ = downmix_init(acmod_in, self.flags, 1.0,
                                      np.float32(0.0), np.float32(0.0))
                if out < 0:
                    return 0
                outm = out & T.A52_CHANNEL_MASK
                nf_out = int(T.NFCHANS[outm])
                lfe = 1 if (sflags & T.A52_LFE) and (self.flags & T.A52_LFE) \
                    else 0
                if nf_out < int(T.NFCHANS[acmod_in]):
                    return nf_out + lfe      # reducing mix (freq path)
                if nf_out == int(T.NFCHANS[acmod_in]) and (
                        outm == acmod_in or
                        (acmod_in == T.A52_STEREO and outm == T.A52_DOLBY)):
                    # identity-mix passthrough (chanbias is always 0 for
                    # these pairs): premix = rematrix only
                    return nf_out + lfe
                return 0                     # upmix / non-identity: no premix
        return None                          # no header yet; retry later

    @staticmethod
    def _frame_slice(r, lane: int, f: int) -> dict:
        s = slice(f * 6, f * 6 + 6)
        return {
            "freq_full": r["freq_full"][lane, s],
            "freq_pre": None if r["freq_pre"] is None
            else r["freq_pre"][lane, s],
            "freq_man": None if r.get("freq_man") is None
            else r["freq_man"][lane, s],
            "freq_scale": None if r.get("freq_scale") is None
            else r["freq_scale"][lane, s],
            "blksw": r["blksw"][lane, s],
            "coeff": r["coeff"][lane, s],
            "remat": r["remat"][lane, s],
            "bias": r["bias"][lane, s],
            "valid": bool(r["valid"][lane, f]),
            "premix_ok": bool(r["premix_ok"][lane, f]),
            "meta": (r["meta"][lane, f].copy()
                     if r["meta"][lane, f, 6] else None),
        }

    def _fmt_from_meta(self, meta):
        if meta is not None:
            return StreamFormat(acmod=int(meta[0]), output=int(meta[2]),
                                slev_zero=bool(meta[5]),
                                chanbias=int(meta[4]))
        if self._fmt is not None:
            return self._fmt
        out = self.flags & T.A52_CHANNEL_MASK
        return StreamFormat(acmod=out, output=out, slev_zero=True, chanbias=0)

    @staticmethod
    def _fmt_of(obj):
        """StreamFormat of a pending native frame slice (None if invalid)."""
        m = obj["meta"]
        if m is None:
            return None
        return StreamFormat(acmod=int(m[0]), output=int(m[2]),
                            slev_zero=bool(m[5]), chanbias=int(m[4]))

    def _to_device(self, x):
        return torch.from_numpy(np.ascontiguousarray(x)).to(self.device)

    def _run_native(self, fmt, valid, freq_pre, freq_full, blksw, coeff,
                    remat, bias, premix_all, freq_man=None, freq_scale=None):
        blksw = np.ascontiguousarray(blksw).astype(bool)
        if premix_all:
            if freq_man is not None:
                host = {"freq_man": freq_man, "freq_scale": freq_scale}
            else:
                host = {"freq": freq_pre}
            host.update(blksw=blksw, bias=bias)
            lo = not blksw.any()
            fn = batched_pipeline(fmt, self.emit_int16, steady=True,
                                  long_only=lo, premixed=True,
                                  fused=self.fused)
        else:
            host = {"freq": freq_full, "blksw": blksw, "coeff": coeff,
                    "remat": np.asarray(remat).astype(bool), "bias": bias}
            steady = steady_ok(fmt, host)
            lo = steady and not blksw.any()
            fn = batched_pipeline(fmt, self.emit_int16, steady=steady,
                                  long_only=lo, fused=self.fused)
        blocks = {k: self._to_device(v) for k, v in host.items()}
        self._fmt = fmt
        self._carry, pcm = fn(self._carry, blocks)
        return pcm, valid

    def _decode_available_native(self, max_frames: int):
        if self._pre_planes is None:
            self._pre_planes = self._expected_pre_planes()
        pp = self._pre_planes or 0
        had_pending = any(l.pending for l in self.lanes)
        need = max_frames - min(len(l.pending) for l in self.lanes)
        r = None
        if need > 0:
            r = self._dense.parse([(l.buf, l.pos) for l in self.lanes],
                                  need, self.flags, self.level, self.bias,
                                  pp, compact=self.compact_h2d)
            for i, lane in enumerate(self.lanes):
                lane.pos += int(r["consumed"][i])
        if r is not None and not had_pending:
            nfr = r["nframes"]
            nf = int(nfr.min())
            if nf > 0 and (nfr == nf).all():
                lane_fmts = {
                    self._fmt_from_meta(r["meta"][i, f])
                    for i in range(len(self.lanes)) for f in range(nf)
                    if r["meta"][i, f, 6]}
                if len(lane_fmts) > 1:
                    return self._decode_heterogeneous()
                # fast path: the parse output is already the batch
                rows = nf * 6
                fmt = (next(iter(lane_fmts)) if lane_fmts
                       else self._fmt_from_meta(None))
                valid = r["valid"][:, :nf].astype(bool)
                premix_all = (pp > 0
                              and (fmt.nf_out < fmt.nfchans
                                   or fmt.identity_mix)
                              and bool(r["premix_ok"][:, :nf].all()))
                compact = premix_all and r["freq_man"] is not None
                return self._run_native(
                    fmt, valid,
                    None if r["freq_pre"] is None else r["freq_pre"][:, :rows],
                    r["freq_full"][:, :rows], r["blksw"][:, :rows],
                    r["coeff"][:, :rows], r["remat"][:, :rows],
                    r["bias"][:, :rows], premix_all,
                    freq_man=r["freq_man"][:, :rows] if compact else None,
                    freq_scale=r["freq_scale"][:, :rows] if compact else None)
        if r is not None:
            for i, lane in enumerate(self.lanes):
                for f in range(int(r["nframes"][i])):
                    lane.pending.append(self._frame_slice(r, i, f))
        nf = min((len(l.pending) for l in self.lanes), default=0)
        if nf == 0:
            return None
        emit = [l.pending[:nf] for l in self.lanes]
        for lane in self.lanes:
            del lane.pending[:nf]
        valid = np.array([[fr["valid"] for fr in frames] for frames in emit])
        emit_fmts = {self._fmt_of(fr) for frames in emit for fr in frames
                     if fr["meta"] is not None}
        if len(emit_fmts) > 1:
            return self._decode_heterogeneous()
        meta = next((fr["meta"] for frames in emit for fr in frames
                     if fr["meta"] is not None), None)
        fmt = self._fmt_from_meta(meta)
        premix_all = (pp > 0
                      and (fmt.nf_out < fmt.nfchans or fmt.identity_mix)
                      and all(fr["premix_ok"] and fr["freq_pre"] is not None
                              for frames in emit for fr in frames))
        cat = lambda key: np.stack(
            [np.concatenate([fr[key] for fr in frames]) for frames in emit])
        compact = premix_all and all(
            fr.get("freq_man") is not None
            for frames in emit for fr in frames)
        return self._run_native(
            fmt, valid,
            cat("freq_pre") if premix_all and not compact else None,
            None if premix_all else cat("freq_full"),
            cat("blksw"), None if premix_all else cat("coeff"),
            None if premix_all else cat("remat"), cat("bias"), premix_all,
            freq_man=cat("freq_man") if compact else None,
            freq_scale=cat("freq_scale") if compact else None)

    def _decode_heterogeneous(self):
        raise NotImplementedError(
            "mixed-format batches (per-format lane bucketing, "
            "_decode_heterogeneous) are not ported yet: ROADMAP A4")
