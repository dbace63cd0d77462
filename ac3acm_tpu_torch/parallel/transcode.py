"""Transcode: N-stream AC-3 decode -> downmix -> re-encode on the device.

The decoder's PCM (bias 384, converted to int16 on the device) becomes the
encoder's input without a host round trip; the host parses going in and,
with pack="native", packs coming out.  Carries per stream: the decoder's
(delay, downmixed) and the encoder's (last_samples, csnroffst).

transcode_pipeline(_multi) composes the decode body with the frame
encoder for callers that hold decoder block tensors; Transcoder drives
BatchedDecoder (any of its parse paths and fused kernels) into the
encoder.  With a mesh (parallel.mesh.make_mesh) both run once per shard of
the lanes split over its 'data' axis, the PCM staying on its shard's
device between them.
"""
from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from .. import tables as T
from ..models.decoder import StreamFormat, _pipeline_body, default_exact
from ..models.encoder import (EncoderConfig, encode_pipeline, make_config,
                              rate_failures)
from ..ops.filterbank import convert_to_int16
from ..utils.device import resolve_device
from ..utils.trace import span
from .encode import encode_run, frame_bytes, frame_major, lanes_first
from .mesh import check_mesh, over_data, stream_sharding
from .pipeline import BatchedDecoder


def _plane_perm(nch: int) -> list:
    """Decoder plane order -> AC-3 coded order: with LFE the decoder puts
    it in plane 0, the encoder codes it last."""
    return list(range(1, nch)) + [0] if nch == 6 else list(range(nch))


@lru_cache(maxsize=16)
def _make_run(dec_fmt: StreamFormat, enc_cfg: EncoderConfig, exact: bool):
    """One frame for B lanes: (dec_carry, blocks [B, 6, ...], enc_last,
    enc_csnr) -> (dec_carry', enc fields, pcm int16 [B, 6, nch, 256] in
    coded order).  exact is part of the cache key: the accuracy mode is
    read when the caller asks, not when a cached function was built."""
    enc_fn = encode_pipeline(enc_cfg)
    perm = _plane_perm(dec_fmt.nch_out)

    def run(dec_carry, blocks, enc_last, enc_csnr):
        dec_carry, pcm = _pipeline_body(dec_fmt, dec_carry, blocks,
                                        exact=exact)
        i16 = convert_to_int16(pcm)[:, :, perm]             # [B,6,nch,256]
        samples = i16.transpose(-1, -2).reshape(i16.shape[0], 1536, -1)
        return dec_carry, enc_fn(samples, enc_last, enc_csnr), i16

    return run


def transcode_pipeline(dec_fmt: StreamFormat, enc_cfg: EncoderConfig,
                       mesh=None, exact: bool | None = None):
    """-> fn(dec_carry, blocks, enc_last, enc_csnr) -> (dec_carry',
    enc_fields, pcm_i16) for one frame a lane.

    blocks: decoder block tensors [B, 6, ...] (full planes; the block
    scan).  The decoded PCM (bias 384 in the parse) becomes the encoder's
    input frame; the decoder's output channel count must equal
    enc_cfg.channels.  exact: None -> the package accuracy mode now.
    mesh: every operand's lanes split over its 'data' axis, the step run
    once per shard, the outputs parallel.mesh.Sharded; the function is
    cached on (dec_fmt, enc_cfg, mesh, exact), as JAX's is on its
    arguments."""
    return _pipeline_on(dec_fmt, enc_cfg, check_mesh(mesh),
                        default_exact() if exact is None else bool(exact))


@lru_cache(maxsize=16)
def _pipeline_on(dec_fmt: StreamFormat, enc_cfg: EncoderConfig, mesh,
                 exact: bool):
    run = _make_run(dec_fmt, enc_cfg, exact)
    return run if mesh is None else over_data(mesh, run)


def transcode_pipeline_multi(dec_fmt: StreamFormat, enc_cfg: EncoderConfig,
                             exact: bool | None = None):
    """-> fn(dec_carry, blocks [F, B, 6, ...], enc_last, enc_csnr) ->
    ((dec_carry', enc_last', enc_csnr'), enc fields with a leading [F]
    axis): F transcode steps in order, both codecs' state carried."""
    run = transcode_pipeline(dec_fmt, enc_cfg, exact=exact)

    def multi(dec_carry, blocks, enc_last, enc_csnr):
        outs = []
        F = next(iter(blocks.values())).shape[0]
        for f in range(F):
            dec_carry, enc, _ = run(dec_carry, {k: v[f] for k, v in
                                                blocks.items()},
                                    enc_last, enc_csnr)
            enc_last, enc_csnr = enc["new_last"], enc["new_csnr"]
            outs.append(enc)
        outs = {k: torch.stack([o[k] for o in outs]) for k in outs[0]}
        return (dec_carry, enc_last, enc_csnr), outs

    return multi


def enc_input(pcm, nch: int):
    """Decoder int16 PCM [B, F*6, nch, 256] -> encoder samples
    [F, B, 1536, nch] int16 (plane permute + interleave), on the device."""
    B, nblk = pcm.shape[:2]
    x = pcm[:, :, _plane_perm(nch)].reshape(B, nblk // 6, 6, nch, 256)
    return x.permute(1, 0, 2, 4, 3).reshape(nblk // 6, B, 1536, nch)


class Transcoder:
    """N same-format streams: AC-3 in -> AC-3 out (re-encode at new rate).

    Corrupt input frames follow the decode path's resync semantics
    (a52dec.c:302-306): the bad lane-frame is masked (decodes as silence,
    so its re-encoded frame carries zeros) and flagged in `self.ok`
    [batch, nframes] after each step, instead of failing the whole batch.

    parser: "native" (dense parse and premix on the host) or "raw" (the
    coded frame bytes go to the device, which unpacks them), as in the JAX
    package.  pack: "device" or "native", as for BatchedEncoder.
    compact_h2d: block-float planes over the link (parser="native").
    device: None -> the CUDA card (raises without one); "cpu" runs the
    plain PyTorch path.  mesh: the lanes split over its 'data' axis
    (BatchedDecoder(mesh=...) and the encoder once per shard); device
    stays None."""

    def __init__(self, batch: int, out_bitrate: int, out_channels: int,
                 sample_rate: int = 48000, mesh=None, pack: str = "device",
                 compact_h2d: bool = False, parser: str = "native",
                 device=None):
        if pack not in ("device", "native"):
            raise ValueError(f"pack={pack!r}: expected 'device' or 'native'")
        if parser not in ("native", "raw"):
            raise ValueError(f"parser={parser!r}: expected 'native' or "
                             "'raw'")
        self.mesh = check_mesh(mesh)
        if mesh is not None and device is not None:
            raise ValueError("pass a mesh or a device, not both")
        self.device = (resolve_device(device) if mesh is None
                       else mesh.row_devices[0])
        self.batch = batch
        self.enc_cfg = make_config(sample_rate, out_bitrate, out_channels)
        self.out_channels = out_channels
        self.enc_last = torch.zeros((batch, out_channels, 256),
                                    dtype=torch.int32, device=self.device)
        self.enc_csnr = torch.full((batch,), 40, dtype=torch.int32,
                                   device=self.device)
        if mesh is not None:
            self.enc_last, self.enc_csnr = stream_sharding(mesh).put(
                (self.enc_last, self.enc_csnr))
        self.ok = None           # [batch, nframes] validity of the last step
        self.pack = pack
        want = {1: T.A52_MONO, 2: T.A52_STEREO, 3: T.A52_3F,
                4: T.A52_2F2R, 5: T.A52_3F2R,
                6: T.A52_3F2R | T.A52_LFE}[out_channels]
        self._bd = BatchedDecoder(batch, want | T.A52_ADJUST_LEVEL, 1.0,
                                  384.0, mesh, True, parser,
                                  compact_h2d=compact_h2d,
                                  device=None if mesh is not None
                                  else self.device)

    def step(self, frames: list[bytes]) -> list[bytes]:
        """One frame per stream in; one re-encoded frame per stream out."""
        return self.step_frames(frames, 1)

    def step_frames(self, data: list[bytes], nframes: int) -> list[bytes]:
        """data[b] holds exactly `nframes` AC-3 frames; returns the
        re-encoded bytes per stream.  The synchronous form of
        dispatch_frames + finish."""
        return self.finish(self.dispatch_frames(data, nframes))

    def dispatch_frames(self, data: list[bytes], nframes: int):
        """Parse one chunk and enqueue its transcode (H2D, decode, encode
        and, with pack="device", the pack) without waiting for the device:
        -> a handle for finish(), which carries the chunk's step to its
        spans.  The caller may parse the next chunk while the device works
        on this one."""
        if len(data) != self.batch:
            raise ValueError(f"{len(data)} streams for a batch of "
                             f"{self.batch}")
        step = self._bd.step                 # the chunk's, for its spans
        for i, d in enumerate(data):
            self._bd.feed(i, d)
        r = self._bd.decode_available(max_frames=nframes)
        if r is None:
            raise ValueError("no complete frames in step_frames input")
        pcm, valid = r
        F = pcm.shape[1] // 6
        if F != nframes:
            short = [i for i, ln in enumerate(self._bd.lanes)
                     if len(ln.pending) == 0]
            raise ValueError(
                f"step_frames promised {nframes} frames/lane but only {F} "
                f"complete frames were available on every lane "
                f"(shortest lanes: {short[:8]})")
        nch = self.out_channels
        with span("encode", step):
            if self.mesh is None:
                carry, ok, out = encode_run(self.enc_cfg, self.pack,
                                            enc_input(pcm, nch),
                                            self.enc_last, self.enc_csnr)
            else:
                def shard(pcm, last, csnr):
                    return lanes_first(*encode_run(self.enc_cfg, self.pack,
                                                   enc_input(pcm, nch), last,
                                                   csnr))

                carry, ok, out = over_data(self.mesh, shard)(
                    pcm, self.enc_last, self.enc_csnr)
        self.enc_last, self.enc_csnr = carry
        return F, valid, ok, out, step

    def finish(self, handle) -> list[bytes]:
        """Drain one dispatch_frames handle: check rate control, record
        the per-lane `ok` mask, and return the re-encoded bytes per
        stream (packing them on the host for pack="native")."""
        F, valid, ok, out, step = handle
        if self.mesh is not None:
            _, ok, out = frame_major(None, ok, out)
        self.ok = np.asarray(valid)
        # ok's copy to the host waits for the work enqueued before it on
        # the default stream (the next chunk's too, once dispatched)
        with span("finish.wait", step):
            bad = rate_failures(ok)
        if bad:
            raise RuntimeError(f"rate control failed at (frame, stream) "
                               f"{bad} -- out_bitrate too low")
        with span("finish.bytes", step):
            return frame_bytes(self.enc_cfg, out, self.batch, F)
