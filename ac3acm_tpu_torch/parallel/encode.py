"""Batched multi-stream encode: N streams, any number of frames a call.

The encoder (models.encoder) is batched over streams; this wrapper keeps
each stream's carry (last_samples, csnroffst) on the device.  Frames are
packed on the device by default (ops.pack_device: only the finished
frames and the ok mask come back), or on the host by the threaded native
C++ packer (native/ac3host.cpp:ac3h_pack_frames), byte-identically.

With a mesh (parallel.mesh.make_mesh) the streams are split over its
'data' axis: each shard's carry lives on its row's device and the frame
core runs once per shard.  The native packer sees the gathered fields;
the device packer packs each shard's fields on its own device, where the
core left them (a frame's bytes depend on that frame's fields alone, so
the bytes are the same, and the dense fields, about 20x the frames'
bytes, never cross between devices).

A farm keeps one chunk in flight: dispatch_frames(chunk k+1), then
finish(chunk k), as Transcoder does.  Each chunk's host work is marked by
the spans ``enc.stage`` (the frame-major reorder on the host),
``enc.h2d``, ``enc.run`` (the frame core and pack enqueued), ``enc.wait``
(the ok mask's copy, which waits for the card; with a mesh, the gather of
the outputs) and ``enc.bytes`` (the frames' D2H and each stream's bytes),
and the counter ``enc_staged_bytes`` (the bytes the reorder writes), under
the chunk's ``step`` (utils.trace: off unless a profiler records).
"""
from __future__ import annotations

import numpy as np
import torch

from ..host import pack as PK
from ..models.encoder import (encode_pipeline_multi, encode_pipeline_packed,
                              make_config, rate_failures)
from ..utils.device import resolve_device
from ..utils.trace import count, span
from .mesh import Sharded, check_mesh, over_data, stream_sharding


class BatchedEncoder:
    """N same-format PCM streams -> N AC-3 streams.

    pack: "device" (default) assembles frames on the device; "native"
    fetches the dense fields and packs them in C++ threads.  Byte-identical.
    device: None -> the CUDA card (raises without one); "cpu" runs the
    plain PyTorch path.  mesh: the streams split over its 'data' axis
    (the carry then is parallel.mesh.Sharded); device stays None."""

    def __init__(self, batch: int, freq: int, bitrate: int, channels: int,
                 mesh=None, pack: str = "device", device=None):
        if pack not in ("device", "native"):
            raise ValueError(f"pack={pack!r}: expected 'device' or 'native'")
        self.mesh = check_mesh(mesh)
        if mesh is not None and device is not None:
            raise ValueError("pass a mesh or a device, not both")
        self.device = (resolve_device(device) if mesh is None
                       else mesh.row_devices[0])
        self.batch = batch
        self.cfg = make_config(freq, bitrate, channels)
        self.pack = pack
        self.step = 0            # the next chunk's, for its spans
        self.last = torch.zeros((batch, channels, 256), dtype=torch.int32,
                                device=self.device)
        self.csnr = torch.full((batch,), 40, dtype=torch.int32,
                               device=self.device)
        if mesh is not None:
            self.last, self.csnr = stream_sharding(mesh).put(
                (self.last, self.csnr))

    def encode_step(self, pcm: np.ndarray) -> list[bytes]:
        """pcm int16 [batch, 1536, nch] (AC-3 channel order) -> one frame
        per stream."""
        if np.shape(pcm)[1] != 1536:
            raise ValueError(f"encode_step takes one frame, got {np.shape(pcm)}")
        return self.encode_frames(pcm)

    def encode_frames(self, pcm: np.ndarray) -> list[bytes]:
        """pcm int16 [batch, F*1536, nch] -> the AC-3 bytes of each stream,
        F frames; the same bytes as F encode_step calls.  PCM goes to the
        device as int16.  The synchronous form of dispatch_frames +
        finish."""
        return self.finish(self.dispatch_frames(pcm))

    def dispatch_frames(self, pcm: np.ndarray):
        """Stage, copy and enqueue the encode of pcm int16 [batch,
        F*1536, nch] without waiting for the device, and advance the carry:
        -> a handle for finish(), which carries the chunk's step to its
        spans.  The caller may stage the next chunk while the device works
        on this one."""
        B, n, nch = np.shape(pcm)
        F = n // 1536
        step = self.step
        self.step += 1
        with span("enc.stage", step) as on:
            pcm = np.asarray(pcm, np.int16)
            if self.mesh is None:
                pcm = np.ascontiguousarray(np.moveaxis(
                    pcm.reshape(B, F, 1536, nch), 1, 0))
            if on is not None:
                count("enc_staged_bytes",
                      pcm.nbytes if self.mesh is None else 0, step)
        if self.mesh is None:
            with span("enc.h2d", step):
                x = torch.from_numpy(pcm).to(self.device)
            with span("enc.run", step):
                carry, ok, out = encode_run(self.cfg, self.pack, x,
                                            self.last, self.csnr)
        else:
            def shard(x, last, csnr):
                x = x.reshape(x.shape[0], F, 1536, nch).transpose(0, 1)
                return lanes_first(*encode_run(self.cfg, self.pack,
                                               x.contiguous(), last, csnr))

            with span("enc.h2d", step):
                x = stream_sharding(self.mesh).put(pcm)
            with span("enc.run", step):
                carry, ok, out = over_data(self.mesh, shard)(
                    x, self.last, self.csnr)
        self.last, self.csnr = carry
        return F, ok, out, step

    def finish(self, handle) -> list[bytes]:
        """Drain one dispatch_frames handle: check rate control (raising,
        with the carry already advanced past the chunk) and return each
        stream's bytes (packing them on the host for pack="native")."""
        F, ok, out, step = handle
        with span("enc.wait", step):
            if self.mesh is not None:
                _, ok, out = frame_major(None, ok, out)
            bad = rate_failures(ok)
        if bad:
            raise RuntimeError(f"rate control failed at (frame, stream) {bad}")
        with span("enc.bytes", step):
            return frame_bytes(self.cfg, out, self.batch, F)


def encode_run(cfg, pack: str, samples, last, csnr):
    """samples [F, B, 1536, nch] on one device -> ((last', csnr'), ok
    [F, B], out): with pack="device" the packed frames [F, B, bytes]
    (encode_pipeline_packed), with "native" the frame fields {k: [F, B,
    ...]} (encode_pipeline_multi)."""
    if pack == "device":
        return encode_pipeline_packed(cfg)(samples, last, csnr)
    carry, res = encode_pipeline_multi(cfg)(samples, last, csnr)
    return carry, res["ok"], res


def lanes_first(carry, ok, out):
    """encode_run's outputs with the lane axis first (one shard's, for the
    split over 'data')."""
    t = lambda x: x.transpose(0, 1)
    return carry, t(ok), (t(out) if isinstance(out, torch.Tensor)
                          else {k: t(v) for k, v in out.items()})


def frame_major(carry, ok, out):
    """The Sharded outputs of lanes_first over a mesh -> the carry as it
    is and ok, out gathered to the host in encode_run's [F, B] layout."""
    t = lambda x: x.gather().transpose(0, 1)
    return carry, t(ok), (t(out) if isinstance(out, Sharded)
                          else {k: t(v) for k, v in out.items()})


def frame_bytes(cfg, out, B: int, F: int) -> list[bytes]:
    """encode_run's out -> each stream's F frames of bytes: the device
    packer's frames as they are, the fields through the native packer."""
    if isinstance(out, torch.Tensor):
        fr = out.cpu().numpy()
        return [fr[:, b].tobytes() for b in range(B)]
    flat = PK.pack_frames_native(
        cfg, {k: v.cpu().numpy() for k, v in out.items()})
    # [F, B] flattens C-order: frame f of stream b at index f*B + b
    return [b"".join(flat[f * B + b] for f in range(F)) for b in range(B)]
