"""Batched multi-stream encode: N streams, any number of frames a call.

The encoder (models.encoder) is batched over streams; this wrapper keeps
each stream's carry (last_samples, csnroffst) on the device.  Frames are
packed on the device by default (ops.pack_device: only the finished
frames and the ok mask come back), or on the host by the threaded native
C++ packer (native/ac3host.cpp:ac3h_pack_frames), byte-identically.
"""
from __future__ import annotations

import numpy as np
import torch

from ..host import pack as PK
from ..models.encoder import (encode_pipeline_multi, encode_pipeline_packed,
                              make_config, rate_failures)
from ..utils.device import resolve_device
from .pipeline import _no_mesh


class BatchedEncoder:
    """N same-format PCM streams -> N AC-3 streams.

    pack: "device" (default) assembles frames on the device; "native"
    fetches the dense fields and packs them in C++ threads.  Byte-identical.
    device: None -> the CUDA card (raises without one); "cpu" runs the
    plain PyTorch path.  mesh: the JAX package's slot, kept in its
    position; only None is served (ROADMAP A12)."""

    def __init__(self, batch: int, freq: int, bitrate: int, channels: int,
                 mesh=None, pack: str = "device", device=None):
        _no_mesh(mesh)
        if pack not in ("device", "native"):
            raise ValueError(f"pack={pack!r}: expected 'device' or 'native'")
        self.device = resolve_device(device)
        self.batch = batch
        self.cfg = make_config(freq, bitrate, channels)
        self.pack = pack
        self.last = torch.zeros((batch, channels, 256), dtype=torch.int32,
                                device=self.device)
        self.csnr = torch.full((batch,), 40, dtype=torch.int32,
                               device=self.device)

    def encode_step(self, pcm: np.ndarray) -> list[bytes]:
        """pcm int16 [batch, 1536, nch] (AC-3 channel order) -> one frame
        per stream."""
        if np.shape(pcm)[1] != 1536:
            raise ValueError(f"encode_step takes one frame, got {np.shape(pcm)}")
        return self.encode_frames(pcm)

    def encode_frames(self, pcm: np.ndarray) -> list[bytes]:
        """pcm int16 [batch, F*1536, nch] -> the AC-3 bytes of each stream,
        F frames; the same bytes as F encode_step calls.  PCM goes to the
        device as int16."""
        B, n, nch = np.shape(pcm)
        F = n // 1536
        frames = np.moveaxis(np.asarray(pcm, np.int16).reshape(B, F, 1536,
                                                                nch), 1, 0)
        x = torch.from_numpy(np.ascontiguousarray(frames)).to(self.device)
        if self.pack == "device":
            carry, ok, out = encode_pipeline_packed(self.cfg)(
                x, self.last, self.csnr)
            bad = rate_failures(ok)
            if bad:
                raise RuntimeError(
                    f"rate control failed at (frame, stream) {bad}")
            self.last, self.csnr = carry
            fr = out.cpu().numpy()
            return [fr[:, b].tobytes() for b in range(B)]
        (last, csnr), res = encode_pipeline_multi(self.cfg)(
            x, self.last, self.csnr)
        bad = rate_failures(res["ok"])
        if bad:
            raise RuntimeError(f"rate control failed at (frame, stream) {bad}")
        self.last, self.csnr = last, csnr
        flat = PK.pack_frames_native(
            self.cfg, {k: v.cpu().numpy() for k, v in res.items()})
        # [F, B] flattens C-order: frame f of stream b at index f*B + b
        return [b"".join(flat[f * B + b] for f in range(F)) for b in range(B)]
