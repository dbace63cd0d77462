"""The transcode farm: ``Transcoder.dispatch_frames`` on every lane's chunk
bytes, then ``Transcoder.finish``, whose re-encoded frames are bytes on
the host; chunk k+1 is dispatched before chunk k is finished."""
from __future__ import annotations

import numpy as np
import torch


class Path:
    def __init__(self, cell: dict, lanes, device: torch.device):
        from ac3acm_tpu_torch.parallel.transcode import Transcoder
        enc = cell["config"]["encode"]
        self.F = lanes.frames_per_chunk
        self._chunk = lanes.chunk_bytes()
        self._tc = Transcoder(lanes.count, int(enc["bit_rate_kbps"]) * 1000,
                              int(enc["channels"]),
                              sample_rate=int(enc["sample_rate"]),
                              pack=enc["pack"],
                              parser=cell["traffic"]["parser"],
                              device=device)
        self.k = 0

    def decoder(self):
        return self._tc._bd

    def dispatch(self):
        h = self._tc.dispatch_frames(self._chunk(self.k), self.F)
        self.k += 1
        return h

    def finish(self, handle):
        out = self._tc.finish(handle)
        return out, np.asarray(self._tc.ok)

    @staticmethod
    def keep(out):
        return out


def reference(lanes, config: dict, k: int) -> dict:
    """The reference's frames of chunk k for every (stream, start) pair,
    [C, F, nbytes] uint8, with the encoder's classes and strategies: the
    decode from two frames before (the delay into the frame before, whose
    last block the encoder's first frame reads), then the encode."""
    from ..core.check import decoded_chunk
    from ..reference.encode import encode_lanes, make_config
    enc = config["encode"]
    cfg = make_config(int(enc["sample_rate"]), int(enc["bit_rate_kbps"])
                      * 1000, int(enc["channels"]))
    pcm, out = decoded_chunk(lanes, config, k, 2)
    C, n, _, nch, _ = pcm.shape
    if nch != cfg.channels or nch == 6:
        raise ValueError("the reference transcode takes a downmix to the "
                         "encoder's channels in coded order")
    samples = pcm.permute(0, 1, 2, 4, 3).reshape(C, n, 1536, nch)
    last = pcm[:, 1, 5].to(torch.int32)                     # [C, nch, 256]
    frames, ok, fields = encode_lanes(cfg, samples[:, 2:], last)
    out["frames"] = np.frombuffer(b"".join(b for row in frames for b in row),
                                  np.uint8).reshape(C, n - 2, -1)
    out.update(enc_ok=ok, bap=fields["bap"], strat=fields["strat"], cfg=cfg)
    return out


def compare(lanes, config: dict, ref: dict, got) -> dict:
    """got [L] bytes -> {name: (value, limit)}: frames and bytes that
    differ from the reference."""
    want = ref["frames"][lanes.combo_of_lane()]              # [L, F, nbytes]
    L, F, nb = want.shape
    if len(got) != L or any(len(g) != F * nb for g in got):
        return dict(frame_mismatch=(L * F, 0), byte_mismatch=(L * F * nb, 0))
    bad = np.frombuffer(b"".join(got), np.uint8).reshape(L, F, nb) != want
    return dict(frame_mismatch=(int(bad.any(axis=-1).sum()), 0),
                byte_mismatch=(int(bad.sum()), 0))
