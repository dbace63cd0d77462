"""The batched decode: ``BatchedDecoder.decode_available`` on every lane's
chunk bytes, its int16 PCM copied to pinned host memory on a copy stream
of its own, so that the next chunk's call (made before the copy) runs on
the card while the PCM comes back."""
from __future__ import annotations

import numpy as np
import torch


class Path:
    def __init__(self, cell: dict, lanes, device: torch.device):
        from ac3acm_tpu_torch.parallel.pipeline import BatchedDecoder
        dec = cell["config"]["decode"]
        self.F = lanes.frames_per_chunk
        self._chunk = lanes.chunk_bytes()
        self._bd = BatchedDecoder(lanes.count, int(dec["flags"]),
                                  float(dec["level"]), float(dec["bias"]),
                                  emit_int16=True,
                                  parser=cell["traffic"]["parser"],
                                  device=device)
        self.k = 0
        self._cuda = device.type == "cuda"
        # pinned PCM buffers: two in turn, and a spare that takes the place
        # of a kept one (keep() copies nothing in the window)
        self._host = [None, None]
        self._spare = None
        self._last = None
        self._kept = []
        if self._cuda:
            self._copy = torch.cuda.Stream(device)

    def decoder(self):
        return self._bd

    def dispatch(self):
        for i, d in enumerate(self._chunk(self.k)):
            self._bd.feed(i, d)
        r = self._bd.decode_available(max_frames=self.F)
        if r is None:
            raise RuntimeError("the decoder returned no chunk")
        pcm, valid = r
        ev = None
        if self._cuda:
            ev = torch.cuda.Event()
            ev.record()
        self.k += 1
        return self.k - 1, pcm, valid, ev

    def finish(self, handle):
        k, pcm, valid, ev = handle
        if not self._cuda:
            return pcm.numpy(), np.asarray(valid)
        buf = self._host[k % 2]
        if buf is None or buf.shape != pcm.shape:
            buf = torch.empty(pcm.shape, dtype=pcm.dtype, pin_memory=True)
            self._host[k % 2] = buf
            if self._spare is None or self._spare.shape != buf.shape:
                self._spare = torch.empty_like(buf, pin_memory=True)
        with torch.cuda.stream(self._copy):
            self._copy.wait_event(ev)
            buf.copy_(pcm, non_blocking=True)
            done = torch.cuda.Event()
            done.record(self._copy)
        done.synchronize()
        self._last = k % 2
        return buf.numpy(), np.asarray(valid)

    def keep(self, out):
        """The last finished chunk's PCM, kept: on the card its pinned
        buffer leaves the rotation for the spare."""
        if not self._cuda:
            return np.array(out)
        self._kept.append(self._host[self._last])
        self._host[self._last], self._spare = self._spare, None
        return out


def reference(lanes, config: dict, k: int) -> dict:
    """The reference's int16 PCM of chunk k for every (stream, start) pair,
    [C, F*6, nch, 256], from one frame before it (the OLA delay)."""
    from ..core.check import decoded_chunk
    pcm, out = decoded_chunk(lanes, config, k, 1)
    C, n, _, nch, _ = pcm.shape
    out["pcm"] = pcm[:, 1:].reshape(C, (n - 1) * 6, nch, 256).numpy()
    return out


def compare(lanes, config: dict, ref: dict, got) -> dict:
    """got [L, F*6, nch, 256] int16 -> {name: (value, limit)}: samples that
    differ from the reference and the largest difference, in LSB."""
    want = ref["pcm"][lanes.combo_of_lane()]
    got = np.asarray(got)
    if got.shape != want.shape:
        return dict(pcm_mismatch=(int(want.size), 0), pcm_max_lsb=(65535, 0))
    diff = np.abs(got.astype(np.int32) - want.astype(np.int32))
    return dict(pcm_mismatch=(int((diff != 0).sum()), 0),
                pcm_max_lsb=(int(diff.max(initial=0)), 0))
