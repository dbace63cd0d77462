"""The encode farm: ``BatchedEncoder.dispatch_frames`` on every lane's
chunk of int16 PCM, then ``BatchedEncoder.finish``, whose frames are
bytes on the host; chunk k+1 is dispatched before chunk k is finished.

The PCM is frozen under ``benchmark/data`` (the configuration's ``pcm``):
the reference decoder's output of each content stream in the encoder's
channel order, [streams, frames, 1536, channels] int16 (``content_pcm``
makes it).  Lane (s, f0) reads the 2P frames "stream s, then stream
1 - s" cyclically from frame f0.  So a lane's chunks
differ from one chunk to the next, and so does the block it carries into
each: a path that dropped the encoder's carry would not read correct.
Every chunk is one of a few phases of that cycle, made once in set-up as
a caller's numpy arrays.
"""
from __future__ import annotations

import math
import os

import numpy as np
import torch

from ..core.spec import BENCH
from .transcode import compare  # noqa: F401  (frames and bytes, limit 0)

# liba52's planes with an LFE (flags A52_LFE) put it first; the encoder
# codes it last: L C R Ls Rs LFE
LFE_LAST = [1, 2, 3, 4, 5, 0]


def content_pcm(streams: list, flags: int, level: float,
                bias: float) -> np.ndarray:
    """The reference decode of each stream's frames to 3/2+LFE, twice in a
    row from a zero delay and dither LFSR state 1, the second pass kept
    (its delay is the stream's own, as in a cycle), in the encoder's
    channel order: -> [S, P, 1536, 6] int16."""
    from ..reference.decode import decode_lanes
    from ..reference.imdct import convert_to_int16
    P = len(streams[0])
    pcm = decode_lanes([s + s for s in streams], flags, level, bias,
                       [1] * len(streams))
    pcm = convert_to_int16(pcm, bias)[:, P:, :, LFE_LAST]  # [S, P, 6, 6, 256]
    return pcm.permute(0, 1, 2, 4, 3).reshape(len(streams), P, 1536,
                                              6).numpy()


def load_pcm(config: dict, lanes) -> np.ndarray:
    """The configuration's frozen PCM: [S, P, 1536, nch] int16."""
    pcm = np.load(os.path.join(BENCH, "data", config["pcm"]))
    want = (len(lanes.streams), lanes.period, 1536,
            int(config["encode"]["channels"]))
    if pcm.shape != want or pcm.dtype != np.int16:
        raise ValueError(f"{config['pcm']}: {pcm.dtype} {pcm.shape}, "
                         f"expected int16 {want}")
    return pcm


def cycles(pcm: np.ndarray) -> np.ndarray:
    """[S, P, ...] -> each stream's cycle, itself then the other stream:
    [S, 2P, ...] (two streams)."""
    if len(pcm) != 2:
        raise ValueError("the encode cell's cycle takes two streams")
    return np.concatenate([pcm, pcm[::-1]], axis=1)


class Path:
    def __init__(self, cell: dict, lanes, device: torch.device):
        from ac3acm_tpu_torch.parallel.encode import BatchedEncoder
        config = cell["config"]
        enc = config["encode"]
        self.F = F = lanes.frames_per_chunk
        cyc = cycles(load_pcm(config, lanes))         # [S, 2P, 1536, ch]
        n = cyc.shape[1]
        # chunk k starts at frame k*F of the lane's cycle: its phases
        step = np.arange(F)
        self._pcm = [
            cyc[lanes.stream[:, None],
                (lanes.start[:, None] + k * F + step) % n]
            .reshape(lanes.count, F * 1536, -1)
            for k in range(n // math.gcd(n, F))]
        self._enc = BatchedEncoder(lanes.count, int(enc["sample_rate"]),
                                   int(enc["bit_rate_kbps"]) * 1000,
                                   int(enc["channels"]), pack=enc["pack"],
                                   device=device)
        self.k = 0

    @staticmethod
    def decoder():
        return None

    def dispatch(self):
        h = self._enc.dispatch_frames(self._pcm[self.k % len(self._pcm)])
        self.k += 1
        return h

    def finish(self, handle):
        L = self._enc.batch
        try:
            out = self._enc.finish(handle)
        except RuntimeError as e:
            if "rate control" not in str(e):
                raise
            return [b""] * L, np.zeros((L, self.F), bool)
        return out, np.ones((L, self.F), bool)

    @staticmethod
    def keep(out):
        return out


def reference(lanes, config: dict, k: int) -> dict:
    """The reference's frames of chunk k for every (stream, start) pair,
    [C, F, nbytes] uint8, with the encoder's classes and strategies: the
    pair's F frames of its cycle and the last block before them (zeros
    before the first chunk, the encoder's initial carry), encoded."""
    from ..reference.encode import encode_lanes, make_config
    enc = config["encode"]
    cfg = make_config(int(enc["sample_rate"]), int(enc["bit_rate_kbps"])
                      * 1000, int(enc["channels"]))
    cyc = cycles(load_pcm(config, lanes))
    n, F = cyc.shape[1], lanes.frames_per_chunk
    samples, last = [], []
    for s, f0 in lanes.combos():
        t0 = f0 + k * F
        samples.append(np.stack([cyc[s, (t0 + j) % n] for j in range(F)]))
        before = cyc[s, (t0 - 1) % n, 1280:].T              # [nch, 256]
        last.append(before if k > 0 else np.zeros_like(before))
    frames, ok, fields = encode_lanes(
        cfg, torch.from_numpy(np.stack(samples)),
        torch.from_numpy(np.stack(last)).to(torch.int32))
    C = len(frames)
    out = dict(frames=np.frombuffer(b"".join(b for row in frames
                                             for b in row),
                                    np.uint8).reshape(C, F, -1))
    out.update(enc_ok=ok, bap=fields["bap"], strat=fields["strat"], cfg=cfg)
    return out


if __name__ == "__main__":
    # python3 -m benchmark.paths.encode <cell>: writes the cell's frozen PCM
    import sys

    from ..core.content import make_lanes
    from ..core.spec import load_cell
    cell = load_cell(sys.argv[1])
    config, dec = cell["config"], cell["config"]["decode"]
    np.save(os.path.join(BENCH, "data", config["pcm"]),
            content_pcm(make_lanes(cell["traffic"], 0).streams,
                        int(dec["flags"]), float(dec["level"]),
                        float(dec["bias"])))
