"""The cell's inputs, made from the seed: which stream and which frame each
lane starts at, and the bytes each lane is fed a chunk.

The content is frozen AC-3 streams under ``benchmark/data`` (the traffic
file names them).  Every (stream, start frame) pair gets the same number of
lanes whatever the seed, so every seed gives the same work; the seed only
deals the pairs out to the lanes.  A lane repeats its stream's frames
cyclically from its start frame, so chunk k of a lane is a byte slice of
its stream made once in set-up.
"""
from __future__ import annotations

import os
from dataclasses import dataclass

import numpy as np

from ..reference.decode import split_frames
from ..reference.tables import lfsr_cycle
from .spec import BENCH

SAMPLE_RATE = 48000
FRAME_SAMPLES = 1536


@dataclass
class Lanes:
    streams: list            # [S] lists of frame bytes
    stream: np.ndarray       # [L] stream index of each lane
    start: np.ndarray        # [L] start frame of each lane
    frames_per_chunk: int

    @property
    def count(self) -> int:
        return len(self.stream)

    @property
    def period(self) -> int:
        n = {len(s) for s in self.streams}
        assert len(n) == 1, "the content streams must hold as many frames"
        return n.pop()

    def combos(self) -> list:
        """The distinct (stream, start) pairs, in a fixed order."""
        return [(s, f) for s in range(len(self.streams))
                for f in range(self.period)]

    def combo_of_lane(self) -> np.ndarray:
        """[L] index into combos() of each lane."""
        return self.stream * self.period + self.start

    def frames(self, stream: int, start: int, t0: int, n: int) -> list:
        """Frames t0 .. t0+n-1 of a lane that starts at `start` of
        `stream`."""
        s = self.streams[stream]
        return [s[(start + t) % len(s)] for t in range(t0, t0 + n)]

    def chunk_bytes(self):
        """-> fn(k) -> [L] bytes of chunk k, each lane's F frames, from
        byte strings made here once (one per stream and phase)."""
        F, P = self.frames_per_chunk, self.period
        made = {(s, ph): b"".join(self.frames(s, ph, 0, F))
                for s in range(len(self.streams)) for ph in range(P)}
        stream, start = self.stream.tolist(), self.start.tolist()

        def chunk(k: int) -> list:
            off = k * F
            return [made[(s, (f + off) % P)] for s, f in zip(stream, start)]
        return chunk

    def audio_seconds_per_chunk(self) -> float:
        return self.count * self.frames_per_chunk * FRAME_SAMPLES \
            / SAMPLE_RATE


def seeded(seed: int, *stream: int) -> np.random.Generator:
    """A generator from the run's seed (any whole number, negative ones
    taken mod 2**64) and a stream number."""
    return np.random.default_rng([int(seed) % 2**64, *stream])


def make_lanes(traffic: dict, seed: int) -> Lanes:
    streams = []
    for name in traffic["content"]:
        with open(os.path.join(BENCH, "data", name), "rb") as f:
            streams.append(split_frames(f.read()))
    L = int(traffic["lanes"])
    S, P = len(streams), len(streams[0])
    if L % (S * P):
        raise ValueError(f"{L} lanes do not split evenly over {S} streams x "
                         f"{P} start frames")
    rng = seeded(seed)
    combo = rng.permutation(np.arange(L) % (S * P))
    return Lanes(streams=streams, stream=combo // P, start=combo % P,
                 frames_per_chunk=int(traffic["frames_per_chunk"]))


def lfsr_states(lanes: Lanes, draws: np.ndarray, t: int) -> np.ndarray:
    """The dither LFSR state each combo's lane holds before its frame t,
    from every parser's state 1 at the lane's first frame: draws [S, P]
    are the dither draws of each stream's frames (they depend on the
    frame alone, never on the state).  -> [len(combos())] int."""
    states, _ = lfsr_cycle()
    P = lanes.period
    out = []
    for s, f0 in lanes.combos():
        cyc = int(draws[s].sum())
        part = sum(int(draws[s][(f0 + i) % P]) for i in range(t % P))
        out.append(int(states[((t // P) * cyc + part) % len(states)]))
    return np.asarray(out, np.int64)
