"""What decides ``correct``: the program's output of one chunk, drawn from
the seed among the window's chunks, against the plain reference, every
lane of it (each entry's ``paths/<entry>.py`` has its ``reference`` and
``compare``; the decode they share is here).

A lane's output in chunk k depends on its stream, its start frame, and the
state it brings into the chunk: the 128-sample OLA delay of the frame
before (the decoder), the last block of the PCM before (the encoder), and
the dither LFSR, which every dithered bin since the lane's first frame has
stepped.  So the reference decodes each (stream, start) pair's frames of
chunk k from one frame before it (two for the transcode, whose first frame
reads the PCM before it), its parser starting at the LFSR state that the
frames before would leave (each frame's draws counted by a parse of it),
and compares every lane with its pair's output.  Nothing the program made
reaches the reference: it reads the same frozen bytes the lanes were fed.

Every number compared has the limit 0: the decode's contract is liba52's
PCM bit for bit, the encoder's the reference encoder's bytes.
"""
from __future__ import annotations

import numpy as np

from ..reference.decode import ParseCount, decode_lanes
from ..reference.imdct import convert_to_int16
from .content import Lanes, lfsr_states


def frame_stats(lanes: Lanes, flags: int, level: float, bias: float):
    """-> (draws [S, P], fields [S, P], sizes [S, P]) of every content frame:
    the dither draws, the exponent groups and mantissa words the parse
    reads, the frame's bytes."""
    S, P = len(lanes.streams), lanes.period
    draws = np.zeros((S, P), np.int64)
    fields = np.zeros((S, P), np.int64)
    sizes = np.zeros((S, P), np.int64)
    for s in range(S):
        for f in range(P):
            p = ParseCount()
            p.decode_frame(lanes.streams[s][f], flags, level, bias)
            draws[s, f], fields[s, f] = p.draws, p.fields
            sizes[s, f] = len(lanes.streams[s][f])
    return draws, fields, sizes


def decoded_chunk(lanes: Lanes, config: dict, k: int, before: int):
    """The reference decode of chunk k for every (stream, start) pair, from
    `before` frames ahead of it: -> (int16 PCM [C, before+F, 6, nch, 256]
    at the configuration's bias, per-pair stats of the chunk's frames:
    "fields", "draws", "sizes" [C, F])."""
    dec = config["decode"]
    flags, level, bias = int(dec["flags"]), float(dec["level"]), \
        float(dec["bias"])
    F = lanes.frames_per_chunk
    t0 = k * F
    if t0 < before:
        raise ValueError("the checked chunk has no frame before it")
    draws, fields, sizes = frame_stats(lanes, flags, level, bias)
    combos = lanes.combos()
    seqs = [lanes.frames(s, f0, t0 - before, before + F) for s, f0 in combos]
    states = lfsr_states(lanes, draws, t0 - before)
    pcm = convert_to_int16(decode_lanes(seqs, flags, level, bias, states),
                           bias)
    P = lanes.period
    ph = [[(s, (f0 + t0 + j) % P) for j in range(F)] for s, f0 in combos]
    stats = {name: np.array([[a[s, p] for s, p in row] for row in ph])
             for name, a in (("fields", fields), ("draws", draws),
                             ("sizes", sizes))}
    return pcm, stats
