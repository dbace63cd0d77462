"""BatchedDecoder's lane buffers: a stream fed in pieces cut anywhere (inside
sync words, inside junk between frames) decodes chunk for chunk as the same
stream fed whole, with every parser, past the megabyte a lane used to reach
before its consumed bytes were dropped; and a lane holds only what was
unconsumed when it was last fed plus that feed, which is all feed copies."""
import numpy as np
import pytest
import torch

import chip_smoke as CS
from ac3acm_tpu_torch.parallel.pipeline import BatchedDecoder
from ac3acm_tpu_torch.utils import trace

FLAGS = 2 | 0x10                        # A52_STEREO | A52_ADJUST_LEVEL
F = 3                                   # frames a chunk
CHUNKS = 4
# lane -> {frame index: junk bytes before it}: lanes 0 and 1 pass 1 MiB
JUNK = [{2: 700_000, 7: 500_000, 11: 13},
        {0: 5, 4: 1_100_000},
        {3: 1, 6: 9, 10: 300}]


@pytest.fixture(scope="module")
def frames():
    return CS.golden_frames(CS.GOLDEN)


def _streams(frames):
    """Per lane: its bytes and the offset at which each frame starts.  Lane
    i starts at golden frame i;
    junk is random bytes with no 0x0B, so it never reads as a sync word."""
    rng = np.random.default_rng(24)
    out = []
    for lane, junk in enumerate(JUNK):
        buf, starts = bytearray(), []
        for f in range(F * CHUNKS):
            j = rng.integers(0, 256, junk.get(f, 0), np.uint8)
            buf += j[j != 0x0B].tobytes()
            starts.append(len(buf))
            buf += frames[(lane + f) % len(frames)]
        out.append((bytes(buf), starts))
    return out


def _targets(streams):
    """Per lane, how far the stream is fed before each chunk's decode: past
    the chunk's last frame, then into a later frame's sync word or header
    (on lane 2, a whole frame further: that frame stays unconsumed too),
    and all of it before the last."""
    rng = np.random.default_rng(7)
    out = []
    for lane, (es, starts) in enumerate(streams):
        t = []
        for k in range(CHUNKS - 1):
            nxt = (k + 1) * F + (1 if lane == 2 else 0)
            t.append(starts[nxt] + int(rng.choice([1, 2, 3, 6])))
        out.append(t + [len(es)])
    return out


def _decoder(parser):
    return BatchedDecoder(len(JUNK), FLAGS, 1.0, 384.0, emit_int16=True,
                          parser=parser, device="cpu")


def _pieces(data, rng):
    """data cut at up to three random offsets."""
    cuts = sorted(int(c) for c in rng.integers(0, len(data) + 1, 3))
    return [data[a:b] for a, b in zip([0] + cuts, cuts + [len(data)])]


@pytest.mark.parametrize("parser", ["raw", "native", "python", "raw_py"])
def test_split_feeds_decode_as_whole(parser, frames, tmp_path):
    streams = _streams(frames)
    whole = _decoder(parser)
    for lane, (es, _) in enumerate(streams):
        whole.feed(lane, es)
    want = [whole.decode_available(F) for _ in range(CHUNKS)]
    assert whole.decode_available(F) is None

    split, targets = _decoder(parser), _targets(streams)
    rng = np.random.default_rng(3)
    fed_to = [0] * len(JUNK)
    left = [0] * len(JUNK)          # unconsumed after the last decode
    got, bounds = [], []
    trace.reset()
    with trace.profile(str(tmp_path)):
        for k in range(CHUNKS):
            fed = 0
            for lane, (es, _) in enumerate(streams):
                data = es[fed_to[lane]:targets[lane][k]]
                for piece in _pieces(data, rng):
                    split.feed(lane, piece)
                fed_to[lane] = targets[lane][k]
                fed += len(data)
                ln = split.lanes[lane]
                assert ln.pos == 0 and len(ln.buf) == left[lane] + len(data)
            bounds.append((fed, fed + sum(left)))
            got.append(split.decode_available(F))
            left = [len(ln.buf) - ln.pos for ln in split.lanes]
    counted = trace.counters()["feed_copied_bytes"]
    trace.reset()

    assert min(fed_to[:2]) > 1 << 20
    assert set(counted) == set(range(CHUNKS))
    for k, (lo, hi) in enumerate(bounds):
        assert lo <= counted[k] <= hi, (k, counted[k], lo, hi)
    # every step after the first drops consumed bytes in front of a
    # remainder: lane 2's holds a whole frame
    assert all(counted[k] > bounds[k][0] + len(frames[0])
               for k in range(1, CHUNKS))
    for (pw, vw), (pg, vg) in zip(want, got):
        assert vw.shape == (len(JUNK), F) and vw.all()
        np.testing.assert_array_equal(vg, vw)
        assert pg.dtype == torch.int16 and torch.equal(pg, pw)
