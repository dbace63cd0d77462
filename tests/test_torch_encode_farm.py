"""Port: the encode farm's entry (parallel/encode.py BatchedEncoder) at 5.1
640 kbit/s on the CPU, fed the benchmark's frozen 3/2+LFE PCM: chunks
dispatched with one in flight (dispatch_frames, then finish of the chunk
before) give the plain reference encoder's frames byte for byte
(benchmark/reference/encode.py), and so do the synchronous call with
either packer and the mesh form."""
import os

import numpy as np
import pytest
import torch

from ac3acm_tpu_torch.parallel.encode import BatchedEncoder
from ac3acm_tpu_torch.parallel.mesh import make_mesh
from benchmark.core.spec import BENCH
from benchmark.reference.encode import encode_lanes, make_config

RATE, CH = 640000, 6
# lane i: stream s, then the other stream, cyclically from frame f0
LANES = ((0, 0), (1, 3), (0, 5), (1, 7))
CHUNKS, F = 3, 2


@pytest.fixture(scope="module")
def pcm():
    """[4, CHUNKS * F * 1536, 6] int16: each lane's frames in the
    encoder's channel order (L C R Ls Rs LFE)."""
    frozen = np.load(os.path.join(BENCH, "data",
                                  "a52_51_448_3f2r_lfe.npy"))
    out = []
    for s, f0 in LANES:
        cyc = np.concatenate([frozen[s], frozen[1 - s]])
        out.append(np.concatenate([cyc[(f0 + t) % len(cyc)]
                                   for t in range(CHUNKS * F)]))
    return np.stack(out)


@pytest.fixture(scope="module")
def want(pcm):
    """The reference encoder's bytes of each lane, from the encoder's
    initial carry (a zero block before the first frame)."""
    L, n, _ = pcm.shape
    frames, ok, _ = encode_lanes(
        make_config(48000, RATE, CH),
        torch.from_numpy(pcm.reshape(L, n // 1536, 1536, CH)),
        torch.zeros((L, CH, 256), dtype=torch.int32))
    assert ok.all()
    return [b"".join(row) for row in frames]


def _chunk(pcm, k):
    return pcm[:, k * F * 1536:(k + 1) * F * 1536]


def test_one_chunk_in_flight_gives_the_reference_frames(pcm, want):
    enc = BatchedEncoder(len(LANES), 48000, RATE, CH, device="cpu")
    got = [b""] * len(LANES)
    h = enc.dispatch_frames(_chunk(pcm, 0))
    for k in range(1, CHUNKS + 1):
        nxt = enc.dispatch_frames(_chunk(pcm, k)) if k < CHUNKS else None
        got = [a + b for a, b in zip(got, enc.finish(h))]
        h = nxt
    assert enc.step == CHUNKS
    assert [len(g) for g in got] == [CHUNKS * F * 2560] * len(LANES)
    assert got == want


@pytest.mark.parametrize("form", ["device", "native", "mesh"])
def test_encode_frames_gives_the_reference_frames(pcm, want, form):
    """encode_frames (finish(dispatch_frames)) with the device packer, the
    native packer, and the lanes split over a mesh's 'data' axis."""
    kw = (dict(mesh=make_mesh(2, 1, devices=["cpu"] * 2)) if form == "mesh"
          else dict(pack=form, device="cpu"))
    enc = BatchedEncoder(len(LANES), 48000, RATE, CH, **kw)
    got = [b""] * len(LANES)
    for k in range(CHUNKS):
        got = [a + b for a, b in zip(got, enc.encode_frames(_chunk(pcm, k)))]
    assert got == want
