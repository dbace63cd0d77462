"""Port: fast mode (ACCURACY="fast") against the reference decoder's output
on every committed golden stream.

Fast mode's written contract against the reference decoder is max <= 0.02,
mean <= 0.001 and sigma <= 0.002 in 16-bit units
(ac3acm_tpu/models/decoder.py:39-44).  The JAX package's own fast mode
misses that max on five hazard streams (blksw20_hazard, cpl51_hazard,
odd441_hazard, spec_cpl51_hazard, overdrive_51_448), and so does the port:
the matmul filterbank sums each output in another order than the
reference's split-radix IFFT.  This file does not restate the contract as
met.  It holds each stream's max |diff| to what the JAX package's fast mode
gives on the same stream in the same test, decoded the same way (the JAX
BatchedDecoder with its native parser on one thread; 2 lanes from frame 0,
float at bias 0, chunks of 3 frames), plus a quarter of an LSB: the two
FP32 matmuls sum in different orders, so the two fast modes differ from
each other by a fraction of an LSB.
"""
import os

import numpy as np
import pytest

from ac3acm_tpu.models import decoder as JD
from ac3acm_tpu.parallel.pipeline import BatchedDecoder as JaxDecoder
from ac3acm_tpu_torch import tables as T
from ac3acm_tpu_torch.models import decoder as PD
from ac3acm_tpu_torch.parallel.pipeline import BatchedDecoder

GOLDEN = os.path.join(os.path.dirname(__file__), "golden")
FLAGS = T.A52_STEREO | T.A52_ADJUST_LEVEL
CHUNK = 3
MARGIN_LSB = 0.25


def goldens():
    return sorted(f for f in os.listdir(GOLDEN) if f.endswith(".ac3"))


def _max_lsb(pcm, name):
    want = np.load(os.path.join(GOLDEN, name + ".stereo_float.npy"))
    assert pcm.shape[1] == len(want), (pcm.shape, want.shape)
    diff = pcm.reshape(len(pcm), -1, 512).astype(np.float64) - want
    return float(np.abs(diff).max()) * 32768.0


def _drain(dec):
    chunks = []
    while True:
        r = dec.decode_available(max_frames=CHUNK)
        if r is None:
            return np.concatenate(chunks, axis=1)
        assert np.asarray(r[1]).all()
        chunks.append(np.asarray(r[0]))


def _fast_lsb(make, name):
    """max |fast-mode decode - golden| in LSB; make() -> a 2-lane decoder."""
    es = open(os.path.join(GOLDEN, name), "rb").read()
    dec = make()
    for i in range(2):
        dec.feed(i, es)
    return _max_lsb(_drain(dec), name)


@pytest.mark.parametrize("name", goldens())
def test_fast_mode_within_jax_fast_error(name, monkeypatch):
    monkeypatch.setattr(JD, "ACCURACY", "fast")
    monkeypatch.setattr(PD, "ACCURACY", "fast")
    jax_err = _fast_lsb(lambda: JaxDecoder(2, FLAGS, bias=0.0,
                                           parser="native", nthreads=1),
                        name)
    err = _fast_lsb(lambda: BatchedDecoder(2, FLAGS, bias=0.0,
                                           device="cpu"), name)
    assert err <= jax_err + MARGIN_LSB, (name, err, jax_err)
