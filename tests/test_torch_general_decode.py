"""Port: the block scan, reference-mode decoding and mixed-format batches.

  * ``_pipeline_body`` against JAX's on chunks that are not steady (blksw
    differing across channels, zero-coefficient channels, a flag that
    flips): the exact mode by value, the fast mode to the matmul
    reassociation bound of tests/test_torch_decoder.py.  JAX's exact
    transform is compiled once and reached through a host callback (see
    tests/test_torch_imdct_exact.py).
  * ``BatchedDecoder`` with the package default ACCURACY="reference"
    (no set_accuracy call) on the CPU: float output at bias 0 equals the
    reference decoder's committed output BIT FOR BIT (max |diff| 0.0),
    through both parsers, including the coupling/short-block stream whose
    every frame needs the block scan, and a mixed-format batch with a
    mid-stream switch.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ac3acm_tpu.tables as JT
from ac3acm_tpu.models import decoder as JD
from ac3acm_tpu_torch.models import decoder as PD
from ac3acm_tpu_torch.ops import fused_steady_exact as FE
from ac3acm_tpu_torch.ops import imdct_exact as PE
from ac3acm_tpu_torch.parallel.pipeline import BatchedDecoder
from tests.test_torch_imdct_exact import (  # noqa: F401  (fixtures)
    _same, jax_exact_callback, jax_split)

GOLDEN = os.path.join(os.path.dirname(__file__), "golden")
FLAGS = JT.A52_STEREO | JT.A52_ADJUST_LEVEL
FP32_ATOL = 2e-6

# (acmod, output, slev_zero, chanbias): the body's strategy choices
FORMATS = {
    "reduce": (JT.A52_3F2R, JT.A52_STEREO, False, 0),
    "reduce_lfe": (JT.A52_3F2R, JT.A52_STEREO | JT.A52_LFE, False, 0),
    "stereo_remat": (JT.A52_STEREO, JT.A52_STEREO, True, 0),
    "upmix_chanbias_lfe": (JT.A52_2F1R, JT.A52_2F2R | JT.A52_LFE, False,
                           0b00101),
}


def _scan_blocks(rng, B=3, n=6):
    """A chunk no steady body may take: blksw differs across channels in
    some blocks, some channels have zero coefficients."""
    blksw = rng.random((B, n, 5)) < 0.3
    blksw[:, ::2] = blksw[:, ::2, :1]            # uniform every other block
    coeff = (rng.random((B, n, 5)) + 0.5).astype(np.float32)
    coeff[rng.random((B, n, 5)) < 0.2] = 0.0
    return {"freq": (rng.standard_normal((B, n, 6, 256)) * 0.02
                     ).astype(np.float32),
            "blksw": blksw, "coeff": coeff,
            "remat": rng.random((B, n, 256)) < 0.5,
            "bias": rng.standard_normal((B, n)).astype(np.float32)}


@pytest.mark.parametrize("exact", [True, False])
@pytest.mark.parametrize("name", list(FORMATS))
def test_pipeline_body_matches_jax(jax_exact_callback, name, exact):
    spec = FORMATS[name]
    jfmt, fmt = JD.StreamFormat(*spec), PD.StreamFormat(*spec)
    rng = np.random.default_rng(41)
    B = 3
    blocks = _scan_blocks(rng, B=B)
    assert not PD.steady_ok(fmt, blocks)
    delay = (rng.standard_normal((B, 6, 128)) * 0.05).astype(np.float32)
    downmixed = np.array([True, False, True])
    body = lambda c, b: JD._pipeline_body(jfmt, c, b, exact=exact)
    (jd, jm), jp = jax.jit(jax.vmap(body))(
        (jnp.asarray(delay), jnp.asarray(downmixed)), blocks)
    (md, mm), mp = PD._pipeline_body(
        fmt, (torch.from_numpy(delay), torch.from_numpy(downmixed)),
        {k: torch.from_numpy(v) for k, v in blocks.items()}, exact=exact)
    assert mp.shape == (B, 6, fmt.nch_out, 256)
    if exact:
        _same(mp.numpy(), jp, "pcm")
        _same(md.numpy(), jd, "delay")
    else:
        np.testing.assert_allclose(mp.numpy(), np.asarray(jp), rtol=0,
                                   atol=FP32_ATOL)
        np.testing.assert_allclose(md.numpy(), np.asarray(jd), rtol=0,
                                   atol=FP32_ATOL)
    np.testing.assert_array_equal(mm.numpy(), np.asarray(jm))


def _frames(name, nframes=None):
    from ac3acm_tpu_torch.host.parse import syncinfo
    es = open(os.path.join(GOLDEN, name), "rb").read()
    out, pos = [], 0
    while pos + 7 <= len(es) and (nframes is None or len(out) < nframes):
        size = syncinfo(es[pos:pos + 7])[0]
        assert size
        out.append(es[pos:pos + size])
        pos += size
    return b"".join(out)


def _decode(feeds, parser="native", chunk=3, flags=FLAGS):
    """Float PCM at bias 0 of every lane, [L, blocks, nch, 256], drained
    in `chunk`-frame steps, with the package's default accuracy."""
    dec = BatchedDecoder(len(feeds), flags, bias=0.0, parser=parser,
                         device="cpu")
    for i, es in enumerate(feeds):
        dec.feed(i, es)
    chunks = []
    while True:
        r = dec.decode_available(max_frames=chunk)
        if r is None:
            return torch.cat(chunks, dim=1).numpy()
        assert r[1].all()
        chunks.append(r[0])


def _golden(name):
    return np.load(os.path.join(GOLDEN, name + ".stereo_float.npy"))


GOLDENS = sorted(f for f in os.listdir(GOLDEN) if f.endswith(".ac3"))


@pytest.mark.parametrize("name,parser", [
    (name, parser) for name in GOLDENS for parser in ("native", "raw")])
def test_reference_decode_equals_golden(name, parser):
    """Every committed golden through both parsers: two lanes of the
    stream from frame 0, chunks of 3 frames (the carries cross chunk
    boundaries), no set_accuracy call: both lanes equal the reference
    decoder's output at max |diff| 0.0, and the order-exact kernels' plain
    versions did the transforms (the fused order-exact tail's on steady
    chunks, the split's in the block scan)."""
    assert PD.ACCURACY == "reference"
    before = PE.launches, FE.launches
    es = _frames(name)
    pcm = _decode([es, es], parser)
    assert (PE.launches, FE.launches) == before, \
        "CPU tensors must not launch the kernels"
    want = _golden(name)
    assert pcm.shape[1] == len(want)
    for lane in pcm:
        np.testing.assert_array_equal(lane.reshape(-1, 512), want)


def test_spec_stream_needs_the_block_scan():
    """Every chunk of the coupling/short-block stream fails steady_ok
    (blksw differs across its channels), so the reference-mode decode
    above went through _pipeline_body."""
    from ac3acm_tpu_torch.host.native import DenseBatchParser
    r = DenseBatchParser(1).parse([_frames("spec_cpl51_hazard.ac3")], 4,
                                  FLAGS, 1.0, 0.0)
    fmt = PD.StreamFormat(acmod=int(r["meta"][0, 0, 0]),
                          output=int(r["meta"][0, 0, 2]),
                          slev_zero=bool(r["meta"][0, 0, 5]),
                          chanbias=int(r["meta"][0, 0, 4]))
    for f in range(4):
        s = slice(6 * f, 6 * f + 6)
        assert not PD.steady_ok(fmt, {"blksw": r["blksw"][:, s].astype(bool),
                                      "coeff": r["coeff"][:, s]}), f


# tests/test_hetero.py's streams, then a short-block stereo stream and the
# coupling/short-block 5.1 stream (a bucket with short blocks, a bucket
# that needs the block scan)
STREAMS = ["bench_51_448.ac3", "stereo_192.ac3", "mono_96.ac3",
           "blksw20_hazard.ac3", "spec_cpl51_hazard.ac3"]


def test_mixed_formats_reference():
    """Lanes of five streams (5.1 / 2.0 / 1.0, short blocks, coupling)
    and a lane that switches 5.1 -> 2.0 mid-stream, in one batch,
    reference mode: every stream's lanes equal its golden at 0.0, the
    switching lane equals the same bytes decoded alone (its first frames
    the 5.1 golden), bit for bit.  Buckets of 3 lanes pad to 4."""
    switch = _frames("bench_51_448.ac3", 2) + _frames("stereo_192.ac3", 2)
    feeds = [_frames(s, 4) for s in STREAMS] * 3 + [switch]
    pcm = _decode(feeds, chunk=4)
    assert pcm.shape == (len(feeds), 24, 2, 256)
    for i, es in enumerate(feeds[:-1]):
        np.testing.assert_array_equal(pcm[i].reshape(-1, 512),
                                      _golden(STREAMS[i % 5])[:24])
    alone = _decode([switch], chunk=4)
    np.testing.assert_array_equal(pcm[-1], alone[0])
    np.testing.assert_array_equal(pcm[-1, :12].reshape(-1, 512),
                                  _golden("bench_51_448.ac3")[:12])
