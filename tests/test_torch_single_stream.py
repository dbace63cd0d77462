"""Port: the single-stream decode (models.decoder: _block_step,
block_pipeline, Decoder) on the CPU.

  * Decoder() in the package default reference mode against the
    reference decoder's committed output of every golden at max |diff|
    0.0, and against the port's native C++ decoder (NativeDecoder, float
    for float the reference) on streams whose format changes mid-stream,
    with DRC on, off and remapped by a callback.
  * A scan of _block_step equals the block scan _pipeline_body (the JAX
    package's tests/test_pipeline_equiv.py::
    test_hoisted_pipeline_equivalence, here on the port's side).
  * Fast mode against the JAX Decoder(exact=False) under the matmul
    reassociation bound.
"""
import os

import numpy as np
import pytest
import torch

import ac3acm_tpu.tables as JT
from ac3acm_tpu.models import decoder as JD
from ac3acm_tpu_torch import tables as T
from ac3acm_tpu_torch.host import parse as PP
from ac3acm_tpu_torch.host.native import NativeDecoder
from ac3acm_tpu_torch.models import decoder as PD
from ac3acm_tpu_torch.ops import imdct_exact as PE
from ac3acm_tpu_torch.ops.filterbank import filterbank
from tests.test_torch_general_decode import FP32_ATOL, GOLDENS, _frames

GOLDEN = os.path.join(os.path.dirname(__file__), "golden")
FLAGS = T.A52_STEREO | T.A52_ADJUST_LEVEL


def _golden(name):
    return np.load(os.path.join(GOLDEN, name + ".stereo_float.npy"))


@pytest.mark.parametrize("name", GOLDENS)
def test_decoder_equals_golden(name):
    """No set_accuracy call: the order-exact transform's plain version
    on every block, the output bit for bit the reference decoder's."""
    assert PD.ACCURACY == "reference"
    before = PE.launches
    pcm, fmt = PD.Decoder(device="cpu").decode_stream(_frames(name), FLAGS)
    assert PE.launches == before, "CPU tensors must not launch the kernel"
    assert isinstance(pcm, np.ndarray) and pcm.dtype == np.float32
    assert fmt.nch_out == 2
    np.testing.assert_array_equal(pcm.reshape(-1, 512), _golden(name))


def _switch_stream():
    """5.1 coupling frames carrying dynrng, then 5.1 frames, then 2.0
    frames: two format changes, the first two runs of one format."""
    return (_frames("cpl51_hazard.ac3") + _frames("bench_51_448.ac3", 3)
            + _frames("stereo_192.ac3", 3) + _frames("bench_51_448.ac3", 2))


@pytest.mark.parametrize("drc", ["on", "off", "callback"])
@pytest.mark.parametrize("flags,bias,nframes", [
    (FLAGS, 0.0, 14), (T.A52_DOLBY, 384.0, 14), (T.A52_MONO, 0.0, 14),
    (T.A52_3F2R | T.A52_LFE, 384.0, 9)])
def test_format_switch_equals_native_decoder(drc, flags, bias, nframes):
    """A stream that switches format mid-stream (the delay and the
    downmixed flag carry across): every block equal to NativeDecoder's.
    A 3F2R+LFE output keeps to the 5.1 frames (its 2.0 frames would give
    2 planes where the rest give 6, which no array of blocks holds)."""
    es = _switch_stream()
    if nframes == 9:
        es = _frames("cpl51_hazard.ac3") + _frames("bench_51_448.ac3", 3)
    dec, nat = PD.Decoder(device="cpu"), NativeDecoder()
    if drc == "off":
        dec.set_drc_enabled(False)
        nat.set_drc_enabled(False)
    elif drc == "callback":
        fn = lambda r: r * np.float32(0.5) + np.float32(0.125)  # noqa: E731
        dec.dynrng(fn)
        nat.set_dynrng_call(fn)
    pcm, _ = dec.decode_stream(es, flags, 1.0, bias)
    want = nat.decode_stream(es, flags, 1.0, bias)
    assert pcm.shape == want.shape and pcm.shape[0] == 6 * nframes
    np.testing.assert_array_equal(pcm, want)


def test_drc_switches_change_the_output():
    """DRC on, off and a callback give three different outputs on the
    stream that codes dynrng (so the test above checks each of them)."""
    es = _frames("cpl51_hazard.ac3")
    outs = []
    for drc in ("on", "off", "callback"):
        dec = PD.Decoder(device="cpu")
        if drc == "off":
            dec.set_drc_enabled(False)
        elif drc == "callback":
            dec.dynrng(lambda r: r * np.float32(0.5))
        outs.append(dec.decode_stream(es, FLAGS)[0])
    assert not np.array_equal(outs[0], outs[1])
    assert not np.array_equal(outs[0], outs[2])
    dec = PD.Decoder(device="cpu")
    dec.dynrng(None)                    # a52_dynrng(state): DRC off
    np.testing.assert_array_equal(dec.decode_stream(es, FLAGS)[0], outs[1])


def _rand_blocks(rng, n):
    q = rng.standard_normal((n, 6, 256)).astype(np.float32) * 3000
    a = (2.0 ** -rng.integers(15, 30, (n, 6, 256))).astype(np.float32)
    b = rng.uniform(0.2, 2.0, (n, 6, 256)).astype(np.float32)
    return {
        "freq": (q * a) * b,
        "blksw": rng.integers(0, 2, (n, 5)).astype(bool),
        "coeff": rng.uniform(0.5, 2.0, (n, 5)).astype(np.float32),
        "remat": rng.integers(0, 2, (n, 256)).astype(bool),
        "bias": np.full(n, 384.0, np.float32),
    }


def _scan_block_step(fmt, carry, blocks, fb):
    pcms = []
    for i in range(blocks["freq"].shape[0]):
        blk = {k: torch.from_numpy(np.asarray(v[i]))
               for k, v in blocks.items()}
        carry, pcm = PD._block_step(fmt, carry, blk, filterbank=fb)
        pcms.append(pcm)
    return carry, torch.stack(pcms)


@pytest.mark.parametrize("exact", [True, False])
@pytest.mark.parametrize("spec", [
    (T.A52_3F2R, T.A52_STEREO, False, 31),
    (T.A52_3F2R, T.A52_3F2R | T.A52_LFE, False, 0)], ids=["51to20", "51id"])
def test_block_step_scan_equals_pipeline_body(spec, exact):
    """_block_step scanned block by block equals _pipeline_body on the
    same blocks (random blksw, so both strategies and the downmixed flag
    flip): bit for bit in reference mode (filterbank_exact), within about
    an ulp of the peak in fast mode (a row product against the hoisted
    matrix product).  The carries are checked by decoding a second chunk
    from each."""
    fmt = PD.StreamFormat(*spec)
    fb = PE.filterbank_exact if exact else filterbank
    body = PD.block_pipeline(fmt, exact=exact)
    c1 = c2 = PD.init_carry(device="cpu")
    for seed in (3, 7):
        blocks = _rand_blocks(np.random.default_rng(seed), 12)
        c1, p1 = _scan_block_step(fmt, c1, blocks, fb)
        c2, p2 = body(c2, blocks)
        assert p1.shape == p2.shape == (12, fmt.nch_out, 256)
        if exact:
            assert torch.equal(p1, p2)
        else:
            tol = 4e-6 * max(float(p1.abs().max()), 1.0)
            np.testing.assert_allclose(p1.numpy(), p2.numpy(), rtol=0,
                                       atol=tol)
        assert bool(c1[1]) == bool(c2[1])


def test_decoder_carry_resumes_across_calls():
    """decode_frames in pieces equals one call (the carry and the parser
    persist on the Decoder); an empty stream gives no blocks."""
    frames = []
    es = _frames("blksw20_hazard.ac3")
    pos = 0
    while pos < len(es):
        size = PP.syncinfo(es[pos:pos + 7])[0]
        frames.append(es[pos:pos + size])
        pos += size
    whole, _ = PD.Decoder(device="cpu").decode_frames(frames, FLAGS)
    dec = PD.Decoder(device="cpu")
    parts = [dec.decode_frames(frames[:2], FLAGS)[0],
             dec.decode_frames(frames[2:], FLAGS)[0]]
    np.testing.assert_array_equal(np.concatenate(parts), whole)
    pcm, fmt = PD.Decoder(device="cpu").decode_stream(b"\x00" * 100, FLAGS)
    assert pcm.shape == (0, 0, 256) and fmt is None


def test_fast_mode_matches_jax_decoder():
    """Decoder(exact=False) against the JAX Decoder(exact=False) on one
    stream (float, bias 0): the matmul filterbank on both sides, within
    the reassociation bound of tests/test_torch_decoder.py."""
    es = _frames("bench_51_448.ac3")
    mine, fmt = PD.Decoder(exact=False, device="cpu").decode_stream(es, FLAGS)
    ref, jfmt = JD.Decoder(exact=False).decode_stream(es, JT.A52_STEREO
                                                      | JT.A52_ADJUST_LEVEL)
    assert (fmt.acmod, fmt.output, fmt.slev_zero, fmt.chanbias) == \
        (jfmt.acmod, jfmt.output, jfmt.slev_zero, jfmt.chanbias)
    assert mine.shape == ref.shape == (48, 2, 256)
    np.testing.assert_allclose(mine, np.asarray(ref), rtol=0, atol=FP32_ATOL)
