"""Port: the transcoder (AC-3 in -> AC-3 out) vs the JAX package.

Golden 5.1 lanes (448 kbit/s) re-encoded to 2.0 at 192 kbit/s by the
port's Transcoder (device="cpu") and the JAX package's, held to equal
bytes: native and raw parsers in reference mode, native in fast mode,
compact H2D.  JAX's exact IMDCT runs through the jax_exact_callback
fixture (a whole exact JAX pipeline would compile for 15-40 s), its raw
unpack's gathers through the numpy oracle, and its native parsers on one
thread (its copy of the host runtime races on lazy plan init).
"""
import numpy as np
import pytest
import torch

import ac3acm_tpu.tables as JT
import chip_smoke as CS
from ac3acm_tpu.models import decoder as JD
from ac3acm_tpu.parallel import pipeline as JP
from ac3acm_tpu.parallel.transcode import Transcoder as JaxTranscoder
from ac3acm_tpu_torch.host import pack as PK
from ac3acm_tpu_torch.host.native import DenseBatchParser
from ac3acm_tpu_torch.models import decoder as PD
from ac3acm_tpu_torch.models import encoder as PE
from ac3acm_tpu_torch.models.encoder import make_config
from ac3acm_tpu_torch.ops.filterbank import convert_to_int16
from ac3acm_tpu_torch.parallel import transcode as PT
from ac3acm_tpu_torch.parallel.pipeline import BatchedDecoder
from ac3acm_tpu_torch.parallel.transcode import Transcoder
from tests.test_torch_imdct_exact import (  # noqa: F401  (fixtures)
    jax_exact_callback, jax_split)
from tests.test_torch_unpack_device import _jax_gathers

LANES = CS.TC_DIGEST_LANES


@pytest.fixture
def jax_serial(monkeypatch):
    """JAX's BatchedDecoder with one parse thread, its raw gathers on the
    numpy oracle (the raw program cache emptied around the test)."""
    class Serial(JP.BatchedDecoder):
        def __init__(self, *a, **kw):
            super().__init__(*a, **dict(kw, nthreads=1))
    monkeypatch.setattr(JP, "BatchedDecoder", Serial)
    _jax_gathers(monkeypatch)
    JP._raw_pipeline_cached.cache_clear()
    yield
    JP._raw_pipeline_cached.cache_clear()


@pytest.fixture
def both_fast(monkeypatch):
    monkeypatch.setattr(JD, "ACCURACY", "fast")
    monkeypatch.setattr(PD, "ACCURACY", "fast")


@pytest.fixture(scope="module")
def chunks():
    return CS.tc_chunks(LANES)


def _port(chunks, **kw):
    tc = Transcoder(LANES, 192000, 2, device="cpu", **kw)
    outs = CS.transcode_run(tc, chunks)
    return outs, tc


def _jax(chunks, **kw):
    tc = JaxTranscoder(LANES, 192000, 2, **kw)
    return CS.transcode_run(tc, chunks), tc


def test_reference_native_matches_jax_and_digest(jax_exact_callback,
                                                 jax_serial, chunks):
    """Reference mode, native parser: the port's bytes (device and native
    pack) equal JAX's, whose digest chip_smoke.py holds the card to."""
    assert PD.ACCURACY == JD.ACCURACY == "reference"
    want, jtc = _jax(chunks)
    assert CS.tc_digest(want) == CS.TC_DIGEST
    got, tc = _port(chunks)
    assert got == want
    assert np.array_equal(tc.ok, np.asarray(jtc.ok)) and tc.ok.all()
    assert _port(chunks, pack="native")[0] == want


def test_reference_raw_matches_jax(jax_exact_callback, jax_serial, chunks):
    """Reference mode, raw parser (the device unpacks the coded frames):
    equal to JAX's raw transcode and to the native parser's bytes."""
    want, _ = _jax(chunks, parser="raw")
    assert CS.tc_digest(want) == CS.TC_DIGEST
    assert _port(chunks, parser="raw")[0] == want


def test_fast_native_matches_jax(both_fast, jax_serial, chunks):
    want, _ = _jax(chunks)
    assert _port(chunks)[0] == want


def test_compact_h2d_matches_jax(jax_exact_callback, jax_serial, chunks):
    """Block-float planes over the link: the port's compact planes are
    JAX's, so the bytes are too."""
    want, _ = _jax(chunks, compact_h2d=True)
    assert _port(chunks, compact_h2d=True)[0] == want


def test_corrupt_lane_gives_jax_ok_mask(jax_exact_callback, jax_serial,
                                        chunks):
    """A corrupt lane-frame decodes as silence and is flagged in `ok`, as
    in JAX; the batch goes on."""
    bad = [list(c) for c in chunks]
    fr = bytearray(bad[0][1])
    fr[1792 + 8:1792 + 40] = b"\xff" * 32                # lane 1, frame 1
    bad[0][1] = bytes(fr)
    jtc = JaxTranscoder(LANES, 192000, 2)
    tc = Transcoder(LANES, 192000, 2, device="cpu")
    F = CS.TC_CHUNK_FRAMES
    for k, data in enumerate(bad):
        want = jtc.step_frames(data, F)
        assert tc.step_frames(data, F) == want
        assert np.array_equal(tc.ok, np.asarray(jtc.ok))
        assert tc.ok.shape == (LANES, F)
        assert tc.ok.sum() == LANES * F - (k == 0)
        assert k or not tc.ok[1, 1]


def test_step_forms_agree(chunks):
    """step (a frame a call) == step_frames == dispatch_frames/finish with
    both chunks in flight; a short feed and a low bitrate raise."""
    ref, _ = _port(chunks)
    tc = Transcoder(LANES, 192000, 2, device="cpu")
    handles = [tc.dispatch_frames(d, CS.TC_CHUNK_FRAMES) for d in chunks]
    piped = [tc.finish(h) for h in handles]
    assert [a + b for a, b in zip(*piped)] == ref
    tc = Transcoder(LANES, 192000, 2, device="cpu")
    F = CS.TC_CHUNK_FRAMES
    per = [b""] * LANES
    for f in range(CS.TC_NCHUNKS * F):
        data = [d[f % F * 1792:(f % F + 1) * 1792] for d in chunks[f // F]]
        per = [a + b for a, b in zip(per, tc.step(data))]
    assert per == ref
    with pytest.raises(ValueError):
        Transcoder(LANES, 192000, 2, device="cpu").step_frames(
            [d[:1792] for d in chunks[0]], 2)
    with pytest.raises(RuntimeError):
        Transcoder(2, 32000, 2, device="cpu").step_frames(
            chunks[0][:2], CS.TC_CHUNK_FRAMES)
    for bad in (dict(parser="python"), dict(pack="host")):
        with pytest.raises(ValueError):
            Transcoder(2, 192000, 2, device="cpu", **bad)


def test_transcode_pipeline_accuracy_key(monkeypatch, chunks):
    """transcode_pipeline reads the accuracy mode when called, and its
    cache keys on it (the JAX package's read it once, at trace time):
    under "fast" then "reference" each call decodes in its own mode.  The
    multi-frame form, fed full planes, gives the Transcoder's bytes."""
    r = DenseBatchParser(LANES).parse(
        [b"".join(d) for d in zip(*chunks)], 8,
        JT.A52_STEREO | JT.A52_ADJUST_LEVEL, 1.0, 384.0)
    assert r["valid"].all()
    fmt = BatchedDecoder(1, JT.A52_STEREO, device="cpu")._fmt_from_meta(
        r["meta"][0, 0])
    keys = {"freq": "freq_full", "blksw": "blksw", "coeff": "coeff",
            "remat": "remat", "bias": "bias"}
    blocks = {k: torch.from_numpy(np.ascontiguousarray(r[v])) for k, v in
              keys.items()}
    blocks["blksw"] = blocks["blksw"].bool()
    blocks["remat"] = blocks["remat"].bool()
    cfg = make_config(48000, 192000, 2)
    carry = (torch.zeros((LANES, 6, 128)), torch.ones(LANES, dtype=torch.bool))
    last = torch.zeros((LANES, 2, 256), dtype=torch.int32)
    csnr = torch.full((LANES,), 40, dtype=torch.int32)
    first = {k: v[:, :6] for k, v in blocks.items()}
    runs, frames = {}, {}
    for mode in ("fast", "reference"):
        monkeypatch.setattr(PD, "ACCURACY", mode)
        runs[mode] = PT.transcode_pipeline(fmt, cfg)
        _, enc, i16 = runs[mode](carry, first, last, csnr)
        _, pcm = PD._pipeline_body(fmt, carry, first,
                                   exact=mode == "reference")
        assert torch.equal(i16, convert_to_int16(pcm)), mode
        want = PE.encode_pipeline(cfg)(
            i16.transpose(-1, -2).reshape(LANES, 1536, 2), last, csnr)
        assert all(torch.equal(enc[k], want[k]) for k in want), mode
        assert bool(enc["ok"].all())
        frames[mode] = PK.pack_frames_native(
            cfg, {k: v.numpy() for k, v in enc.items()})
    # the two modes' PCM differ here, so their frames do too
    assert frames["fast"] != frames["reference"]
    assert runs["fast"] is not runs["reference"]
    assert runs["reference"] is PT.transcode_pipeline(fmt, cfg, exact=True)
    with pytest.raises(TypeError, match="Mesh"):
        PT.transcode_pipeline(fmt, cfg, mesh=object())
    # F frames through the multi form, packed on the host
    fb = {k: v.reshape((LANES, 8, 6) + v.shape[2:]).transpose(0, 1)
          for k, v in blocks.items()}
    (_, _, _), enc = PT.transcode_pipeline_multi(fmt, cfg, exact=True)(
        carry, fb, last, csnr)
    flat = PK.pack_frames_native(cfg, {k: v.numpy() for k, v in enc.items()})
    multi = [b"".join(flat[f * LANES + b] for f in range(8))
             for b in range(LANES)]
    assert multi == _port(chunks)[0]
