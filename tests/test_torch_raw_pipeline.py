"""Port: BatchedDecoder(parser="raw") in fast mode vs the JAX package.

The same lane feeds go through the port's raw-H2D decoder (device="cpu":
every kernel wrapper runs its plain version) and the JAX package's
BatchedDecoder(parser="raw"), both under ACCURACY="fast", in small chunks
so that every carry crosses chunk boundaries.  Held to:

  * PCM within 1 int16 LSB (float output within 1/32768), the fused-path
    contract both decode tails share (ops/fused_steady.py);
  * the unpack carry (exponents, coupling coordinates, dither position)
    bitwise, and the OLA delay carry within CARRY_ATOL;
  * the same validity mask, corrupt lane included.

The JAX unpack's Pallas gathers run through the JAX package's numpy
oracle (see tests/test_torch_unpack_device.py); its native side-info
parser runs on one thread (its copy of the host runtime races on lazy
plan init, which the port's copy fixes).
"""
import os

import numpy as np
import pytest
import torch

import ac3acm_tpu.tables as JT
from ac3acm_tpu.models import decoder as JD
from ac3acm_tpu.parallel import pipeline as JP
from ac3acm_tpu_torch.models import decoder as PD
from ac3acm_tpu_torch.ops import bitgather as BG
from ac3acm_tpu_torch.ops import fused_steady as FS
from ac3acm_tpu_torch.parallel.pipeline import BatchedDecoder
from tests import streamgen
from tests.test_torch_unpack_device import _jax_gathers

GOLDEN = os.path.join(os.path.dirname(__file__), "golden")
FLAGS51 = JT.A52_STEREO | JT.A52_ADJUST_LEVEL


def _es(name):
    return open(os.path.join(GOLDEN, name), "rb").read()


@pytest.fixture(scope="module")
def jax_ref():
    """JAX in fast mode with its gathers on the numpy oracle; the raw
    program cache is emptied on the way in and out."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JD, "ACCURACY", "fast")
        _jax_gathers(mp)
        JP._raw_pipeline_cached.cache_clear()
        yield
        JP._raw_pipeline_cached.cache_clear()


@pytest.fixture
def fast(monkeypatch):
    monkeypatch.setattr(PD, "ACCURACY", "fast")


def _corrupt(es, frame, size=1792):
    """Wreck one frame's side info; its sync word survives, so the frame
    is parsed and fails (a masked lane-frame), and the lane resyncs."""
    bad = bytearray(es)
    bad[frame * size + 8: frame * size + 40] = b"\xff" * 32
    return bytes(bad)


def _decode_both(feeds, flags, chunk, emit_int16, refeeds=()):
    """Both decoders on the same lane feeds, drained in `chunk`-frame
    steps; `refeeds` [(lane, bytes)] arrive after the first step."""
    L = len(feeds)
    port = BatchedDecoder(L, flags, bias=384.0 if emit_int16 else 0.0,
                          emit_int16=emit_int16, parser="raw", device="cpu")
    ref = JP.BatchedDecoder(L, flags, bias=384.0 if emit_int16 else 0.0,
                            emit_int16=emit_int16, parser="raw", nthreads=1)
    for dec in (port, ref):
        for i, data in enumerate(feeds):
            dec.feed(i, data)
    out = []
    while True:
        if len(out) == 1:
            for dec in (port, ref):
                for i, data in refeeds:
                    dec.feed(i, data)
        rp = port.decode_available(max_frames=chunk)
        rj = ref.decode_available(max_frames=chunk)
        assert (rp is None) == (rj is None)
        if rp is None:
            return out, port, ref
        np.testing.assert_array_equal(rp[1], rj[1])
        assert rp[0].device.type == "cpu"
        out.append((rp[0].numpy(), np.asarray(rj[0]), rp[1]))


def _check(out, port, ref, emit_int16, nchunks):
    assert len(out) == nchunks
    for p, j, _ in out:
        assert p.shape == j.shape and p.dtype == j.dtype
        if emit_int16:
            d = np.abs(p.astype(np.int64) - j.astype(np.int64)).max()
            assert d <= FS.PCM_LSB_TOL, d
        else:
            d = np.abs(p.astype(np.float64) - j.astype(np.float64)).max()
            assert d <= 1.0 / 32768, d
    for k in ("exp", "cplco", "dpos"):
        np.testing.assert_array_equal(port._raw_carry[k].numpy(),
                                      np.asarray(ref._raw_carry[k]),
                                      err_msg=k)
    np.testing.assert_allclose(port._carry[0].numpy(),
                               np.asarray(ref._carry[0]), rtol=0,
                               atol=FS.CARRY_ATOL)
    np.testing.assert_array_equal(port._carry[1].numpy(),
                                  np.asarray(ref._carry[1]))


def test_bench_51_int16_with_corrupt_lane(jax_ref, fast):
    """5.1 -> 2.0 int16 (no coupling, dither, LFE: the trimmed lattice and
    the i16 dither route); lane 1's third frame is corrupt."""
    es = _es("bench_51_448.ac3")[:6 * 1792]
    before = (BG.launches_fields, BG.launches_shared, BG.launches_i16)
    out, port, ref = _decode_both([es, _corrupt(es, 2)], FLAGS51, 3, True)
    assert (BG.launches_fields, BG.launches_shared, BG.launches_i16) \
        == before, "CPU tensors must not launch the kernels"
    _check(out, port, ref, True, 2)
    valid = np.concatenate([v for _, _, v in out], axis=1)
    assert valid[0].all() and not valid[1, 2] and valid[1, 3:].all()


def test_uneven_feed(jax_ref, fast):
    """Lane 0 gets 2 frames first: the pending-frame path assembles the
    rest of the chunk on the next call, on both sides."""
    es = _es("bench_51_448.ac3")[:6 * 1792]
    out, port, ref = _decode_both([es[:2 * 1792], es, es], FLAGS51, 4, True,
                                  refeeds=[(0, es[2 * 1792:])])
    _check(out, port, ref, True, 2)
    assert [p.shape[1] for p, _, _ in out] == [12, 24]


def _port_pcm(feeds, chunk, clock=None):
    """The port's raw decoder alone: per-lane int16 PCM [L, blocks, 2,
    256] over every chunk, each feed [(bytes, ...)] arriving one piece
    per call."""
    L = len(feeds)
    dec = BatchedDecoder(L, FLAGS51, bias=384.0, emit_int16=True,
                         parser="raw", device="cpu")
    lanes = [[] for _ in range(L)]
    step = 0
    while True:
        for i, pieces in enumerate(feeds):
            if step < len(pieces):
                dec.feed(i, pieces[step])
        r = dec.decode_available(max_frames=chunk, clock=clock)
        step += 1
        if r is None and step >= max(len(p) for p in feeds):
            return [np.concatenate(b) for b in lanes]
        if r is not None:
            for i in range(L):
                lanes[i].append(r[0][i].numpy())


def test_uneven_feeds_assemble_like_even(fast):
    """Lanes fed in pieces of 1, 3 and 6 frames leave different pending
    counts on every call; each lane's PCM matches the same lanes fed whole,
    within the 1 LSB the steady tail may round differently per batch."""
    es = _es("bench_51_448.ac3")[:6 * 1792]
    cut = lambda k: [es[:k * 1792], es[k * 1792:]]
    want = _port_pcm([[es]] * 3, 2)
    got = _port_pcm([cut(1), cut(3), [es]], 2)
    for w, g in zip(want, got):
        assert w.shape == g.shape == (36, 2, 256)
        assert np.abs(w.astype(np.int64) - g.astype(np.int64)).max() \
            <= FS.PCM_LSB_TOL


def test_stage_clock_breaks_down_a_step(fast):
    """StageClock names every stage of one raw step and keeps the
    dequantized blocks; the native step refuses one."""
    from ac3acm_tpu_torch.parallel.pipeline import StageClock
    clock = StageClock("cpu")
    dec = BatchedDecoder(1, FLAGS51, emit_int16=True, parser="raw",
                         device="cpu")
    dec.feed(0, _es("bench_51_448.ac3")[:2 * 1792])
    pcm, valid = dec.decode_available(max_frames=2, clock=clock)
    assert list(clock.seconds) == [
        "host side-info parse", "chunk assembly", "prune + plan probes",
        "H2D copy", "device unpack", "steady tail + int16"]
    assert all(s >= 0 for s in clock.seconds.values())
    assert clock.kept["blocks"]["freq"].shape == (1, 12, 6, 256)
    assert clock.kept["h2d_bytes"] > 2 * 1792
    native = BatchedDecoder(1, FLAGS51, device="cpu")
    with pytest.raises(ValueError, match="raw-H2D"):
        native.decode_available(max_frames=2, clock=clock)


def test_stereo_float(jax_ref, fast):
    """Stereo passthrough with float output."""
    es = _es("stereo_192.ac3")
    out, port, ref = _decode_both([es, es[768:] + es[:768]], JT.A52_STEREO,
                                  3, False)
    _check(out, port, ref, False, 2)


def test_cpl51_int16(jax_ref, fast):
    """5.1 with coupling, dither and LFE: the interleaved coupling lattice
    and the shared-table dither route.  (Its frames lean on the state of
    the frame before, so every lane starts at frame 0.)"""
    es = _es("cpl51_hazard.ac3")
    out, port, ref = _decode_both([es, es], FLAGS51, 3, True)
    _check(out, port, ref, True, 2)
    assert all(v.all() for _, _, v in out)


def test_plan_flip_across_chunks(jax_ref, fast):
    """Coupling appearing and leaving mid-stream: 2-frame chunks switch
    between the no-coupling and the coupling plan, and the carries hand
    over."""
    plain = streamgen.gen_stream(31, 2, False, nframes=2)
    cpl = streamgen.gen_stream(11, 2, False, nframes=2, want_cpl=True)
    out, port, ref = _decode_both([plain + cpl + plain], JT.A52_STEREO, 2,
                                  False)
    _check(out, port, ref, False, 3)


def test_mixed_formats_raise(fast):
    dec = BatchedDecoder(2, FLAGS51, parser="raw", device="cpu")
    dec.feed(0, _es("bench_51_448.ac3"))
    dec.feed(1, _es("stereo_192.ac3"))
    with pytest.raises(ValueError, match="homogeneous"):
        dec.decode_available(max_frames=2)


def test_unported_paths_raise(fast, monkeypatch):
    """A mesh slot given anything but a Mesh raises TypeError on both raw
    parsers (tests/test_torch_mesh.py decodes on a mesh); the Python
    parsers are ported and decode.  Short blocks (the block
    scan) decode: the raw PCM equals the native parser's bitwise, and the
    Python parsers' PCM theirs.  Reference accuracy (the order-exact
    IMDCT) decodes: float output at bias 0 equals the reference decoder's
    bit for bit."""
    for parser in ("raw", "raw_py"):
        with pytest.raises(TypeError, match="Mesh"):
            BatchedDecoder(1, FLAGS51, mesh=object(), parser=parser,
                           device="cpu")
    es = streamgen.gen_stream(16, 3, False, nframes=2, want_blksw=True)
    pcms = []
    for parser in ("raw", "native", "raw_py", "python"):
        dec = BatchedDecoder(1, JT.A52_STEREO, parser=parser, device="cpu")
        dec.feed(0, es)
        pcm, valid = dec.decode_available(max_frames=2)
        assert valid.all()
        pcms.append(pcm)
    for pcm in pcms[1:]:
        assert torch.equal(pcms[0], pcm)
    monkeypatch.setattr(PD, "ACCURACY", "reference")
    dec = BatchedDecoder(1, FLAGS51, parser="raw", device="cpu")
    dec.feed(0, _es("bench_51_448.ac3"))
    pcm, valid = dec.decode_available(max_frames=2)
    oracle = np.load(os.path.join(GOLDEN, "bench_51_448.ac3.stereo_float.npy"))
    assert valid.all()
    np.testing.assert_array_equal(pcm[0].numpy().reshape(12, 512),
                                  oracle[:12])
