"""Port: BatchedDecoder(parser="native") in fast mode vs the JAX package.

Golden 5.1 lanes through the port's BatchedDecoder (device="cpu", so the
fused kernel's plain version runs) and the JAX BatchedDecoder under
set_accuracy("fast"), which on the CPU takes the XLA steady body.  Held
to the fused-path contract (<= 1 int16 LSB, carry <= 1/32768), and the
float output to the fast-mode contract against the reference decoder's
committed output.

The JAX side runs its native parser on one thread: its copy of the host
runtime builds shared IMDCT plans lazily and unsynchronized, which can
corrupt the heap when several parse threads start at once (the port's
copy builds them once under std::call_once).
"""
import os

import numpy as np
import pytest
import torch

import ac3acm_tpu.tables as JT
from ac3acm_tpu.models import decoder as JD
from ac3acm_tpu.parallel.pipeline import BatchedDecoder as JaxDecoder
from ac3acm_tpu_torch.models import decoder as PD
from ac3acm_tpu_torch.ops import fused_steady as FS
from ac3acm_tpu_torch.parallel.pipeline import BatchedDecoder
from tests.test_torch_imdct_exact import (  # noqa: F401  (fixtures)
    jax_exact_callback, jax_split)

GOLDEN = os.path.join(os.path.dirname(__file__), "golden")
FLAGS = JT.A52_STEREO | JT.A52_ADJUST_LEVEL
FRAME = 1792                                   # bytes, 448 kbps at 48 kHz


def _es(name="bench_51_448.ac3"):
    return open(os.path.join(GOLDEN, name), "rb").read()


@pytest.fixture
def fast(monkeypatch):
    monkeypatch.setattr(JD, "ACCURACY", "fast")
    monkeypatch.setattr(PD, "ACCURACY", "fast")


def _decode_both(feeds, refeeds=(), compact=False, max_frames=3, rounds=2,
                 bias=384.0, emit_int16=True):
    """Run both decoders on the same lane feeds; -> list of
    (port chunk, jax chunk, valid) and both final carries."""
    B = len(feeds)
    port = BatchedDecoder(B, FLAGS, bias=bias, emit_int16=emit_int16,
                          compact_h2d=compact, device="cpu")
    ref = JaxDecoder(B, FLAGS, bias=bias, emit_int16=emit_int16,
                     parser="native", nthreads=1, compact_h2d=compact)
    for dec in (port, ref):
        for i, data in enumerate(feeds):
            dec.feed(i, data)
    out = []
    for k in range(rounds):
        if k == 1:
            for dec in (port, ref):
                for i, data in refeeds:
                    dec.feed(i, data)
        rp = port.decode_available(max_frames=max_frames)
        rj = ref.decode_available(max_frames=max_frames)
        assert (rp is None) == (rj is None)
        if rp is None:
            break
        np.testing.assert_array_equal(rp[1], rj[1])
        assert isinstance(rp[0], torch.Tensor) and rp[0].device.type == "cpu"
        out.append((rp[0].numpy(), np.asarray(rj[0]), rp[1]))
    return out, port._carry, ref._carry


@pytest.mark.parametrize("compact", [False, True])
def test_batched_decoder_matches_jax(fast, compact):
    es = _es()
    feeds = [es[i * FRAME:] + es[:i * FRAME] for i in range(4)]  # rotated
    before = FS.launches
    chunks, (pd_, pm), (jd, jm) = _decode_both(feeds, compact=compact)
    assert FS.launches == before, "CPU tensors must not launch the kernel"
    assert len(chunks) == 2
    for p, j, valid in chunks:
        assert valid.all() and p.dtype == np.int16
        assert p.shape == j.shape == (4, 18, 2, 256)
        assert np.abs(p.astype(np.int64) - np.asarray(j, np.int64)).max() \
            <= FS.PCM_LSB_TOL
    np.testing.assert_allclose(pd_.numpy(), np.asarray(jd), rtol=0,
                               atol=FS.CARRY_ATOL)
    np.testing.assert_array_equal(pm.numpy(), np.asarray(jm))


def test_uneven_feed_matches_jax(fast):
    """Lane 0 gets 2 frames first: the pending-frame path reassembles the
    rest on the next call, on both sides."""
    es = _es()
    feeds = [es[:2 * FRAME], es[:6 * FRAME], es[:6 * FRAME]]
    chunks, _, _ = _decode_both(feeds, refeeds=[(0, es[2 * FRAME:6 * FRAME])],
                                max_frames=4)
    assert [c[0].shape[1] for c in chunks] == [12, 24]
    for p, j, valid in chunks:
        assert valid.all()
        assert np.abs(p.astype(np.int64) - np.asarray(j, np.int64)).max() \
            <= FS.PCM_LSB_TOL


def test_float_output_meets_fast_contract_vs_oracle(fast):
    """Float PCM at bias 0 over the oracle's 48 blocks: the fast-mode
    contract against the reference decoder (models/decoder.py:39-44)."""
    es = _es()
    oracle = np.load(os.path.join(GOLDEN, "bench_51_448.ac3.stereo_float.npy"))
    dec = BatchedDecoder(1, FLAGS, bias=0.0, device="cpu")
    dec.feed(0, es)
    pcm, valid = dec.decode_available(max_frames=8)
    assert valid.all() and pcm.shape == (1, 48, 2, 256)
    err = (pcm[0].numpy().reshape(48, 512).astype(np.float64)
           - oracle.astype(np.float64)) * 32768.0
    assert np.abs(err).max() <= 0.02
    assert np.abs(err).mean() <= 0.001
    assert err.std() <= 0.002


def test_dense_parser_bitwise():
    """The port's copy of the native parser emits JAX's tensors bit for bit
    (premixed, compact, full planes, side info)."""
    from ac3acm_tpu.host.native import DenseBatchParser as JaxParser
    from ac3acm_tpu_torch.host.native import DenseBatchParser
    es = _es()
    bufs = [es[i * FRAME:] + es[:i * FRAME] for i in range(3)]
    r_port = DenseBatchParser(3).parse(bufs, 5, FLAGS, 1.0, 384.0, 2,
                                       compact=True)
    r_jax = JaxParser(3, nthreads=1).parse(bufs, 5, FLAGS, 1.0, 384.0, 2,
                                           compact=True)
    assert r_port.keys() == r_jax.keys()
    for key in r_jax:
        np.testing.assert_array_equal(r_port[key], r_jax[key], err_msg=key)
        assert r_port[key].dtype == r_jax[key].dtype, key


def test_unported_paths_refuse(fast):
    """A mesh slot given anything but a Mesh raises TypeError with every
    parser instead of guessing (tests/test_torch_mesh.py decodes on a
    mesh)."""
    for parser in ("native", "raw", "python", "raw_py"):
        with pytest.raises(TypeError, match="Mesh"):
            BatchedDecoder(2, FLAGS, mesh=object(), parser=parser,
                           device="cpu")


def test_mixed_format_batch_matches_lanes_alone(fast):
    """A mixed-format batch decodes, each lane within 1 LSB of its stream
    decoded alone."""
    streams = [_es()[:2 * FRAME], _es("stereo_192.ac3")[:2 * 768]]
    dec = BatchedDecoder(2, FLAGS, bias=384.0, emit_int16=True, device="cpu")
    for i, es in enumerate(streams):
        dec.feed(i, es)
    pcm, valid = dec.decode_available(max_frames=2)
    assert valid.all() and pcm.shape == (2, 12, 2, 256)
    for i, es in enumerate(streams):
        one = BatchedDecoder(1, FLAGS, bias=384.0, emit_int16=True,
                             device="cpu")
        one.feed(0, es)
        want, _ = one.decode_available(max_frames=2)
        assert np.abs(pcm[i].numpy().astype(np.int64)
                      - want[0].numpy().astype(np.int64)).max() \
            <= FS.PCM_LSB_TOL


def _drain(parser, feeds, refeeds=(), max_frames=3, bias=384.0,
           emit_int16=True, flags=FLAGS):
    """Every chunk of one port BatchedDecoder over the lane feeds (refeeds
    arrive after the first chunk) -> (PCM [L, blocks, nch, 256], valid,
    the decoder)."""
    dec = BatchedDecoder(len(feeds), flags, bias=bias, emit_int16=emit_int16,
                         parser=parser, device="cpu")
    for i, data in enumerate(feeds):
        dec.feed(i, data)
    chunks, valids = [], []
    while True:
        r = dec.decode_available(max_frames=max_frames)
        if r is None:
            break
        chunks.append(r[0])
        valids.append(r[1])
        for i, data in refeeds:
            dec.feed(i, data)
        refeeds = ()
    return torch.cat(chunks, dim=1), np.concatenate(valids, axis=1), dec


@pytest.mark.parametrize("mode", ["reference", "fast"])
@pytest.mark.parametrize("emit_int16", [True, False])
def test_python_parser_equals_native(monkeypatch, mode, emit_int16):
    """parser="python" (A52Parser per lane) gives the native parser's PCM
    and carry bit for bit: rotated lanes, an uneven feed (the pending
    frames), in both accuracy modes, int16 and float."""
    monkeypatch.setattr(PD, "ACCURACY", mode)
    es = _es()
    feeds = [es[:2 * FRAME]] + [es[i * FRAME:] + es[:i * FRAME]
                                for i in range(1, 3)]
    refeeds = [(0, es[2 * FRAME:])]
    (pn, vn, dn), (pp, vp, dp) = (
        _drain(p, feeds, refeeds, emit_int16=emit_int16)
        for p in ("native", "python"))
    assert pn.shape == pp.shape == (3, 48, 2, 256)
    assert vn.all() and vp.all()
    assert pp.dtype == (torch.int16 if emit_int16 else torch.float32)
    assert torch.equal(pn, pp)
    assert torch.equal(dn._carry[0], dp._carry[0])
    assert torch.equal(dn._carry[1], dp._carry[1])


@pytest.mark.parametrize("mode", ["reference", "fast"])
def test_raw_py_equals_raw(monkeypatch, mode):
    """parser="raw_py" (the side-info-only A52Parser) ships the native
    side-info parser's meta and frame bytes bitwise and decodes the same
    int16 PCM, on the main stream and on the coupling stream."""
    monkeypatch.setattr(PD, "ACCURACY", mode)
    from ac3acm_tpu_torch.parallel import pipeline as PL
    seen = {}
    orig = PL.BatchedDecoder._raw_dispatch

    def spy(self, fmt, fu8, meta, valid, clock=None):
        seen.setdefault(self._parser_kind, []).append((fmt, fu8, meta))
        return orig(self, fmt, fu8, meta, valid, clock)

    monkeypatch.setattr(PL.BatchedDecoder, "_raw_dispatch", spy)
    es = _es()
    cpl = _es("cpl51_hazard.ac3")
    for feeds in ([es[i * FRAME:] + es[:i * FRAME] for i in range(3)],
                  [cpl, cpl]):
        seen.clear()
        (pr, vr, _), (pp, vp, _) = (_drain(p, feeds, max_frames=4)
                                    for p in ("raw", "raw_py"))
        assert vr.all() and vp.all()
        assert torch.equal(pr, pp)
        assert len(seen["raw"]) == len(seen["raw_py"]) >= 2
        for (f1, u1, m1), (f2, u2, m2) in zip(seen["raw"], seen["raw_py"]):
            assert f1 == f2
            np.testing.assert_array_equal(u1, u2)
            assert m1.keys() == m2.keys()
            for k in m1:
                assert m1[k].dtype == m2[k].dtype, k
                np.testing.assert_array_equal(m1[k], m2[k], err_msg=k)


def test_python_mixed_formats_equal_native(monkeypatch):
    """A mixed-format batch with a mid-stream 5.1 -> 2.0 switch through
    the python parser (FrameData buckets, premixed per bucket) equals the
    native parser's, in reference and fast mode; a mixed raw_py batch
    refuses as raw does."""
    b51, st = _es()[:3 * FRAME], _es("stereo_192.ac3")[:3 * 768]
    mono = _es("mono_96.ac3")
    feeds = [b51, st, mono[:len(mono) // 2], b51[:FRAME] + st[:2 * 768]]
    for mode in ("reference", "fast"):
        monkeypatch.setattr(PD, "ACCURACY", mode)
        (pn, _, _), (pp, _, _) = (_drain(p, feeds, max_frames=3)
                                  for p in ("native", "python"))
        assert pn.shape == pp.shape
        assert torch.equal(pn, pp)
    dec = BatchedDecoder(2, FLAGS, parser="raw_py", device="cpu")
    dec.feed(0, b51)
    dec.feed(1, st)
    with pytest.raises(ValueError, match="format-homogeneous"):
        dec.decode_available(max_frames=2)


def _damaged(es, frame, seed=5):
    """es with six bytes of one frame's side info flipped: the parsers
    reject that frame and go on with the next."""
    rng = np.random.default_rng(seed)
    bad = bytearray(es)
    for k in rng.integers(8, 64, 6):
        bad[frame * FRAME + int(k)] ^= int(rng.integers(1, 256))
    return bytes(bad)


def test_python_parsers_mask_rejected_frames_as_native():
    """A frame with damaged side info is masked at the same place by all
    four parsers (valid False), and the PCM around it is the same bit for
    bit: python == native, raw_py == raw, in a homogeneous batch and in a
    mixed-format one."""
    es = _es()
    feeds = [es, _damaged(es, 2), es[FRAME:] + es[:FRAME]]
    pcm, valid = {}, {}
    for parser in ("native", "python", "raw", "raw_py"):
        pcm[parser], valid[parser], _ = _drain(parser, feeds, max_frames=8)
    want = np.ones((3, 8), bool)
    want[1, 2] = False
    for parser in pcm:
        np.testing.assert_array_equal(valid[parser], want, err_msg=parser)
    assert torch.equal(pcm["native"], pcm["python"])
    assert torch.equal(pcm["raw"], pcm["raw_py"])
    mixed = [es[:6 * FRAME], _damaged(es, 2)[:6 * FRAME],
             _es("stereo_192.ac3")]
    (pn, vn, _), (pp, vp, _) = (
        _drain(p, mixed, max_frames=6, bias=0.0, emit_int16=False)
        for p in ("native", "python"))
    np.testing.assert_array_equal(vn, vp)
    assert not vn[1, 2] and vn.sum() == 17
    assert torch.equal(pn, pp)


def test_unknown_parser_raises():
    with pytest.raises(ValueError, match="parser="):
        BatchedDecoder(2, FLAGS, parser="fortran", device="cpu")


def test_passthrough_lanes_match_jax(fast):
    """Stereo -> stereo (identity-mix premix, the fused kernel's time-path
    layout) through both decoders."""
    es = _es("stereo_192.ac3")
    chunks, (pd_, pm), (jd, jm) = _decode_both([es] * 3, max_frames=2)
    assert len(chunks) == 2
    for p, j, valid in chunks:
        assert valid.all() and p.shape == j.shape == (3, 12, 2, 256)
        assert np.abs(p.astype(np.int64) - np.asarray(j, np.int64)).max() \
            <= FS.PCM_LSB_TOL
    np.testing.assert_allclose(pd_.numpy(), np.asarray(jd), rtol=0,
                               atol=FS.CARRY_ATOL)
    np.testing.assert_array_equal(pm.numpy(), np.asarray(jm))


def test_parse_threads_do_not_race():
    """Many parse threads entering the native host at once, in fresh
    processes (the IMDCT plans are built once per process): every run must
    finish and parse every frame."""
    import subprocess
    import sys
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    code = (
        "import sys\n"
        "from ac3acm_tpu_torch import tables as T\n"
        "from ac3acm_tpu_torch.host.native import DenseBatchParser\n"
        f"es = open({os.path.join(GOLDEN, 'bench_51_448.ac3')!r}, 'rb').read()\n"
        f"bufs = [es[(i % 8) * {FRAME}:] + es[:(i % 8) * {FRAME}] "
        "for i in range(32)]\n"
        "r = DenseBatchParser(32, 32).parse(bufs, 4, T.A52_STEREO | "
        "T.A52_ADJUST_LEVEL, 1.0, 384.0, 2)\n"
        "assert (r['nframes'] == 4).all() and r['valid'].all()\n")
    env = dict(os.environ, PYTHONPATH=root)
    procs = [subprocess.Popen([sys.executable, "-c", code], cwd=root, env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE)
             for _ in range(6)]
    for p in procs:
        _, err = p.communicate(timeout=120)
        assert p.returncode == 0, err.decode()[-2000:]


def test_positional_order_keeps_the_mesh_slot():
    """The JAX package's positional order (batch, flags, level, bias, mesh,
    emit_int16, ...) binds mesh to mesh: the positional call decodes the
    same int16 PCM as the keyword call, and a mesh slot given anything
    but a Mesh raises TypeError in every entry point, by position or by
    keyword."""
    from ac3acm_tpu_torch.parallel.pipeline import (batched_pipeline,
                                                    raw_batched_pipeline)
    es = _es()[:4 * FRAME]
    outs = []
    for make in (lambda: BatchedDecoder(2, FLAGS, 1.0, 384.0, None, True,
                                        device="cpu"),
                 lambda: BatchedDecoder(2, FLAGS, level=1.0, bias=384.0,
                                        mesh=None, emit_int16=True,
                                        device="cpu")):
        dec = make()
        for i in range(2):
            dec.feed(i, es)
        pcm, valid = dec.decode_available(max_frames=4)
        assert valid.all() and pcm.dtype == torch.int16
        outs.append(pcm)
    assert torch.equal(outs[0], outs[1])
    fmt = PD.StreamFormat(JT.A52_3F2R, JT.A52_STEREO, False, 0)
    for call in (lambda: BatchedDecoder(2, FLAGS, mesh=object(),
                                        device="cpu"),
                 lambda: BatchedDecoder(2, FLAGS, 1.0, 0.0, object(),
                                        device="cpu"),
                 lambda: batched_pipeline(fmt, object()),
                 lambda: batched_pipeline(fmt, mesh=object()),
                 lambda: raw_batched_pipeline(fmt, object()),
                 lambda: raw_batched_pipeline(fmt, mesh=object())):
        with pytest.raises(TypeError, match="Mesh"):
            call()


# ROADMAP A4's guard on other output modes: (stream, flags) pairs whose
# outputs are not the stereo downmix of the goldens
# and the stream's frame size
OUTPUT_MODES = [("bench_51_448.ac3", JT.A52_3F2R | JT.A52_LFE, FRAME),
                ("bench_51_448.ac3", JT.A52_MONO | JT.A52_ADJUST_LEVEL, FRAME),
                ("stereo_192.ac3", JT.A52_DOLBY, 768)]


@pytest.mark.parametrize("name,flags,size", OUTPUT_MODES)
def test_output_modes_match_jax(jax_exact_callback, name, flags, size):
    """Other output modes in the default reference mode, float at bias 0:
    the port's native, python and raw parsers against the JAX
    BatchedDecoder (its order-exact transform reached through a host
    callback, so each format compiles one elementwise program), by
    value."""
    nfr = 4
    feeds = [_es(name)[:nfr * size]] * 2
    ref = JaxDecoder(2, flags, bias=0.0, parser="native", nthreads=1)
    for i, data in enumerate(feeds):
        ref.feed(i, data)
    want, jvalid = ref.decode_available(max_frames=nfr)
    assert np.asarray(jvalid).all()
    for parser in ("native", "python", "raw"):
        pcm, valid, _ = _drain(parser, feeds, max_frames=nfr, bias=0.0,
                               emit_int16=False, flags=flags)
        assert valid.all() and pcm.shape == np.asarray(want).shape, parser
        assert np.array_equal(pcm.numpy(), np.asarray(want)), parser
