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
    """Other parsers and mixed-format batches raise instead of guessing."""
    with pytest.raises(NotImplementedError, match="ROADMAP A3"):
        BatchedDecoder(2, FLAGS, parser="python", device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP A6"):
        BatchedDecoder(2, FLAGS, parser="raw", device="cpu")
    dec = BatchedDecoder(2, FLAGS, bias=384.0, emit_int16=True, device="cpu")
    dec.feed(0, _es())
    dec.feed(1, _es("stereo_192.ac3"))
    with pytest.raises(NotImplementedError, match="ROADMAP A4"):
        dec.decode_available(max_frames=2)


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
