"""Port: the mesh and the lane split over 'data' (parallel/mesh.py) vs the
JAX package.

The JAX side runs on the 8 virtual CPU devices that conftest.py sets up
(jax.sharding), the port's on make_mesh(..., devices=["cpu"] * 8): a mesh
that names the CPU eight times, so that every line of the split runs, one
shard after another, with each kernel's plain version.  Inputs are
tests/test_mesh.py's (golden 5.1 blocks, per-lane gain jitter, a random
carry) or numpy made from a seed, handed to both packages.  Held to:

  * the port's mesh call against its one-device call: bitwise (reference
    mode, the raw unpack, the encoder, the transcode); fast mode within
    1 int16 LSB, the fast path's contract (ops/fused_steady.py);
  * the JAX mesh call: by value in reference mode (JAX's CPU FMA guard
    turns -0.0 into +0.0, tests/test_torch_imdct_exact.py); tp_filterbank
    within 8 ulp at full scale (tests/test_mesh.py's bound); the decoder
    within tests/test_mesh.py's 1 ulp at bias 384.

JAX's exact transform compiles natively here: the jax_exact_callback
fixture's host callback, run inside a sharded program, deadlocks XLA:CPU's
collectives, and so does the numpy oracle that stands in for the raw
unpack's Pallas gathers elsewhere.  So the port's raw parsers are held to
JAX's mesh decode of the same lanes through its native parser (JAX's raw
PCM equals its native PCM bitwise, tests/test_raw_pipeline.py), and the
transcode to JAX's mesh transcode in fast mode.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

import ac3acm_tpu.tables as JT
import chip_smoke as CS
from ac3acm_tpu.host.native import NativeParser as JaxNativeParser
from ac3acm_tpu.models import decoder as JD
from ac3acm_tpu.models.encoder import make_config as jax_make_config
from ac3acm_tpu.ops.filterbank import filterbank as jax_filterbank
from ac3acm_tpu.parallel import mesh as JM
from ac3acm_tpu.parallel import pipeline as JP
from ac3acm_tpu.parallel import transcode as JTC
from ac3acm_tpu.parallel.encode import BatchedEncoder as JaxEncoder
from ac3acm_tpu_torch.models import decoder as PD
from ac3acm_tpu_torch.models.encoder import make_config
from ac3acm_tpu_torch.ops import bitgather as BG
from ac3acm_tpu_torch.ops.filterbank import filterbank
from ac3acm_tpu_torch.ops.unpack_device import (init_unpack_carry,
                                                prune_raw_meta)
from ac3acm_tpu_torch.parallel import pipeline as PP
from ac3acm_tpu_torch.parallel import transcode as PT
from ac3acm_tpu_torch.parallel.encode import BatchedEncoder
from ac3acm_tpu_torch.parallel.mesh import (Mesh, Sharded, make_mesh,
                                            replicated, stream_sharding)
from ac3acm_tpu_torch.parallel.pipeline import (BatchedDecoder,
                                                batched_pipeline,
                                                init_batched_carry,
                                                raw_batched_pipeline,
                                                tp_filterbank)
from ac3acm_tpu_torch.utils import state as S

pytestmark = pytest.mark.skipif(
    len(jax.devices()) < 8, reason="needs the 8-device virtual CPU mesh")

GOLDEN = os.path.join(os.path.dirname(__file__), "golden")
FLAGS = JT.A52_STEREO | JT.A52_ADJUST_LEVEL
FRAME = 1792                                   # bytes, 448 kbps at 48 kHz


def _es(name="bench_51_448.ac3"):
    return open(os.path.join(GOLDEN, name), "rb").read()


def _cpu_mesh(data, model=1):
    return make_mesh(data, model, devices=["cpu"] * (data * model))


def _bits(x):
    """A float tensor's or array's bit patterns, for bitwise equality."""
    x = np.ascontiguousarray(np.asarray(x))
    return x.view(np.int32) if x.dtype == np.float32 else x


def _same_bits(a, b, what=""):
    np.testing.assert_array_equal(_bits(a), _bits(b), err_msg=what)


@pytest.fixture
def fast(monkeypatch):
    monkeypatch.setattr(JD, "ACCURACY", "fast")
    monkeypatch.setattr(PD, "ACCURACY", "fast")


@pytest.fixture(scope="module")
def golden():
    """tests/test_mesh.py's inputs: 16 lanes of the golden 5.1 stream's
    first 4 frames, with a per-lane gain jitter on the planes, and a
    random carry.  -> (JAX format, port format, numpy blocks, delay)."""
    blocks1, meta = JaxNativeParser().decode_frames(_es(), 4, FLAGS, 1.0,
                                                    384.0)
    spec = (meta["acmod"], meta["output"], meta["slev"] == 0.0,
            meta["chanbias"])
    rng = np.random.default_rng(7)
    blocks = {k: np.broadcast_to(v, (16,) + v.shape).copy()
              for k, v in blocks1.items()}
    blocks["freq"] = (blocks["freq"]
                      * (1.0 + rng.uniform(-0.1, 0.1, (16, 1, 1, 1)))
                      ).astype(np.float32)
    delay = rng.standard_normal((16, 6, 128)).astype(np.float32) * 0.01
    return JD.StreamFormat(*spec), PD.StreamFormat(*spec), blocks, delay


def _jax_put(mesh, tree):
    shard = NamedSharding(mesh, P("data"))
    return jax.tree.map(lambda x: jax.device_put(jnp.asarray(x), shard),
                        tree)


def _tensors(tree):
    return jax.tree.map(torch.from_numpy, tree)


# -- the mesh itself ---------------------------------------------------------

def test_make_mesh_layout_and_placement():
    """make_mesh lays devices out row-major as JAX's does; put splits the
    lane axis into equal contiguous blocks on each row's model-0 device
    (replicated: a whole copy each); gather and np.asarray give the whole
    tensor back; a tensor already placed is not moved."""
    mesh = _cpu_mesh(4, 2)
    assert isinstance(mesh, Mesh) and mesh.axis_names == ("data", "model")
    assert mesh.shape == {"data": 4, "model": 2} == dict(
        JM.make_mesh(data=4, model=2).shape)
    assert mesh.devices.shape == (4, 2) and mesh.size == 8
    assert mesh == _cpu_mesh(4, 2) and hash(mesh) == hash(_cpu_mesh(4, 2))
    assert make_mesh(model=2, devices=["cpu"] * 8).shape["data"] == 4
    x = np.arange(8 * 3, dtype=np.float32).reshape(8, 3)
    s = stream_sharding(mesh).put(x)
    assert isinstance(s, Sharded) and len(s.parts) == 4
    assert [tuple(p.shape) for p in s.parts] == [(2, 3)] * 4
    assert tuple(s.shape) == (8, 3) and s.dtype == torch.float32
    np.testing.assert_array_equal(np.asarray(s), x)
    np.testing.assert_array_equal(s.gather().numpy(), x)
    assert stream_sharding(mesh).put((s,))[0] is s
    r = replicated(mesh).put(torch.from_numpy(x))
    assert not r.split and all(torch.equal(p, torch.from_numpy(x))
                               for p in r.parts)
    assert tuple(r.shape) == (8, 3)
    # a replicated tensor placed over 'data' is split, and back
    np.testing.assert_array_equal(
        np.asarray(stream_sharding(mesh).put(r)), x)


def test_mesh_refusals(monkeypatch):
    """make_mesh() with no card raises, naming devices=; a grid that does
    not match the device count raises; a batch that 'data' does not
    divide raises ValueError, as a JAX NamedSharding refuses it; anything
    but a Mesh in a mesh slot raises TypeError."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="devices="):
        make_mesh()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_mesh(devices=["cuda:0"] * 2)
    with pytest.raises(ValueError, match="3x2 != 8"):
        make_mesh(3, 2, devices=["cpu"] * 8)
    mesh = _cpu_mesh(4)
    with pytest.raises(ValueError, match="does not divide"):
        stream_sharding(mesh).put(np.zeros((6, 2)))
    fmt = PD.StreamFormat(JT.A52_3F2R, JT.A52_STEREO, False, 0)
    with pytest.raises(ValueError, match="does not divide"):
        batched_pipeline(fmt, mesh)(
            init_batched_carry(6, device="cpu"),
            {"freq": torch.zeros(6, 6, 6, 256)})
    with pytest.raises(ValueError, match="does not divide"):
        BatchedDecoder(6, FLAGS, mesh=mesh)
    for call in (lambda: batched_pipeline(fmt, object()),
                 lambda: raw_batched_pipeline(fmt, object()),
                 lambda: init_batched_carry(8, object()),
                 lambda: tp_filterbank(object(), None, None, None, None),
                 lambda: BatchedDecoder(8, FLAGS, mesh=object()),
                 lambda: BatchedEncoder(8, 48000, 192000, 2,
                                        mesh=object()),
                 lambda: PT.Transcoder(8, 192000, 2, mesh=object()),
                 lambda: PT.transcode_pipeline(
                     fmt, make_config(48000, 192000, 2), object()),
                 lambda: S.load_decode_state("unused.npz", mesh=object())):
        with pytest.raises(TypeError, match="Mesh"):
            call()
    with pytest.raises(ValueError, match="not both"):
        BatchedDecoder(8, FLAGS, mesh=mesh, device="cpu")


def test_init_batched_carry_slots():
    """init_batched_carry keeps JAX's (batch, mesh) slots: a mesh given
    by position lands in the mesh slot, and device is a keyword."""
    mesh = _cpu_mesh(4)
    delay, downmixed = init_batched_carry(8, mesh)
    assert isinstance(delay, Sharded) and delay.mesh == mesh
    assert [tuple(p.shape) for p in delay.parts] == [(2, 6, 128)] * 4
    assert tuple(downmixed.shape) == (8,) and bool(np.asarray(downmixed)
                                                   .all())
    delay, _ = init_batched_carry(8, device="cpu")
    assert isinstance(delay, torch.Tensor) and delay.device.type == "cpu"
    with pytest.raises(ValueError, match="not both"):
        init_batched_carry(8, mesh, "cpu")


# -- batched_pipeline, raw_batched_pipeline, tp_filterbank -------------------

def test_batched_pipeline_mesh_reference(golden):
    """batched_pipeline(mesh) over a 4x2 mesh in reference mode: PCM and
    carry equal JAX's mesh call by value and the port's one-device call
    bitwise; the returned carry feeds the next call without moving."""
    jfmt, fmt, blocks, delay = golden
    assert PD.default_exact() and JD.default_exact()
    jmesh = JM.make_mesh(data=4, model=2)
    jcarry = (jnp.asarray(delay), jnp.ones((16,), bool))
    jc, jpcm = JP.batched_pipeline(jfmt, mesh=jmesh)(
        _jax_put(jmesh, jcarry), _jax_put(jmesh, blocks))
    carry = (torch.from_numpy(delay), torch.ones(16, dtype=torch.bool))
    lc, lpcm = batched_pipeline(fmt)(carry, _tensors(blocks))
    mesh = _cpu_mesh(4, 2)
    mc, mpcm = batched_pipeline(fmt, mesh)(carry, _tensors(blocks))
    assert isinstance(mpcm, Sharded) and len(mpcm.parts) == 4
    _same_bits(mpcm, lpcm, "pcm vs one device")
    for a, b in zip(mc, lc):
        _same_bits(a, b, "carry vs one device")
    np.testing.assert_array_equal(np.asarray(mpcm), np.asarray(jpcm))
    for a, b in zip(mc, jc):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    # the sharded carry goes back in as it is
    mc2, mpcm2 = batched_pipeline(fmt, mesh)(mc, _tensors(blocks))
    lc2, lpcm2 = batched_pipeline(fmt)(lc, _tensors(blocks))
    _same_bits(mpcm2, lpcm2, "second chunk")
    assert all(p.data_ptr() == q.data_ptr()
               for p, q in zip(stream_sharding(mesh).put(mc)[0].parts,
                               mc[0].parts))


@pytest.mark.parametrize("body", ["scan", "fused"])
def test_batched_pipeline_mesh_fast(fast, golden, monkeypatch, body):
    """Fast mode, int16: the block scan (torch.matmul) and the fused steady
    kernel's path (K1: its plain version on the CPU, once per shard) on a
    mesh within 1 LSB of the one-device call (the fast contract)."""
    _, fmt, blocks, delay = golden
    calls = []
    orig = PP.fused_steady
    monkeypatch.setattr(PP, "fused_steady",
                        lambda *a: calls.append(a[0].shape) or orig(*a))
    kw = dict(emit_int16=True)
    if body == "fused":
        assert not blocks["blksw"].any()
        blocks = {k: v for k, v in PD.premix_blocks(fmt, blocks).items()
                  if k in ("freq", "blksw", "bias")}
        kw.update(steady=True, long_only=True, premixed=True)
    carry = (torch.from_numpy(delay), torch.ones(16, dtype=torch.bool))
    _, lpcm = batched_pipeline(fmt, **kw)(carry, _tensors(blocks))
    mesh = _cpu_mesh(4, 2)
    _, mpcm = batched_pipeline(fmt, mesh, **kw)(carry, _tensors(blocks))
    assert mpcm.dtype == torch.int16
    err = np.abs(np.asarray(mpcm).astype(np.int32)
                 - lpcm.numpy().astype(np.int32)).max()
    assert err <= 1, err
    if body == "fused":                  # one call a chunk, then one a shard
        assert [tuple(s)[0] for s in calls] == [16, 4, 4, 4, 4]
    else:
        assert not calls


def test_raw_batched_pipeline_mesh(monkeypatch):
    """raw_batched_pipeline(mesh) equals the one-device raw call bitwise
    (PCM, the unpack carry and the OLA carry), reference mode; each shard
    takes the one-device call's kernels (the bitfield gathers, B1F)."""
    dec = BatchedDecoder(8, FLAGS, bias=384.0, emit_int16=True,
                         parser="raw", device="cpu")
    es = _es()
    for i in range(8):
        dec.feed(i, es[i * FRAME:] + es[:i * FRAME])
    fmt, fu8, meta, ok = dec._raw_chunk(4)
    assert ok.all()
    meta = prune_raw_meta(meta)
    plan = dec._raw_plan(fmt, meta)
    args = (torch.from_numpy(fu8), _tensors(meta),
            torch.full((8, 24), 384.0))
    counts = {"B1F": 0, "K2": 0}

    def counted(name, fn):
        def call(*a, **kw):
            counts[name] += 1
            return fn(*a, **kw)
        return call

    monkeypatch.setattr(PP, "fused_steady_exact",
                        counted("B1F", PP.fused_steady_exact))
    monkeypatch.setattr(BG, "extract_fields",
                        counted("K2", BG.extract_fields))
    carry = (init_unpack_carry(8, "cpu"), init_batched_carry(8,
                                                             device="cpu"))
    (lu, ld), lpcm = raw_batched_pipeline(fmt, None, True, **plan)(
        carry, *args)
    one = dict(counts)
    mesh = _cpu_mesh(4)
    (mu, md), mpcm = raw_batched_pipeline(fmt, mesh, True, **plan)(
        carry, *args)
    assert one["B1F"] == 1 and counts["B1F"] == 5
    assert counts["K2"] == 5 * one["K2"]
    _same_bits(mpcm, lpcm, "pcm")
    for k in lu:
        _same_bits(mu[k], lu[k], k)
    for a, b in zip(md, ld):
        _same_bits(a, b, "delay carry")
    with pytest.raises(ValueError, match="StageClock"):
        raw_batched_pipeline(fmt, mesh, True, **plan)(
            carry, *args, clock=object())


@pytest.mark.parametrize("data,model", [(4, 2), (2, 4)])
def test_tp_filterbank(data, model):
    """tp_filterbank on a data x model mesh: the contraction split over
    'model' and summed in model order, within 8 ulp at full scale of JAX's
    tp_filterbank on the same mesh and of the one-device filterbank."""
    rng = np.random.default_rng(3)
    B, C = 8, 4
    coeffs = rng.standard_normal((B, C, 256)).astype(np.float32) * 1e-3
    delay = rng.standard_normal((B, C, 128)).astype(np.float32) * 1e-3
    blksw = rng.random((B, C)) < 0.3
    bias = np.full((B, C), 384.0, np.float32)
    jmesh = JM.make_mesh(data=data, model=model)
    jout = jax.jit(lambda c, d, b, bi: JP.tp_filterbank(jmesh, c, d, b, bi))(
        coeffs, delay, blksw, bias)
    t = _tensors((coeffs, delay, blksw, bias))
    local = filterbank(*t)
    got = tp_filterbank(_cpu_mesh(data, model), *t)
    assert all(isinstance(g, Sharded) and len(g.parts) == data for g in got)
    for g, j, loc in zip(got, jout, local):
        g = np.asarray(g)
        for ref in (np.asarray(j), loc.numpy()):
            tol = 8 * np.spacing(np.float32(np.abs(ref).max()))
            assert np.abs(g - ref).max() <= tol
    # the JAX package's own local filterbank agrees too
    jl = jax_filterbank(*(jnp.asarray(a) for a in (coeffs, delay, blksw,
                                                   bias)))
    np.testing.assert_allclose(local[0].numpy(), np.asarray(jl[0]),
                               rtol=0, atol=8 * np.spacing(np.float32(384)))


# -- BatchedDecoder ----------------------------------------------------------

@pytest.fixture(scope="module")
def jax_mesh_decode():
    """JAX's BatchedDecoder on an 8-way data mesh, reference mode, bias
    384: per JAX parser, the float PCM of 4 frames of 8 rotated golden
    lanes."""
    es = _es()
    out = {}

    def run(parser):
        if parser not in out:
            d = JP.BatchedDecoder(8, FLAGS, bias=384.0,
                                  mesh=JM.make_mesh(data=8, model=1),
                                  parser=parser,
                                  **({"nthreads": 1} if parser == "native"
                                     else {}))
            for i in range(8):
                d.feed(i, es[i * FRAME:] + es[:i * FRAME])
            pcm, valid = d.decode_available(max_frames=4)
            assert valid.all()
            out[parser] = np.asarray(pcm)
        return out[parser]

    return run


@pytest.mark.parametrize("parser", ["native", "raw", "python", "raw_py"])
def test_batched_decoder_mesh(jax_mesh_decode, parser, tmp_path):
    """BatchedDecoder(8, ..., bias=384.0, mesh=make_mesh(data=8)) with
    each parser: PCM bitwise the one-device decoder's over two steps (the
    sharded carry crossing them), and within 1 ulp at 384 of JAX's mesh
    decoder (for the raw parsers, JAX's native one: see the module
    docstring).  The sharded carry saves like the one-device carry and
    loads back onto the mesh."""
    es = _es()
    mesh = _cpu_mesh(8)
    decs = [BatchedDecoder(8, FLAGS, bias=384.0, mesh=mesh, parser=parser),
            BatchedDecoder(8, FLAGS, bias=384.0, parser=parser,
                           device="cpu")]
    for d in decs:
        for i in range(8):
            d.feed(i, es[i * FRAME:] + es[:i * FRAME])
    outs = []
    for d in decs:
        chunks = []
        for _ in range(2):
            pcm, valid = d.decode_available(max_frames=2)
            assert valid.all()
            chunks.append(np.asarray(pcm))
        outs.append(np.concatenate(chunks, axis=1))
    assert isinstance(decs[0]._carry[0], Sharded)
    _same_bits(outs[0], outs[1], parser)
    ref = jax_mesh_decode("python" if parser == "python" else "native")
    assert np.abs(outs[0] - ref).max() <= np.spacing(np.float32(384.0))
    # (g) the mesh carry through utils.state
    for d, name in zip(decs, ("mesh", "local")):
        S.save_decode_state(str(tmp_path / name), d._carry)
    with np.load(tmp_path / "mesh.npz") as zm, \
            np.load(tmp_path / "local.npz") as zl:
        for k in ("delay", "downmixed"):
            _same_bits(zm[k], zl[k], k)
    back = S.load_decode_state(str(tmp_path / "mesh.npz"), mesh=mesh)
    assert all(isinstance(x, Sharded) and x.mesh == mesh for x in back)
    for a, b in zip(back, decs[0]._carry):
        _same_bits(a, b, "reloaded carry")


def test_batched_decoder_mesh_mixed_formats():
    """A mixed-format batch (5.1 and 2.0 lanes) on a mesh equals the same
    batch without one; each format's bucket (4 lanes) is padded to a
    multiple of the mesh's 8 devices."""
    mesh = _cpu_mesh(8)
    feeds = [_es() if i % 2 else _es("stereo_192.ac3") for i in range(8)]
    outs = []
    for kw in (dict(mesh=mesh), dict(device="cpu")):
        d = BatchedDecoder(8, FLAGS, bias=384.0, emit_int16=True, **kw)
        for i, f in enumerate(feeds):
            d.feed(i, f)
        pcm, valid = d.decode_available(max_frames=3)
        assert valid.all()
        outs.append((np.asarray(pcm), np.asarray(d._carry[0])))
        if "mesh" in kw:
            assert isinstance(pcm, Sharded) and d._bucket_size(4) == 8
            assert d._bucket_size(9) == 16
    for a, b in zip(*outs):
        _same_bits(a, b, "mixed")


# -- encoder and transcode ---------------------------------------------------

def test_batched_encoder_mesh():
    """BatchedEncoder(mesh=...) frames byte-identical to the one-device
    encoder's, with the device packer and the native one, over two calls
    (the sharded carry crossing them), and to JAX's mesh encoder (2.0,
    192 kbit/s)."""
    pcm = CS.mixed_pcm(2, 2, 11, lanes=8)
    mesh = _cpu_mesh(4, 2)
    outs = {}
    for pack in ("device", "native"):
        for tag, kw in (("mesh", dict(mesh=mesh)), ("local",
                                                    dict(device="cpu"))):
            enc = BatchedEncoder(8, 48000, 192000, 2, pack=pack, **kw)
            a = enc.encode_frames(pcm[:, :1536])
            b = enc.encode_step(pcm[:, 1536:])
            outs[pack, tag] = [x + y for x, y in zip(a, b)]
            if tag == "mesh":
                assert isinstance(enc.last, Sharded)
    assert len(set(map(tuple, outs.values()))) == 1
    jenc = JaxEncoder(8, 48000, 192000, 2,
                      mesh=JM.make_mesh(data=4, model=2))
    ref = [x + y for x, y in zip(jenc.encode_step(pcm[:, :1536]),
                                 jenc.encode_step(pcm[:, 1536:]))]
    assert outs["device", "mesh"] == ref


@pytest.fixture(scope="module")
def tc_inputs():
    """One golden frame per lane (lane i: frame i) as the transcode's
    block tensors, and its formats and encoder configs."""
    blocks, meta = JaxNativeParser().decode_frames(_es(), 8, FLAGS, 1.0,
                                                   384.0)
    spec = (meta["acmod"], meta["output"], meta["slev"] == 0.0,
            meta["chanbias"])
    blocks = {k: np.ascontiguousarray(v.reshape((8, 6) + v.shape[1:]))
              for k, v in blocks.items()}
    return (JD.StreamFormat(*spec), PD.StreamFormat(*spec), blocks,
            jax_make_config(48000, 192000, 2), make_config(48000, 192000, 2))


def _port_tc(fmt, cfg, blocks, mesh):
    carry = (torch.zeros(8, 6, 128), torch.ones(8, dtype=torch.bool))
    return PT.transcode_pipeline(fmt, cfg, mesh)(
        carry, _tensors(blocks), torch.zeros(8, 2, 256, dtype=torch.int32),
        torch.full((8,), 40, dtype=torch.int32))


def test_transcode_pipeline_mesh(tc_inputs):
    """transcode_pipeline(fmt, cfg, mesh) in reference mode equals the
    one-device call bitwise: the carry, every encoder field (bap,
    strategies, exponents, SNR offsets, mantissas) and the int16 PCM; the
    function is cached per mesh."""
    _, fmt, blocks, _, cfg = tc_inputs
    mesh = _cpu_mesh(8)
    (ld, lm), lenc, li16 = _port_tc(fmt, cfg, blocks, None)
    (md, mm), menc, mi16 = _port_tc(fmt, cfg, blocks, mesh)
    assert isinstance(mi16, Sharded) and len(mi16.parts) == 8
    _same_bits(mi16, li16, "i16")
    _same_bits(md, ld, "delay")
    _same_bits(mm, lm, "downmixed")
    assert menc.keys() == lenc.keys()
    for k in lenc:
        _same_bits(menc[k], lenc[k], k)
    assert PT.transcode_pipeline(fmt, cfg, mesh) is \
        PT.transcode_pipeline(fmt, cfg, _cpu_mesh(8))
    assert PT.transcode_pipeline(fmt, cfg, mesh) is not \
        PT.transcode_pipeline(fmt, cfg, _cpu_mesh(4))


def test_transcode_pipeline_mesh_matches_jax(fast, tc_inputs):
    """transcode_pipeline on an 8-way mesh against JAX's, in fast mode
    (JAX's exact transform cannot run here through the callback, see the
    module docstring): every field bitwise but the PCM-derived i16, qmant
    and new_last, which tests/test_mesh.py holds to 1 LSB (XLA:CPU blocks
    the f32 filterbank product differently at each shape)."""
    jfmt, fmt, blocks, jcfg, cfg = tc_inputs
    jmesh = JM.make_mesh(data=8, model=1)
    jcarry = (jnp.zeros((8, 6, 128), jnp.float32), jnp.ones((8,), bool))
    # JAX's cache keys on (fmt, cfg, mesh) and reads the accuracy mode
    # when it traces: empty it around a fast-mode trace
    JTC.transcode_pipeline.cache_clear()
    try:
        _, jenc, ji16 = JTC.transcode_pipeline(jfmt, jcfg, jmesh)(
            _jax_put(jmesh, jcarry), _jax_put(jmesh, blocks),
            _jax_put(jmesh, jnp.zeros((8, 2, 256), jnp.int32)),
            _jax_put(jmesh, jnp.full((8,), 40, jnp.int32)))
    finally:
        JTC.transcode_pipeline.cache_clear()
    _, menc, mi16 = _port_tc(fmt, cfg, blocks, _cpu_mesh(8))

    def lsb1(a, b, name):
        d = np.abs(np.asarray(a, np.int64) - np.asarray(b, np.int64))
        assert d.max() <= 1, (name, d.max())

    lsb1(mi16, ji16, "i16")
    for k in jenc:
        if k in ("qmant", "new_last"):
            lsb1(menc[k], jenc[k], k)
        else:
            np.testing.assert_array_equal(np.asarray(menc[k]),
                                          np.asarray(jenc[k]), err_msg=k)


def test_transcoder_mesh():
    """Transcoder(mesh=...) bytes equal the one-device Transcoder's, native
    and raw parsers, device and native packers, over two chunks."""
    chunks = CS.tc_chunks(8)
    mesh = _cpu_mesh(4)
    for kw in (dict(), dict(parser="raw", pack="native")):
        outs = [CS.transcode_run(PT.Transcoder(8, 192000, 2, **dict(kw, **m)),
                                 chunks)
                for m in (dict(mesh=mesh), dict(device="cpu"))]
        assert outs[0] == outs[1], kw
