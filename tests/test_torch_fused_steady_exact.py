"""Port: the fused order-exact steady tail (ops.fused_steady_exact, B1F).

On CPU tensors the wrapper runs its plain version; these tests hold that
function, and the reference-mode dispatch that sends steady premixed
chunks to it, to the JAX package's exact steady body followed by
convert_to_int16, BY VALUE (np.array_equal: JAX's CPU guard against FMA
contraction turns -0.0 products into +0.0, see
tests/test_torch_imdct_exact.py, whose fixtures route JAX's exact split
through one compiled callback).  The kernel itself runs only on the card:
chip_smoke.py holds it to the plain version there.

Premixed planes of a 5.1 stream with a carry whose ``downmixed`` is true
make the JAX body's entry fixup the identity, so the kernel's d0 is the
carry's planes and the only difference is the LFE plane's place (JAX emits
it first, the kernel's planes keep it last).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ac3acm_tpu.tables as JT
from ac3acm_tpu.models import decoder as JD
from ac3acm_tpu.ops import filterbank as JF
from ac3acm_tpu_torch.models import decoder as PD
from ac3acm_tpu_torch.ops import fused_steady_exact as FE
from ac3acm_tpu_torch.ops.filterbank import convert_to_int16
from ac3acm_tpu_torch.ops.imdct_exact import split_fb_exact_ref
from ac3acm_tpu_torch.parallel import pipeline as PP
from tests.test_torch_decoder import _steady_blocks
from tests.test_torch_imdct_exact import (  # noqa: F401  (fixtures)
    _same, jax_exact_callback, jax_split)

# premixable formats: P = nf_out (+ LFE, last)
FORMATS = {
    "5.1to1.0": (JT.A52_3F2R, JT.A52_MONO, False, 0),                  # P=1
    "5.1to2.0": (JT.A52_3F2R, JT.A52_STEREO, False, 0),                # P=2
    "5.1to2.0+LFE": (JT.A52_3F2R, JT.A52_STEREO | JT.A52_LFE, False, 0),
    "2.0pass": (JT.A52_STEREO, JT.A52_STEREO, True, 0),   # per-plane blksw
}
OUT_DTYPES = {"int16": torch.int16, "f32": torch.float32}


def _chunk(fmt, long_only, rng, B=3, n=7, premixed=True):
    """A steady chunk with a bias that varies per block and rows loud
    enough to clip at both int16 ends."""
    blocks = _steady_blocks(fmt, premixed, long_only, rng, B=B, n=n)
    if not premixed:
        # planes the stream does not code are zero, as a parser emits them
        blocks["freq"][:, :, fmt.nfchans:] = 0.0
    blocks["freq"][:, 1::3] *= np.float32(60.0)
    blocks["bias"] = (384.0 + (rng.random((B, n)) - 0.5) * 0.02
                      ).astype(np.float32)
    assert PD.steady_ok(fmt, blocks)
    return blocks


def _jax_steady(jfmt, delay, downmixed, blocks, long_only, premixed):
    body = lambda c, b: JD._pipeline_steady(jfmt, c, b, long_only=long_only,
                                            premixed=premixed, exact=True)
    (jd, jm), jp = jax.jit(jax.vmap(body))(
        (jnp.asarray(delay), jnp.asarray(downmixed)), blocks)
    return np.asarray(jd), np.asarray(jm), jp


def _plane_blksw(fmt, blksw):
    """The blksw each premixed plane takes: the freq path's planes share
    the first channel's flag, passthrough planes keep their own, LFE is
    long."""
    nfo = fmt.nf_out
    blk = blksw[:, :, :nfo] if fmt.nf_out == fmt.nfchans else \
        np.repeat(blksw[:, :, :1], nfo, axis=2)
    if fmt.lfe_out:
        blk = np.concatenate([blk, np.zeros_like(blk[:, :, :1])], axis=2)
    return np.ascontiguousarray(blk)


@pytest.mark.parametrize("out", list(OUT_DTYPES))
@pytest.mark.parametrize("long_only", [True, False])
@pytest.mark.parametrize("name", list(FORMATS))
def test_fused_steady_exact_matches_jax(jax_exact_callback, name, long_only,
                                        out):
    spec = FORMATS[name]
    jfmt, fmt = JD.StreamFormat(*spec), PD.StreamFormat(*spec)
    rng = np.random.default_rng(51)
    B, n = 3, 7
    blocks = _chunk(fmt, long_only, rng, B, n)
    delay = (rng.standard_normal((B, 6, 128)) * 0.05).astype(np.float32)
    jd, _, jp = _jax_steady(jfmt, delay, np.ones(B, bool), blocks,
                            long_only, premixed=True)
    nfo = fmt.nf_out
    planes = list(range(nfo)) + ([5] if fmt.lfe_out else [])
    blk = None if long_only else torch.from_numpy(
        _plane_blksw(fmt, blocks["blksw"]))
    before = FE.launches
    pcm, dlast = FE.fused_steady_exact(
        torch.from_numpy(blocks["freq"]), blk,
        torch.from_numpy(np.ascontiguousarray(delay[:, planes])),
        torch.from_numpy(blocks["bias"]), OUT_DTYPES[out])
    assert FE.launches == before, "CPU tensors must not launch the kernel"
    assert pcm.dtype == OUT_DTYPES[out] and pcm.shape == (B, n, len(planes),
                                                          256)
    if fmt.lfe_out:                                 # JAX emits LFE first
        pcm = torch.cat([pcm[:, :, nfo:], pcm[:, :, :nfo]], dim=2)
    want = JF.convert_to_int16(jp) if out == "int16" else jp
    _same(pcm.numpy(), np.asarray(want), "pcm")
    if out == "int16":
        p = pcm.numpy()
        assert p.min() == -32768 and p.max() == 32767, "no row clipped"
    _same(dlast.numpy(), jd[:, planes], "dlast")


@pytest.mark.parametrize("long_only", [True, False])
def test_plain_version_is_the_eager_tail(long_only):
    """fused_steady_exact_ref is bit for bit split_fb_exact_ref, the delay
    chain, the body's eager OLA and convert_to_int16."""
    rng = np.random.default_rng(5)
    B, n, P = 2, 5, 3
    freq = torch.from_numpy((rng.standard_normal((B, n, P, 256)) * 0.3)
                            .astype(np.float32))
    blk = None if long_only else torch.from_numpy(rng.random((B, n, P)) < 0.5)
    d0 = torch.from_numpy((rng.standard_normal((B, P, 128)) * 0.1)
                          .astype(np.float32))
    bias = torch.from_numpy((384.0 + rng.standard_normal((B, n)))
                            .astype(np.float32))
    _, ola = PD._filterbank_ops(freq.device, True)
    z, d = split_fb_exact_ref(freq, blk)
    dchain = torch.cat([d0[:, None], d[:, :-1]], dim=1)
    out = ola(z, dchain, bias[:, :, None, None])
    for dtype, want in ((torch.float32, out),
                        (torch.int16, convert_to_int16(out))):
        pcm, dlast = FE.fused_steady_exact_ref(freq, blk, d0, bias, dtype)
        assert torch.equal(pcm.view(torch.int16 if dtype == torch.int16
                                    else torch.int32),
                           want.view(torch.int16 if dtype == torch.int16
                                     else torch.int32))
        assert torch.equal(dlast.view(torch.int32), d[:, -1].view(torch.int32))


@pytest.fixture
def count_b1f(monkeypatch):
    """Counts the pipeline's calls of fused_steady_exact (on the CPU the
    wrapper's launch counter stays put)."""
    calls = []

    def counted(*args, **kw):
        calls.append(args[0].shape)
        return FE.fused_steady_exact(*args, **kw)

    monkeypatch.setattr(PP, "fused_steady_exact", counted)
    return calls


@pytest.mark.parametrize("emit_int16", [True, False])
@pytest.mark.parametrize("long_only", [True, False])
@pytest.mark.parametrize("name", ["5.1to2.0+LFE", "2.0pass"])
def test_reference_dispatch_matches_jax(jax_exact_callback, count_b1f, name,
                                        long_only, emit_int16):
    """batched_pipeline in reference mode (the default) sends a steady
    premixed chunk through B1F, and its output equals the JAX exact steady
    body's by value, carry included, in both entry-fixup branches
    (downmixed true and false per lane): on host-premixed planes (the
    native form) and on full planes premixed on the device (the raw
    path's form); fused=False keeps the plain body, with the same output."""
    assert PD.default_exact()
    spec = FORMATS[name]
    jfmt, fmt = JD.StreamFormat(*spec), PD.StreamFormat(*spec)
    rng = np.random.default_rng(61)
    B, n = 3, 6
    full = _chunk(fmt, long_only, rng, B, n, premixed=False)
    delay = (rng.standard_normal((B, 6, 128)) * 0.05).astype(np.float32)
    downmixed = np.array([True, False, True])
    jd, jm, jp = _jax_steady(jfmt, delay, downmixed, full, long_only,
                             premixed=False)
    want = np.asarray(JF.convert_to_int16(jp) if emit_int16 else jp)
    carry = (torch.from_numpy(delay), torch.from_numpy(downmixed))
    dev_full = {k: torch.from_numpy(v) for k, v in full.items()}
    host = {k: torch.from_numpy(v)
            for k, v in PD.premix_blocks(fmt, full).items()}
    forms = {"native": host,
             "device premix": PD.premix_blocks_device(fmt, dev_full)}
    for form, blocks in forms.items():
        for fused, calls in ((None, 1), (False, 0)):
            before = len(count_b1f)
            fn = PP.batched_pipeline(fmt, emit_int16=emit_int16, steady=True,
                                     long_only=long_only, premixed=True,
                                     fused=fused)
            (md, mm), mp = fn(carry, blocks)
            assert len(count_b1f) - before == calls, (form, fused)
            what = f"{name} {form} fused={fused}"
            _same(mp.numpy(), want, what + " pcm")
            _same(md.numpy(), jd, what + " delay")
            np.testing.assert_array_equal(mm.numpy(), jm)


def test_positional_none_slots_are_reference_mode(jax_exact_callback,
                                                  count_b1f):
    """A JAX-style positional call (fmt, mesh, emit_int16, steady,
    long_only, premixed, pallas=None, exact=None) is reference mode in both
    packages (the default ACCURACY): B1F once, PCM and carry equal to
    JAX's same call by value."""
    from ac3acm_tpu.parallel import pipeline as JP
    assert PD.default_exact() and JD.default_exact()
    spec = FORMATS["5.1to2.0+LFE"]
    jfmt, fmt = JD.StreamFormat(*spec), PD.StreamFormat(*spec)
    rng = np.random.default_rng(71)
    B, n = 3, 6
    blocks = _chunk(fmt, True, rng, B, n)
    delay = (rng.standard_normal((B, 6, 128)) * 0.05).astype(np.float32)
    downmixed = np.array([True, False, True])
    JP._pipeline_cached.cache_clear()     # built with the routed split
    (jd, jm), jp = JP.batched_pipeline(jfmt, None, True, True, True, True,
                                       None, None)(
        (jnp.asarray(delay), jnp.asarray(downmixed)), blocks)
    JP._pipeline_cached.cache_clear()
    (md, mm), mp = PP.batched_pipeline(fmt, None, True, True, True, True,
                                       None, None)(
        (torch.from_numpy(delay), torch.from_numpy(downmixed)),
        {k: torch.from_numpy(v) for k, v in blocks.items()})
    assert len(count_b1f) == 1
    _same(mp.numpy(), np.asarray(jp), "pcm")
    _same(md.numpy(), np.asarray(jd), "delay")
    np.testing.assert_array_equal(mm.numpy(), np.asarray(jm))


@pytest.mark.parametrize("name", ["5.1to2.0", "5.1to2.0+LFE", "2.0pass",
                                  "5.1pass+LFE"])
def test_premix_blocks_device_matches_host_and_jax(name):
    """The ported premix_blocks_device equals the port's host premix_blocks
    and the JAX package's premix_blocks_device bitwise."""
    spec = dict(FORMATS, **{"5.1pass+LFE": (JT.A52_3F2R,
                                            JT.A52_3F2R | JT.A52_LFE,
                                            False, 0)})[name]
    jfmt, fmt = JD.StreamFormat(*spec), PD.StreamFormat(*spec)
    rng = np.random.default_rng(71)
    full = _steady_blocks(fmt, False, False, rng, B=2, n=4)
    full["freq"][0, 0, :, :9] = -0.0
    mine = PD.premix_blocks_device(
        fmt, {k: torch.from_numpy(v) for k, v in full.items()})
    host = PD.premix_blocks(fmt, full)
    ref = JD.premix_blocks_device(jfmt, {k: jnp.asarray(v)
                                         for k, v in full.items()})
    assert "remat" not in mine and mine["freq"].shape == (2, 4, fmt.nch_out,
                                                          256)
    for other in (host["freq"], np.asarray(ref["freq"])):
        np.testing.assert_array_equal(mine["freq"].numpy().view(np.uint32),
                                      np.asarray(other).view(np.uint32))


def test_wrapper_refuses_bad_inputs():
    B, n, P = 2, 3, 2
    freq = torch.zeros(B, n, P, 256)
    d0, bias = torch.zeros(B, P, 128), torch.zeros(B, n)
    blk = torch.zeros(B, n, P, dtype=torch.bool)
    ok = FE.fused_steady_exact(freq, blk, d0, bias)
    assert ok[0].dtype == torch.int16
    buf = torch.zeros(B * n * P * 256 + 1)
    bad = [
        (TypeError, (freq.double(), blk, d0, bias)),
        (ValueError, (torch.zeros(B, n, P, 255), blk, d0, bias)),
        (ValueError, (torch.zeros(n, P, 256), None, d0, bias)),
        (ValueError, (freq.transpose(0, 1).contiguous().transpose(0, 1),
                      blk, d0, bias)),                    # not contiguous
        (ValueError, (buf[1:].view(B, n, P, 256), blk, d0,
                      bias)),                            # misaligned
        (ValueError, (freq, torch.zeros(B, n, P + 1, dtype=torch.bool), d0,
                      bias)),
        (ValueError, (freq, torch.zeros(B, n, dtype=torch.bool), d0, bias)),
        (TypeError, (freq, blk.to(torch.uint8), d0, bias)),
        (ValueError, (freq, blk, torch.zeros(B, P, 127), bias)),
        (TypeError, (freq, blk, d0.double(), bias)),
        (ValueError, (freq, blk, d0, torch.zeros(B, n + 1))),
        (ValueError, (torch.zeros(B, 0, P, 256), None, d0,
                      torch.zeros(B, 0))),
        (ValueError, (freq, blk, d0.to("meta"), bias)),       # other device
        (ValueError, (freq.to("meta"), None, d0.to("meta"),
                      bias.to("meta"))),                    # not cuda or cpu
    ]
    before = FE.launches
    for err, args in bad:
        with pytest.raises(err):
            FE.fused_steady_exact(*args)
    with pytest.raises(TypeError):
        FE.fused_steady_exact(freq, blk, d0, bias, torch.int32)
    assert FE.launches == before
