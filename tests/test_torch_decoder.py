"""Port: tables, mixers, int16 conversion and the steady decode body vs JAX.

Inputs are made with numpy from a seed and handed to both packages.
Bitwise where the JAX package is bitwise (tables, constants, mixers,
int16 conversion); the steady body's FP32 products are held to 2e-6
absolute, the matmul reassociation bound of tests/test_batched_decoder.py.
"""
import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ac3acm_tpu.tables as JT
import ac3acm_tpu_torch.tables as PT
from ac3acm_tpu.models import decoder as JD
from ac3acm_tpu.ops import downmix as JM
from ac3acm_tpu.ops import filterbank as JF
from ac3acm_tpu.parallel.pipeline import batched_pipeline as jax_pipeline
from ac3acm_tpu_torch.models import decoder as PD
from ac3acm_tpu_torch.ops import downmix as PM
from ac3acm_tpu_torch.ops import filterbank as PF
from ac3acm_tpu_torch.parallel.pipeline import batched_pipeline

FP32_ATOL = 2e-6


def _bitwise(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape and a.dtype == b.dtype, (a.shape, b.shape,
                                                       a.dtype, b.dtype)
    np.testing.assert_array_equal(a.view(np.uint8), b.view(np.uint8))


def test_mats_bitwise():
    for mine, ref in zip(PF._mats(), JF._mats()):
        _bitwise(mine, ref)


def test_public_tables_bitwise():
    """Every public constant and generator of the port's tables copy equals
    the JAX package's."""
    names = [n for n in dir(JT) if not n.startswith("_")]
    checked = 0
    for name in names:
        ref = getattr(JT, name)
        mine = getattr(PT, name)
        if callable(ref) and name in ("dither_lut", "lfsr_cycle", "kbd_window",
                                      "enc_window_int16", "imdct512_matrices",
                                      "imdct256_matrices", "imdct_twiddles",
                                      "imdct_twiddles_f64", "bap_plain_bits"):
            ref, mine = ref(), mine()
        if isinstance(ref, tuple):
            for r, m in zip(ref, mine):
                _bitwise(m, r)
        elif isinstance(ref, np.ndarray):
            _bitwise(mine, ref)
        elif isinstance(ref, dict):
            assert mine.keys() == ref.keys(), name
            for key in ref:
                if isinstance(ref[key], np.ndarray):
                    _bitwise(mine[key], ref[key])
                else:
                    assert mine[key] == ref[key], (name, key)
        elif isinstance(ref, (int, float)):
            assert mine == ref, name
        else:
            continue
        checked += 1
    assert checked >= 40


@pytest.mark.parametrize("acmod", range(8))
def test_downmix_upmix_bitwise(acmod):
    """downmix / upmix equal the JAX mixers bitwise for every output mode
    and slev_zero, including -0.0 inputs and a nonzero bias."""
    rng = np.random.default_rng(acmod)
    planes = (rng.standard_normal((5, 3, 256)) * 0.3).astype(np.float32)
    planes[:, 0, :8] = -0.0
    bias = np.float32(rng.standard_normal())
    for output, slev_zero in itertools.product(range(11), (False, True)):
        for b in (np.float32(0.0), bias):
            ref = JM.downmix(jnp.asarray(planes), acmod, output,
                             jnp.asarray(b), slev_zero=slev_zero)
            mine = PM.downmix(torch.from_numpy(planes), acmod, output,
                              torch.tensor(b), slev_zero=slev_zero)
            _bitwise(mine.numpy(), np.asarray(ref))
        ref = JM.upmix(jnp.asarray(planes), acmod, output)
        mine = PM.upmix(torch.from_numpy(planes), acmod, output)
        _bitwise(mine.numpy(), np.asarray(ref))


def test_premix_blocks_bitwise():
    rng = np.random.default_rng(5)
    blocks = {"freq": (rng.standard_normal((3, 12, 6, 256)) * 0.1
                       ).astype(np.float32),
              "remat": rng.random((3, 12, 256)) < 0.5,
              "blksw": np.zeros((3, 12, 5), bool),
              "bias": np.zeros((3, 12), np.float32)}
    for spec in ((JT.A52_3F2R, JT.A52_STEREO | JT.A52_LFE, False, 0),
                 (JT.A52_STEREO, JT.A52_STEREO, True, 0),
                 (JT.A52_3F1R, JT.A52_MONO, True, 0)):
        _bitwise(PD.premix_blocks(PD.StreamFormat(*spec), blocks)["freq"],
                 JD.premix_blocks(JD.StreamFormat(*spec), blocks)["freq"])


def test_convert_to_int16_bitwise():
    """Round-half-to-even on exact +-0.5 LSB ties, and the clip edges."""
    k = np.arange(-70000, 70001, dtype=np.float64)
    ties = (k / 65536.0).astype(np.float32)        # x * 32768 = k / 2
    edges = np.array([1.0, -1.0, 0.99997, -0.99997, 1.5, -1.5, 1e6, -1e6,
                      32767.5 / 32768, -32768.5 / 32768], np.float32)
    for bias, x in ((0.0, np.concatenate([ties, edges])),
                    (384.0, (384.0 + np.random.default_rng(0)
                             .standard_normal(4096) * 0.4).astype(np.float32))):
        ref = JF.convert_to_int16(jnp.asarray(x), bias)
        mine = PF.convert_to_int16(torch.from_numpy(x), bias)
        _bitwise(mine.numpy(), np.asarray(ref))


def test_filterbank_matches_jax():
    rng = np.random.default_rng(9)
    coeffs = (rng.standard_normal((4, 5, 256)) * 0.03).astype(np.float32)
    delay = (rng.standard_normal((4, 5, 128)) * 0.03).astype(np.float32)
    blksw = rng.random((4, 5)) < 0.5
    bias = np.zeros((4, 5), np.float32)
    ro, rd = JF.filterbank(jnp.asarray(coeffs), jnp.asarray(delay),
                           jnp.asarray(blksw), jnp.asarray(bias))
    mo, md = PF.filterbank(torch.from_numpy(coeffs), torch.from_numpy(delay),
                           torch.from_numpy(blksw), torch.from_numpy(bias))
    np.testing.assert_allclose(mo.numpy(), np.asarray(ro), rtol=0,
                               atol=FP32_ATOL)
    np.testing.assert_allclose(md.numpy(), np.asarray(rd), rtol=0,
                               atol=FP32_ATOL)


# (acmod, output, slev_zero, chanbias), premixed: the four branches of
# _pipeline_steady (LFE, reducing, premixed passthrough, time path)
BRANCHES = {
    "reduce": ((JT.A52_3F2R, JT.A52_STEREO, False, 0), False),
    "reduce_premixed": ((JT.A52_3F2R, JT.A52_STEREO, False, 0), True),
    "reduce_lfe": ((JT.A52_3F2R, JT.A52_STEREO | JT.A52_LFE, False, 0),
                   False),
    "pass_premixed": ((JT.A52_STEREO, JT.A52_STEREO, True, 0), True),
    "pass_premixed_lfe": ((JT.A52_3F2R, JT.A52_3F2R | JT.A52_LFE, False, 0),
                          True),
    "time_stereo_remat": ((JT.A52_STEREO, JT.A52_STEREO, True, 0), False),
    "time_upmix_chanbias": ((JT.A52_2F1R, JT.A52_2F2R | JT.A52_LFE, False,
                             0b00101), False),
}


def _steady_blocks(fmt, premixed, long_only, rng, B=3, n=12):
    nch = fmt.nch_out if premixed else 6
    blocks = {
        "freq": (rng.standard_normal((B, n, nch, 256)) * 0.02
                 ).astype(np.float32),
        "bias": np.zeros((B, n), np.float32),
        "remat": rng.random((B, n, 256)) < 0.5,
        "coeff": (rng.random((B, n, 5)) + 0.5).astype(np.float32),
    }
    if long_only:
        blocks["blksw"] = np.zeros((B, n, 5), bool)
    elif fmt.nf_out < fmt.nfchans:
        # freq path: uniform blksw across channels in each block
        blocks["blksw"] = np.repeat(rng.random((B, n, 1)) < 0.5, 5, axis=2)
    else:
        blocks["blksw"] = rng.random((B, n, 5)) < 0.5
    return blocks


@pytest.mark.parametrize("branch", list(BRANCHES))
@pytest.mark.parametrize("long_only", [True, False])
def test_pipeline_steady_matches_jax(branch, long_only):
    spec, premixed = BRANCHES[branch]
    jfmt, fmt = JD.StreamFormat(*spec), PD.StreamFormat(*spec)
    rng = np.random.default_rng(21)
    B = 3
    blocks = _steady_blocks(fmt, premixed, long_only, rng, B=B)
    assert PD.steady_ok(fmt, blocks) and JD.steady_ok(jfmt, blocks)
    delay = (rng.standard_normal((B, 6, 128)) * 0.05).astype(np.float32)
    downmixed = np.array([True, False, True])
    jfn = jax_pipeline(jfmt, steady=True, long_only=long_only,
                       premixed=premixed, pallas=False, exact=False)
    (jd, jm), jp = jfn((jnp.asarray(delay), jnp.asarray(downmixed)), blocks)
    (md, mm), mp = PD._pipeline_steady(
        fmt, (torch.from_numpy(delay), torch.from_numpy(downmixed)),
        {k: torch.from_numpy(v) for k, v in blocks.items()},
        long_only=long_only, premixed=premixed)
    assert mp.shape == jp.shape == (B, 12, fmt.nch_out, 256)
    np.testing.assert_allclose(mp.numpy(), np.asarray(jp), rtol=0,
                               atol=FP32_ATOL)
    np.testing.assert_allclose(md.numpy(), np.asarray(jd), rtol=0,
                               atol=FP32_ATOL)
    np.testing.assert_array_equal(mm.numpy(), np.asarray(jm))
    # the same at bias 384 through the port's dispatcher, as int16
    blocks["bias"] = np.full((B, 12), 384.0, np.float32)
    _, jp = jfn((jnp.asarray(delay), jnp.asarray(downmixed)), blocks)
    fn = batched_pipeline(fmt, emit_int16=True, steady=True,
                          long_only=long_only, premixed=premixed,
                          exact=False, fused=False)
    _, pi = fn((torch.from_numpy(delay), torch.from_numpy(downmixed)),
               {k: torch.from_numpy(v) for k, v in blocks.items()})
    ji = JF.convert_to_int16(jp)
    assert np.abs(pi.numpy().astype(np.int64)
                  - np.asarray(ji, np.int64)).max() <= 1


def test_stream_format_and_steady_ok_agree():
    rng = np.random.default_rng(2)
    for acmod, output, slev_zero, chanbias in itertools.product(
            range(8), list(range(11)) + [JT.A52_STEREO | JT.A52_LFE,
                                         JT.A52_3F2R | JT.A52_LFE],
            (False, True), (0, 3)):
        spec = (acmod, output, slev_zero, chanbias)
        jf, pf = JD.StreamFormat(*spec), PD.StreamFormat(*spec)
        for prop in ("nfchans", "nf_out", "lfe_out", "nch_out",
                     "identity_mix"):
            assert getattr(pf, prop) == getattr(jf, prop), (spec, prop)
        blocks = {"blksw": rng.random((2, 6, 5)) < 0.2,
                  "coeff": (rng.random((2, 6, 5)) < 0.9).astype(np.float32)}
        assert PD.steady_ok(pf, blocks) == JD.steady_ok(jf, blocks)


def test_exact_mode_raises(monkeypatch):
    """The order-exact IMDCT is not ported: the default ACCURACY
    ("reference") refuses to build a pipeline instead of running fast."""
    monkeypatch.setattr(PD, "ACCURACY", "reference")
    fmt = PD.StreamFormat(JT.A52_3F2R, JT.A52_STEREO, False, 0)
    assert PD.default_exact()
    with pytest.raises(NotImplementedError, match="ROADMAP A2"):
        batched_pipeline(fmt, emit_int16=True, steady=True, long_only=True,
                         premixed=True)
    with pytest.raises(NotImplementedError, match="ROADMAP A2"):
        PD._pipeline_steady(fmt, None, {}, exact=True)
    with pytest.raises(NotImplementedError, match="ROADMAP A4"):
        batched_pipeline(fmt, exact=False)
