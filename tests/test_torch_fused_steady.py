"""Port: the fused steady branch of batched_pipeline vs the JAX package.

The same inputs, made with numpy from a seed, go through the JAX
batched_pipeline -- with the Pallas kernel in interpret mode (as
tests/test_pallas_steady.py runs it on the CPU) and through its XLA steady
body -- and through the port's fused branch, which on CPU tensors runs the
kernel's plain PyTorch version.  Held to the fused-path contract:
<= PCM_LSB_TOL int16 LSB on PCM, <= CARRY_ATOL on the carried delay.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ac3acm_tpu.tables as JT
from ac3acm_tpu.models.decoder import StreamFormat as JFormat
from ac3acm_tpu.ops import pallas_steady as PS
from ac3acm_tpu.parallel.pipeline import batched_pipeline as jax_pipeline
from ac3acm_tpu_torch.models.decoder import StreamFormat
from ac3acm_tpu_torch.ops import fused_steady as FS
from ac3acm_tpu_torch.parallel.pipeline import batched_pipeline

# (acmod, output, slev_zero, chanbias): tests/test_pallas_steady.py:18-29
FORMATS = {
    "5.1to2.0": (JT.A52_3F2R, JT.A52_STEREO, False, 0),
    "5.1to2.0+LFE": (JT.A52_3F2R, JT.A52_STEREO | JT.A52_LFE, False, 0),
    "2.0pass": (JT.A52_STEREO, JT.A52_STEREO, True, 0),
    "5.1pass+LFE": (JT.A52_3F2R, JT.A52_3F2R | JT.A52_LFE, False, 0),
}


def _chunks(nch, rng, B=4, n=12, nchunks=2):
    return [{
        "freq": (rng.standard_normal((B, n, nch, 256)) * 0.01
                 ).astype(np.float32),
        "blksw": np.zeros((B, n, 5), bool),
        "bias": np.full((B, n), 384.0, np.float32),
    } for _ in range(nchunks)]


def _run_jax(fmt, chunks, delay, downmixed, pallas):
    fn = jax_pipeline(fmt, emit_int16=True, steady=True, long_only=True,
                      premixed=True, pallas=pallas, exact=False)
    carry = (jnp.asarray(delay), jnp.asarray(downmixed))
    pcms = []
    for blocks in chunks:
        carry, pcm = fn(carry, blocks)
        pcms.append(np.asarray(pcm, np.int64))
    return (np.asarray(carry[0]), np.asarray(carry[1])), \
        np.concatenate(pcms, axis=1)


def _run_port(fmt, chunks, delay, downmixed):
    fn = batched_pipeline(fmt, emit_int16=True, steady=True, long_only=True,
                          premixed=True, exact=False)
    carry = (torch.from_numpy(delay), torch.from_numpy(downmixed))
    pcms = []
    for blocks in chunks:
        carry, pcm = fn(carry, {k: torch.from_numpy(v)
                                for k, v in blocks.items()})
        assert pcm.dtype == torch.int16
        pcms.append(pcm.numpy().astype(np.int64))
    return (carry[0].numpy(), carry[1].numpy()), np.concatenate(pcms, axis=1)


@pytest.mark.parametrize("name", list(FORMATS))
@pytest.mark.parametrize("downmixed0", [True, False])
def test_fused_branch_matches_jax(name, downmixed0, monkeypatch):
    """Port fused branch (plain version on CPU) == JAX fused Pallas kernel
    (interpret mode) and JAX XLA steady body, within the contract, over
    two chunks with the carry chained; the downmixed flag and the upper
    delay planes the kernel does not compute are bitwise equal."""
    spec = FORMATS[name]
    jfmt, fmt = JFormat(*spec), StreamFormat(*spec)
    rng = np.random.default_rng(7)
    B = 4
    chunks = _chunks(fmt.nch_out, rng, B=B)
    delay = (rng.standard_normal((B, 6, 128)) * 0.01).astype(np.float32)
    downmixed = np.full((B,), downmixed0)

    cp, pp = _run_port(fmt, chunks, delay, downmixed)
    cx, px = _run_jax(jfmt, chunks, delay, downmixed, pallas=False)
    monkeypatch.setattr(PS, "INTERPRET", True)
    cf, pf = _run_jax(jfmt, chunks, delay, downmixed, pallas=True)

    for cj, pj in ((cx, px), (cf, pf)):
        assert pp.shape == pj.shape
        assert np.abs(pp - pj).max() <= FS.PCM_LSB_TOL
        np.testing.assert_allclose(cp[0], cj[0], rtol=0, atol=FS.CARRY_ATOL)
        np.testing.assert_array_equal(cp[1], cj[1])
    # planes nf_out..4 (stale or zeroed) and, without LFE, plane 5 are
    # not computed by the kernel: they must match bitwise
    nfo = fmt.nf_out
    np.testing.assert_array_equal(cp[0][:, nfo:5], cx[0][:, nfo:5])
    if not fmt.lfe_out:
        np.testing.assert_array_equal(cp[0][:, 5], delay[:, 5])


def test_fused_steady_ref_matches_jax_kernel(monkeypatch):
    """The plain version alone vs the JAX kernel wrapper (interpret mode)
    on golden-scale inputs at the lane/plane layout the pipeline uses."""
    from ac3acm_tpu.ops.pallas_steady import fused_steady as jax_fused
    monkeypatch.setattr(PS, "INTERPRET", True)
    rng = np.random.default_rng(11)
    B, n, P = 2, 12, 3
    freq = (rng.standard_normal((B, n, P, 256)) * 0.05).astype(np.float32)
    d0 = (rng.standard_normal((B, P, 128)) * 0.05).astype(np.float32)
    bias = np.full((B, n), 384.0, np.float32)
    pj, dj = jax_fused(jnp.asarray(freq), jnp.asarray(d0), jnp.asarray(bias))
    pt, dt = FS.fused_steady_ref(torch.from_numpy(freq), torch.from_numpy(d0),
                                 torch.from_numpy(bias))
    assert np.abs(np.asarray(pj, np.int64)
                  - pt.numpy().astype(np.int64)).max() <= FS.PCM_LSB_TOL
    np.testing.assert_allclose(dt.numpy(), np.asarray(dj), rtol=0,
                               atol=FS.CARRY_ATOL)

