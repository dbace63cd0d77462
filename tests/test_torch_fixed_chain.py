"""Port: the fixed block chain (ops.fixed_chain, kernel B1QS) on the CPU,
bitwise against the JAX package.

  * The affine mixers (D, c, U) the kernel takes equal the port's
    downmix/upmix and JAX's on full-range int32 planes, [5, 256] and
    [5, 128], for every (acmod, output, slev_zero).
  * fixed_block_pipeline (on the CPU: the plain version, _block_step
    block by block) equals JAX's over 7 blocks (a group of 6 and a tail)
    of real Q30 frames in four formats and a synthetic mixed-blksw run
    (JAX's pipeline with its filterbank jitted once for all formats).
  * The plain version takes a lane axis (torch.func.vmap), as
    chip_smoke.py holds every recorded B1QS call to it.
  * The wrapper refuses bad dtypes, shapes and devices, and a CPU tensor
    never launches the kernel.
  * chip_smoke.py's B1QS digest is JAX's.
"""
import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke as CS
from ac3acm_tpu.models import decoder as JD
from ac3acm_tpu.ops import downmix as JDM
from ac3acm_tpu.ops.imdct_exact import get_variant
from ac3acm_tpu_torch import tables as T
from ac3acm_tpu_torch.models import decoder as PD
from ac3acm_tpu_torch.ops import fixed_chain as FC
from ac3acm_tpu_torch.ops.downmix import downmix, upmix

GOLDEN = os.path.join(os.path.dirname(__file__), "golden")
N = CS.B1QS_DIGEST_BLOCKS             # 7 blocks a case: one JAX compile a format


def _wrap(x):
    """int64 -> int32 mod 2^32."""
    return ((np.asarray(x, np.int64) + 2 ** 31) % 2 ** 32 - 2 ** 31).astype(
        np.int32)


@pytest.mark.parametrize("acmod", range(8))
def test_affine_mixers_equal_downmix_and_upmix(acmod):
    rng = np.random.default_rng(100 + acmod)
    for output in range(T.A52_DOLBY + 1):
        for slev_zero in (False, True):
            D, c, U = FC.affine_mixers(acmod, output, slev_zero)
            assert np.abs(D).max() <= 1 and np.abs(U).max() <= 1
            for width in (256, 128):
                planes = rng.integers(-2 ** 31, 2 ** 31, (5, width),
                                      dtype=np.int64).astype(np.int32)
                bias = np.int32(rng.integers(-2 ** 31, 2 ** 31))
                want_d = _wrap(D @ planes.astype(np.int64)
                               + c[:, None] * np.int64(bias))
                want_u = _wrap(U @ planes.astype(np.int64))
                key = (acmod, output, slev_zero, width)
                got = downmix(torch.from_numpy(planes), acmod, output,
                              torch.tensor(bias), slev_zero=slev_zero)
                np.testing.assert_array_equal(got.numpy(), want_d,
                                              err_msg=str(key))
                got = upmix(torch.from_numpy(planes), acmod, output)
                np.testing.assert_array_equal(got.numpy(), want_u,
                                              err_msg=str(key))
                jd = JDM.downmix(jnp.asarray(planes), acmod, output,
                                 jnp.int32(bias), slev_zero=slev_zero)
                np.testing.assert_array_equal(np.asarray(jd), want_d,
                                              err_msg=str(key))
                ju = JDM.upmix(jnp.asarray(planes), acmod, output)
                np.testing.assert_array_equal(np.asarray(ju), want_u,
                                              err_msg=str(key))


def _golden(name, flags):
    """N blocks of a golden's fixed parse (numpy) and its format."""
    frames = CS.fixed_frames(os.path.join(GOLDEN, name), flags,
                             -(-N // 6))
    blocks = {k: np.concatenate([b[k] for _, b in frames])[:N]
              for k in frames[0][1]}
    return frames[0][0], blocks


def _init():
    return np.zeros((6, 128), np.int32), np.array(True)


@functools.lru_cache(maxsize=None)
def _jax_filterbank():
    return jax.jit(get_variant("fixed")["filterbank"])


@functools.lru_cache(maxsize=None)
def _jax_pipeline(jfmt):
    """JAX's fixed_block_pipeline (ac3acm_tpu/models/decoder.py:526, a
    jitted lax.scan of _block_step on get_variant("fixed")'s filterbank)
    with that filterbank under a jit of its own, so that the four formats
    share one trace of it, and XLA's cheaper CPU passes (its compile of
    the unrolled transforms sets this file's time).  The chain is int32
    arithmetic throughout, so neither changes a bit."""
    step = functools.partial(JD._block_step, jfmt,
                             filterbank=_jax_filterbank())
    return jax.jit(lambda carry, blocks: jax.lax.scan(step, carry, blocks),
                   compiler_options={"xla_backend_optimization_level": 0,
                                     "xla_llvm_disable_expensive_passes":
                                     True})


def _jax(fmt, carry, blocks):
    jfmt = JD.StreamFormat(fmt.acmod, fmt.output, fmt.slev_zero,
                           fmt.chanbias)
    (d, m), p = _jax_pipeline(jfmt)(
        (jnp.asarray(carry[0]), jnp.asarray(carry[1])),
        {k: jnp.asarray(v) for k, v in blocks.items()})
    return (np.asarray(d), np.asarray(m)), np.asarray(p)


def _mixed_case():
    """Synthetic blocks in the 5.1 -> 2F2R format: full-range planes,
    mixed blksw (both paths), a zero-coefficient channel, random carry."""
    rng = np.random.default_rng(31)
    blocks = CS.b1qs_blocks(rng, N, "full")
    blocks["blksw"][1] = True                     # one uniform block
    return (PD.StreamFormat(*CS.B1QS_DIGEST_FORMATS[0]),
            CS.b1qs_carry(rng, False), blocks)


CASES = {
    "5.1 -> 3F2R|LFE": lambda: (*_golden("bench_51_448.ac3",
                                         T.A52_3F2R | T.A52_LFE | 32),
                                _init()),
    "5.1 -> mono": lambda: (*_golden("bench_51_448.ac3", T.A52_MONO | 32),
                            _init()),
    "5.1 -> 2F2R": lambda: (*_golden("bench_51_448.ac3", T.A52_2F2R | 32),
                            _init()),
    "stereo golden": lambda: (*_golden("stereo_192.ac3", T.A52_STEREO | 32),
                              _init()),
}


@pytest.mark.parametrize("case", list(CASES) + ["mixed blksw"])
def test_fixed_block_pipeline_matches_jax(case):
    """The port's fixed_block_pipeline on the CPU (B1QS's plain version)
    against JAX's, PCM and carry, over N = 7 blocks.  The stereo golden's
    format is the digest's (2, 2, True, 0), so its JAX program is the
    one the digest reuses."""
    if case == "mixed blksw":
        fmt, carry, blocks = _mixed_case()
        uniform = (blocks["blksw"] == blocks["blksw"][:, :1]).all(1)
        assert uniform.any() and not uniform.all()
    else:
        fmt, blocks, carry = CASES[case]()
    before = FC.launches_fixed_chain
    (pd, pm), pp = PD.fixed_block_pipeline(fmt)(
        tuple(torch.as_tensor(x) for x in carry), blocks)
    assert FC.launches_fixed_chain == before, "CPU tensors launch nothing"
    (jd, jm), jp = _jax(fmt, carry, blocks)
    assert pp.dtype == pd.dtype == torch.int32
    assert pp.shape == (N, fmt.nch_out, 256)
    np.testing.assert_array_equal(pp.numpy(), jp)
    np.testing.assert_array_equal(pd.numpy(), jd)
    assert bool(pm) == bool(jm)
    assert int(pp.abs().max()) > 0


def test_plain_chain_takes_a_lane_axis():
    """fixed_chain_ref under torch.func.vmap equals it lane by lane (the
    one pass chip_smoke.py holds recorded B1QS calls to)."""
    rng = np.random.default_rng(41)
    fmt = PD.StreamFormat(*CS.B1QS_DIGEST_FORMATS[0])
    lanes = [(CS.b1qs_carry(rng, dmx), CS.b1qs_blocks(rng, 3, kind))
             for kind, dmx in (("full", True), ("short", False),
                               ("long", True))]
    carry = tuple(torch.stack([torch.as_tensor(c[i]) for c, _ in lanes])
                  for i in range(2))
    blocks = {k: torch.stack([torch.as_tensor(b[k]) for _, b in lanes])
              for k in lanes[0][1]}
    (d, m), p = torch.func.vmap(functools.partial(FC.fixed_chain_ref, fmt))(
        carry, blocks)
    for i, (c, b) in enumerate(lanes):
        (ld, lm), lp = FC.fixed_chain_ref(
            fmt, tuple(torch.as_tensor(x) for x in c),
            {k: torch.as_tensor(v) for k, v in b.items()})
        assert torch.equal(p[i], lp) and torch.equal(d[i], ld)
        assert bool(m[i]) == bool(lm)


def test_fixed_chain_refuses_bad_inputs():
    rng = np.random.default_rng(51)
    fmt = PD.StreamFormat(7, 2, False, 31)
    carry = tuple(torch.as_tensor(x) for x in _init())
    blocks = {k: torch.as_tensor(v)
              for k, v in CS.b1qs_blocks(rng, 2, "long").items()}
    before = FC.launches_fixed_chain
    (d, m), p = FC.fixed_chain(fmt, carry, blocks)
    assert FC.launches_fixed_chain == before
    assert p.shape == (2, 2, 256) and d.dtype == torch.int32
    (d, m), p = FC.fixed_chain(fmt, carry, {k: v[:0] for k, v in
                                            blocks.items()})
    assert p.shape == (0, 2, 256) and torch.equal(d, carry[0]) and bool(m)
    flat = torch.zeros(2 * 6 * 256 + 1, dtype=torch.int32)
    meta = torch.zeros(2, 256, dtype=torch.bool, device="meta")
    bad_blocks = [
        ("freq", blocks["freq"].long(), TypeError),
        ("blksw", blocks["blksw"].to(torch.uint8), TypeError),
        ("coeff", blocks["coeff"].double(), TypeError),
        ("remat", blocks["remat"].to(torch.int32), TypeError),
        ("bias", blocks["bias"].long(), TypeError),
        ("freq", blocks["freq"][:, :5], ValueError),
        ("blksw", blocks["blksw"][:1], ValueError),
        ("bias", blocks["bias"][:, None], ValueError),
        ("freq", blocks["freq"].transpose(1, 2).contiguous().transpose(1, 2),
         ValueError),
        ("freq", flat[1:].view(2, 6, 256), ValueError),
        ("remat", meta, ValueError),
    ]
    for key, bad, err in bad_blocks:
        with pytest.raises(err):
            FC.fixed_chain(fmt, carry, {**blocks, key: bad})
    with pytest.raises(ValueError, match="lack"):
        FC.fixed_chain(fmt, carry, {k: v for k, v in blocks.items()
                                    if k != "bias"})
    for bad_carry, err in (((carry[0].long(), carry[1]), TypeError),
                           ((carry[0], carry[1].int()), TypeError),
                           ((carry[0][:5], carry[1]), ValueError),
                           ((carry[0], carry[1][None]), ValueError)):
        with pytest.raises(err):
            FC.fixed_chain(fmt, bad_carry, blocks)
    on_meta = {k: v.to("meta") for k, v in blocks.items()}
    with pytest.raises(ValueError, match="cuda or cpu"):
        FC.fixed_chain(fmt, tuple(x.to("meta") for x in carry), on_meta)


def test_chip_smoke_b1qs_digest():
    """chip_smoke.py's B1QS digest, recomputed from the JAX package's
    fixed_block_pipeline on chip_smoke's own cases; the port's plain
    version gives it too."""
    jax_outs, port_outs = [], []
    for spec, carry, blocks in CS.b1qs_digest_cases():
        fmt = PD.StreamFormat(*spec)
        jax_outs.append(_jax(fmt, carry, blocks))
        (d, m), p = FC.fixed_chain(fmt, tuple(torch.as_tensor(x)
                                              for x in carry),
                                   {k: torch.as_tensor(v)
                                    for k, v in blocks.items()})
        port_outs.append(((d.numpy(), m.numpy()), p.numpy()))
    assert CS.b1qs_digest(jax_outs) == CS.B1QS_DIGEST
    assert CS.b1qs_digest(port_outs) == CS.B1QS_DIGEST
