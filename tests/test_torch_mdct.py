"""Port: the encoder's int-exact filterbank and rate model vs the JAX package.

Seeded numpy inputs, extremes included (full-scale +-32767 / -32768
square waves, silence, single impulses, near-overrange coefficients),
through the JAX functions (jitted on the CPU) and the port's
(device="cpu"), held to bitwise equality.  The shifts by data-dependent
counts are checked at counts outside [0, 31], where XLA defines the
result and the port clamps the count before shifting.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ac3acm_tpu.tables as JT
from ac3acm_tpu.models import encoder as JE
from ac3acm_tpu.ops import alloc as JA
from ac3acm_tpu.ops import mdct as JM
from ac3acm_tpu_torch.models import encoder as PE
from ac3acm_tpu_torch.ops import alloc as PA
from ac3acm_tpu_torch.ops import mdct as PM


def _same(mine, ref, what=""):
    mine = mine.numpy() if isinstance(mine, torch.Tensor) else mine
    ref = np.asarray(ref)
    assert mine.shape == ref.shape, (what, mine.shape, ref.shape)
    assert np.array_equal(mine.astype(np.int64), ref.astype(np.int64)), what


def _blocks(seed, n=24):
    """[n, 256] int16-valued int32 rows: noise at several scales, a
    full-scale square wave (+-32767 and one of -32768), silence, single
    impulses, a DC block."""
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((n, 256)) * rng.choice(
        [10.0, 300.0, 8000.0, 30000.0], (n, 1))).round()
    sq = np.where(np.arange(256) % 32 < 16, 32767, -32767)
    x[0] = sq
    x[1] = np.where(np.arange(256) % 8 < 4, 32767, -32768)
    x[2] = 0
    x[3] = 0
    x[3, 100] = 32767
    x[4] = 0
    x[4, 0] = -32768
    x[5] = 12345
    return np.clip(x, -32768, 32767).astype(np.int32)


def test_fft128_and_mdct512_bitwise():
    rng = np.random.default_rng(0)
    re = rng.integers(-32768, 32768, (16, 128)).astype(np.int32)
    im = rng.integers(-32768, 32768, (16, 128)).astype(np.int32)
    re[0] = -32768
    im[0] = 32767
    jr, ji = jax.jit(JM._fft128)(re, im)
    pr, pi = PM._fft128(torch.from_numpy(re), torch.from_numpy(im))
    _same(pr, jr, "fft re")
    _same(pi, ji, "fft im")
    x = np.concatenate([_blocks(1), _blocks(2)], axis=-1)        # [24, 512]
    _same(PM.mdct512(torch.from_numpy(x)), jax.jit(JM.mdct512)(x), "mdct")


def test_window_norm_and_exponents_bitwise():
    last, cur = _blocks(3), _blocks(4)
    cur[6] = 0
    last[6] = 0
    cur[7], last[7] = last[0], cur[1]          # two full-scale halves
    jx, jv, js = jax.jit(JM.window_norm_block)(last, cur)
    px, pv, ps = PM.window_norm_block(torch.from_numpy(last),
                                      torch.from_numpy(cur))
    for a, b, w in ((px, jx, "windowed"), (pv, jv, "shift"), (ps, js, "exp")):
        _same(a, b, w)
    assert int(pv.min()) >= 0 and int(pv.max()) <= 14
    coef = PM.mdct512(px)
    # near-overrange coefficients: push some past the 24 exponent limit
    coef[8] = torch.tensor([1 << k for k in range(17)] * 15 + [0])[:256]
    coef[9] = -coef[8]
    exps = ps.clone()
    exps[8:10] = -9
    je, jc = jax.jit(JM.extract_exponents)(coef.numpy(), exps.numpy())
    pe, pc = PM.extract_exponents(coef, exps)
    _same(pe, je, "exp")
    _same(pc, jc, "overrange-zeroed coef")
    assert bool((pe[8] == 24).any()) and bool((pc[8] == 0).any())


def test_or_reduce_equals_amax_and_av_log2():
    """The reference ORs |x| over a block; the port takes amax(|x|): both
    have the same top set bit.  av_log2 equals JAX's over the int32
    range's edges."""
    rng = np.random.default_rng(5)
    x = np.abs(_blocks(6, 64)).astype(np.int64)
    x[10] = 0
    x[11, :] = 1 << np.arange(256) % 16
    ored = np.bitwise_or.reduce(x, axis=-1)
    vmax = torch.from_numpy(x).amax(dim=-1)
    _same(PM.av_log2(vmax.to(torch.int32)),
          JM.av_log2(jnp.asarray(ored, jnp.int32)), "or vs amax")
    v = np.concatenate([np.arange(0, 70000), (1 << np.arange(31)),
                        (1 << np.arange(1, 32)) - 1,
                        rng.integers(0, 2**31 - 1, 5000)]).astype(np.int64)
    v = np.clip(v, 0, 2**31 - 1).astype(np.int32)
    _same(PM.av_log2(torch.from_numpy(v)), jax.jit(JM.av_log2)(v), "av_log2")


def test_encode_exp_static_bitwise():
    rng = np.random.default_rng(7)
    exp = rng.integers(0, 25, (6, 5, 256)).astype(np.int32)
    exp[0] = 24
    exp[1] = 0
    exp[2, :, ::2] = 0
    exp[2, :, 1::2] = 24
    for nb, g in ((223, 1), (223, 2), (223, 4), (7, 1)):
        je, jb = JE._encode_exp_static(jnp.asarray(exp), nb, g)
        pe, pb = PE._encode_exp_static(torch.from_numpy(exp), nb, g)
        _same(pe, je, f"encode_exp {nb} {g}")
        assert pb == jb


@pytest.mark.parametrize("shift", [-40, -33, -1, 0, 7, 31, 32, 33, 60])
def test_quantize_shift_extremes(shift):
    """quantize at exponent differences that give shift counts below 0
    and above 31 (XLA's results: 0 for <<, the sign for >>), every class,
    coefficients up to int32's edges; the exponents as int32 (JAX's form)
    and as int8 (the frame core's)."""
    rng = np.random.default_rng(100 + shift)
    n = 16 * 256
    coef = rng.integers(-(1 << 17), 1 << 17, n).astype(np.int32)
    coef[:16] = [0, 1, -1, 65535, -65536, 2**31 - 1, -2**31, 2**30,
                 -2**30, 32767, -32768, 7, -7, 1 << 16, -(1 << 16), 3]
    bap = np.tile(np.arange(16, dtype=np.int8), n // 16)
    # e = enc_exp - global_exp; asym lshift = e + qbits - 24
    enc = np.full(n, 24 + shift, np.int32)
    enc[::3] = rng.integers(-10, 40, len(enc[::3]))
    gexp = np.zeros((1,), np.int32) if shift % 2 else np.full((1,), -9,
                                                             np.int32)
    j = jax.jit(JE.quantize)(coef[None], enc[None], gexp, bap[None])
    p = PE.quantize(torch.from_numpy(coef[None]), torch.from_numpy(enc[None]),
                    torch.from_numpy(gexp), torch.from_numpy(bap[None]))
    _same(p, j, f"quantize shift {shift}")
    # the frame core's form: the exponents as int8 (they fit a byte here)
    assert enc.min() >= -128 and enc.max() <= 127
    p8 = PE.quantize(torch.from_numpy(coef[None]),
                     torch.from_numpy(enc[None].astype(np.int8)),
                     torch.from_numpy(gexp), torch.from_numpy(bap[None]))
    _same(p8, j, f"quantize shift {shift}, int8 exponents")


def _rate_inputs(seed, B=8, C=6):
    rng = np.random.default_rng(seed)
    ends = np.full((B, C), 223, np.int32)
    ends[:, C - 1] = 7
    exp = rng.integers(0, 25, (B, C, 256)).astype(np.int32)
    exp[0] = 24
    exp[1] = 0
    live = np.arange(256)[None, None, :] < ends[..., None]
    psd = np.where(live, 3072 - (exp << 7), 0).astype(np.int32)
    mask = rng.integers(0, 4000, (B, C, 50)).astype(np.int32)
    mask[2] = 0
    mask[3] = 8191
    return exp, ends, live, psd, mask


def test_bits_for_snro_over_the_lattice():
    """bits_for_snro == mantissa_bits(bap_from_mask(...)) over the search
    lattice, and == JAX's bits_for_snro."""
    floor = int(JT.FLOORTAB[4])
    exp, ends, live, psd, mask = _rate_inputs(42)
    t = {k: torch.from_numpy(v) for k, v in
         dict(ends=ends, live=live, psd=psd, mask=mask).items()}
    starts = torch.zeros_like(t["ends"])
    jfn = jax.jit(JA.bits_for_snro, static_argnums=4)
    for c in (0, 5, 10, 25, 40, 63):
        for f in (0, 3, 7, 15):
            snro = (((c - 15) << 4) + f) << 2
            fast = PA.bits_for_snro(t["psd"], t["live"], t["mask"], snro,
                                    floor)
            bap = PA.bap_from_mask(t["psd"], t["mask"], snro, floor, starts,
                                   t["ends"])
            _same(fast, PA.mantissa_bits(bap, t["ends"]).numpy(), (c, f))
            _same(fast, jfn(psd, live, mask, np.int32(snro), floor), (c, f))
    # a per-lane offset, broadcast as the search passes it
    snro = torch.tensor([-60, 0, 64, 200, 400, 800, 1000, -300],
                        dtype=torch.int32)[:, None, None]
    _same(PA.bits_for_snro(t["psd"], t["live"], t["mask"], snro, floor),
          jfn(psd, live, mask, snro.numpy(), floor), "per lane")


def test_histogram_rate_model():
    """exp_histogram + bits_for_offsets (the many-offset form) equal
    JAX's and bits_for_snro."""
    floor = int(JT.FLOORTAB[4])
    exp, ends, live, psd, mask = _rate_inputs(43)
    ph = PA.exp_histogram(torch.from_numpy(exp), torch.from_numpy(ends))
    jh = JA.exp_histogram(jnp.asarray(exp), jnp.asarray(ends))
    _same(ph, jh, "histogram")
    cands = np.array([0, 40, 200, -100], np.int32)[:, None, None, None]
    pb = PA.bits_for_offsets(ph, torch.from_numpy(mask),
                             torch.from_numpy(cands), floor)
    _same(pb, JA.bits_for_offsets(jh, jnp.asarray(mask), cands, floor),
          "bits_for_offsets")
    for i, s in enumerate(cands[:, 0, 0, 0]):
        _same(pb[i], PA.bits_for_snro(torch.from_numpy(psd),
                                      torch.from_numpy(live),
                                      torch.from_numpy(mask), int(s),
                                      floor).numpy(), int(s))


def test_chip_smoke_extremes_match_jax():
    """chip_smoke.py holds the card to the port's CPU results on these
    edge cases; here the CPU results are held to the JAX package's."""
    import chip_smoke as CS
    d = CS.enc_extremes()
    port = CS.enc_extreme_outputs(d, "cpu")
    jx, jv, js = jax.jit(JM.window_norm_block)(d["last"], d["cur"])
    je, jc = jax.jit(JM.extract_exponents)(d["coef"], d["cexp"])
    want = dict(windowed=jx, shift=jv, exp_samples=js,
                mdct=jax.jit(JM.mdct512)(jx), exp=je, coef=jc,
                av_log2=jax.jit(JM.av_log2)(d["log2"]),
                quant=jax.jit(JE.quantize)(d["qcoef"], d["qenc"], d["qgexp"],
                                           d["qbap"]))
    assert set(port) == set(want)
    for k in want:
        _same(port[k], want[k], k)
