"""Port: the fused steady branch of batched_pipeline vs the JAX package.

The same inputs, made with numpy from a seed, go through the JAX
batched_pipeline -- with the Pallas kernel in interpret mode (as
tests/test_pallas_steady.py runs it on the CPU) and through its XLA steady
body -- and through the port's fused branch, which on CPU tensors runs the
kernel's plain PyTorch version.  Held to the fused-path contract:
<= PCM_LSB_TOL int16 LSB on PCM, <= CARRY_ATOL on the carried delay.
"""
import os

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
from ac3acm_tpu_torch.ops.filterbank import mats_on, split_tf32, wt_split
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


@pytest.fixture
def count_k1(monkeypatch):
    """Counts the pipeline's calls of fused_steady (on the CPU the
    wrapper's launch counter stays put)."""
    from ac3acm_tpu_torch.parallel import pipeline as PP
    calls = []

    def counted(*args):
        calls.append(args[0].shape)
        return FS.fused_steady(*args)

    monkeypatch.setattr(PP, "fused_steady", counted)
    return calls


def test_positional_slots_bind_as_in_jax(count_k1):
    """A JAX-style positional call (fmt, mesh, emit_int16, steady,
    long_only, premixed, pallas, exact) binds the same arguments in both
    packages: (..., True, False, False) is the plain fast body, no K1
    call, within PCM_LSB_TOL of JAX's same call; (..., True, True) is K1,
    one call a chunk, with exact left to mean fast."""
    spec = FORMATS["5.1to2.0+LFE"]
    jfmt, fmt = JFormat(*spec), StreamFormat(*spec)
    rng = np.random.default_rng(17)
    B = 3
    chunks = _chunks(fmt.nch_out, rng, B=B)
    delay = (rng.standard_normal((B, 6, 128)) * 0.01).astype(np.float32)
    downmixed = np.full((B,), True)
    outs = {}
    for slots in ((False, False), (True,)):
        jfn = jax_pipeline(jfmt, None, True, True, True, True, False, False)
        fn = batched_pipeline(fmt, None, True, True, True, True, *slots)
        carry = (torch.from_numpy(delay), torch.from_numpy(downmixed))
        jcarry = (jnp.asarray(delay), jnp.asarray(downmixed))
        before = len(count_k1)
        for blocks in chunks:
            carry, pcm = fn(carry, {k: torch.from_numpy(v)
                                    for k, v in blocks.items()})
            jcarry, jpcm = jfn(jcarry, blocks)
            assert np.abs(pcm.numpy().astype(np.int64)
                          - np.asarray(jpcm, np.int64)).max() \
                <= FS.PCM_LSB_TOL, slots
        outs[slots] = len(count_k1) - before
        np.testing.assert_allclose(carry[0].numpy(), np.asarray(jcarry[0]),
                                   rtol=0, atol=FS.CARRY_ATOL)
    assert outs == {(False, False): 0, (True,): len(chunks)}


def test_pallas_and_fused_are_one_choice(count_k1):
    """pallas (JAX's slot) and fused (the port's keyword) spell the same
    choice: either alone picks the body, the same value twice is taken,
    different values raise ValueError."""
    fmt = StreamFormat(*FORMATS["5.1to2.0"])
    kw = dict(emit_int16=True, steady=True, long_only=True, premixed=True)
    for pallas, fused in ((True, False), (False, True)):
        with pytest.raises(ValueError, match="pallas"):
            batched_pipeline(fmt, pallas=pallas, fused=fused, **kw)
    blocks = {k: torch.from_numpy(v) for k, v in
              _chunks(fmt.nch_out, np.random.default_rng(3), B=2,
                      nchunks=1)[0].items()}
    carry = (torch.zeros((2, 6, 128)), torch.ones(2, dtype=torch.bool))
    for choice, calls in (({"pallas": True}, 1), ({"fused": True}, 1),
                          ({"pallas": True, "fused": True}, 1),
                          ({"pallas": False}, 0), ({"fused": False}, 0),
                          ({"pallas": False, "fused": False}, 0)):
        before = len(count_k1)
        batched_pipeline(fmt, exact=False, **choice, **kw)(carry, blocks)
        assert len(count_k1) - before == calls, choice
    with pytest.raises(AssertionError, match="fast mode"):
        batched_pipeline(fmt, pallas=True, exact=True, **kw)


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



# ---------------------------------------------------------------------------
# The 3xTF32 split the CUDA kernel's tensor-core product relies on
# ---------------------------------------------------------------------------

GOLDEN = os.path.join(os.path.dirname(__file__), "golden", "bench_51_448.ac3")


def _split_inputs(name):
    rng = np.random.default_rng(23)
    if name == "random":
        x = rng.standard_normal(4096) * 10.0 ** rng.integers(-6, 4, 4096)
    elif name == "zeros_and_tiny":
        # +-0, and tiny values whose low part stays a normal float32
        x = np.concatenate([[0.0, -0.0], 2.0 ** -100 * (1 + rng.random(510)),
                            -(2.0 ** -90) * (1 + rng.random(512))])
    elif name == "ties":
        # exactly half a TF32 ulp above a TF32 value: ties go away from zero
        m = rng.integers(0, 1 << 10, 1024)
        x = (1.0 + m / 1024.0 + 2.0 ** -11) * np.where(m % 2, 1.0, -1.0)
    else:
        x = mats_on("cpu")[0].numpy().ravel()
    return torch.from_numpy(np.asarray(x, np.float32))


@pytest.mark.parametrize("name", ["random", "zeros_and_tiny", "ties",
                                  "w_long"])
def test_split_tf32_hi_lo(name):
    """hi and lo are TF32 values (low 13 mantissa bits clear) and x - hi - lo
    is at most 2^-21 |x|: two operands of 11 significant bits hold 22."""
    x = _split_inputs(name)
    hi, lo = split_tf32(x)
    for part in (hi, lo):
        assert part.dtype == torch.float32
        assert int((part.view(torch.int32) & 0x1FFF).abs().max()) == 0
    x64, hi64, lo64 = (t.double() for t in (x, hi, lo))
    assert bool(((x64 - hi64).abs() <= 2.0 ** -11 * x64.abs()).all())
    assert bool(((x64 - hi64 - lo64).abs() <= 2.0 ** -21 * x64.abs()).all())
    if name == "ties":
        assert bool((hi.abs() > x.abs()).all())


def test_wt_split_rebuilds_w_long():
    """Wt_hi + Wt_lo, transposed back, is w_long to the split's bound, in
    the [384, 256] K-contiguous form the kernel reads."""
    w = mats_on("cpu")[0]
    wt_hi, wt_lo = wt_split()
    for part in (wt_hi, wt_lo):
        assert tuple(part.shape) == (384, 256) and part.is_contiguous()
        assert int((part.view(torch.int32) & 0x1FFF).abs().max()) == 0
    back = (wt_hi.double() + wt_lo.double()).T
    assert bool(((back - w.double()).abs() <= 2.0 ** -21 * w.abs().double())
                .all())
    hi, lo = split_tf32(w)
    assert torch.equal(wt_hi, hi.T) and torch.equal(wt_lo, lo.T)


def _golden_planes(lanes=4, frames=8):
    """Premixed 5.1 -> 2.0 planes of the golden stream, one frame rotation
    per lane: freq [B, n, 2, 256], d0 [B, 2, 128], bias [B, n]."""
    from ac3acm_tpu_torch.host.native import DenseBatchParser
    es = open(GOLDEN, "rb").read()
    r = DenseBatchParser(1).parse([es], frames,
                                  JT.A52_STEREO | JT.A52_ADJUST_LEVEL,
                                  1.0, 384.0, pre_planes=2)
    assert r["nframes"][0] == frames and r["premix_ok"].all()
    one = r["freq_pre"][0]                                   # [n, 2, 256]
    freq = np.stack([np.roll(one, 6 * k, axis=0) for k in range(lanes)])
    bias = np.broadcast_to(r["bias"], (lanes, one.shape[0])).copy()
    rng = np.random.default_rng(0)
    d0 = (rng.standard_normal((lanes, 2, 128)) * 0.01).astype(np.float32)
    return freq.astype(np.float32), d0, bias.astype(np.float32)


def _tf32_product(freq, passes):
    """The kernel's product, emulated in FP32 on the CPU: operands split
    with split_tf32, small terms first, lo * w_lo dropped."""
    f_hi, f_lo = split_tf32(freq)
    wt_hi, wt_lo = wt_split()
    big = torch.matmul(f_hi, wt_hi.T)
    if passes == 1:
        return big
    return (torch.matmul(f_hi, wt_lo.T) + torch.matmul(f_lo, wt_hi.T)) + big


@pytest.mark.parametrize("against", ["plain", "jax_kernel"])
def test_three_pass_product_meets_contract(against, monkeypatch):
    """The emulated 3xTF32 product through the plain epilogue is inside the
    fused-path contract against the plain version and against the JAX
    kernel (interpret mode), on golden-derived content."""
    freq, d0, bias = _golden_planes()
    pcm, dlast = FS.steady_epilogue(
        _tf32_product(torch.from_numpy(freq), 3), torch.from_numpy(d0),
        torch.from_numpy(bias))
    if against == "plain":
        want, dwant = FS.fused_steady_ref(*(torch.from_numpy(a)
                                            for a in (freq, d0, bias)))
        want, dwant = want.numpy(), dwant.numpy()
    else:
        from ac3acm_tpu.ops.pallas_steady import fused_steady as jax_fused
        monkeypatch.setattr(PS, "INTERPRET", True)
        want, dwant = (np.asarray(a) for a in jax_fused(
            jnp.asarray(freq), jnp.asarray(d0), jnp.asarray(bias)))
    assert np.abs(pcm.numpy().astype(np.int64)
                  - want.astype(np.int64)).max() <= FS.PCM_LSB_TOL
    np.testing.assert_allclose(dlast.numpy(), dwant, rtol=0,
                               atol=FS.CARRY_ATOL)


def test_one_pass_product_breaks_contract():
    """Why three passes: ONE TF32 pass on the same content is off by more
    than the contract's one LSB (and the library's TF32 switch stays off)."""
    freq, d0, bias = _golden_planes()
    args = [torch.from_numpy(a) for a in (d0, bias)]
    pcm, _ = FS.steady_epilogue(_tf32_product(torch.from_numpy(freq), 1),
                                *args)
    want, _ = FS.fused_steady_ref(torch.from_numpy(freq), *args)
    err = (pcm.to(torch.int32) - want.to(torch.int32)).abs().max()
    assert int(err) > FS.PCM_LSB_TOL
    assert not torch.backends.cuda.matmul.allow_tf32


def test_wt_tiles_hold_the_split_in_kernel_order():
    """The kernel's B operand: tile [s, m] is columns [8s, 8s + 8) of
    Wt_hi (m = 0) / Wt_lo (m = 1); in it element (r, k) lies in 16-byte
    chunk (k // 4) ^ ((r >> 2) & 1) of row r (the 32-byte swizzle)."""
    from ac3acm_tpu_torch.ops.filterbank import wt_tiles_on
    tiles = wt_tiles_on("cpu")
    assert tuple(tiles.shape) == (32, 2, 384, 8) and tiles.is_contiguous()
    parts = wt_split()
    r = torch.arange(384)[:, None]
    k = torch.arange(256)[None, :]
    pos = (((k % 8) // 4) ^ ((r >> 2) & 1)) * 4 + k % 4
    for m in range(2):
        assert torch.equal(tiles[k // 8, m, r, pos], parts[m])
