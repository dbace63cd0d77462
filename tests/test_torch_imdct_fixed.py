"""Port: the fixed-point (LIBA52_FIXED, int32 Q30) order-exact IMDCT and
the fixed block pipeline on the CPU, bitwise against the JAX package.

  * _mul_fixed (the reference's split-16 MUL) on int32 edge values, with
    the counterexample that keeps the float sign fold out of Q30.
  * get_variant("fixed"): imdct512, imdct256 and filterbank, long and
    short, on Q30-scale and full-range rows; the split (split_fb_fixed_ref,
    the plain version of kernel B1Q) plus its overlap-add against JAX's
    filterbank.
  * fixed_block_pipeline against JAX's on the same ac3h_sdec_parse_fixed
    blocks, carry included.
  * split_fb_fixed's checks and its Q30 tables (those the kernel reads).
"""
import ctypes as C
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ac3acm_tpu.models import decoder as JD
from ac3acm_tpu.ops import imdct_exact as JE
from ac3acm_tpu_torch import tables as T
from ac3acm_tpu_torch.host.native import get_lib
from ac3acm_tpu_torch.models import decoder as PD
from ac3acm_tpu_torch.ops import imdct_exact as PE

GOLDEN = os.path.join(os.path.dirname(__file__), "golden")
I32_MIN, I32_MAX = -2 ** 31, 2 ** 31 - 1
R = 9                                 # rows a case: one shape, one compile

# JAX's fixed entry points, jitted once for the module (one compile each)
_JIT = {}


def _jax(name):
    if name not in _JIT:
        _JIT[name] = jax.jit(JE.get_variant("fixed")[name])
    return _JIT[name]


def _rows(scale, rng, n=R, width=256):
    if scale == "q30":                # decoded content: |x| well below 2^31
        return (rng.standard_normal((n, width)) * 2 ** 27).astype(np.int32)
    x = rng.integers(I32_MIN, I32_MAX + 1, (n, width), dtype=np.int64)
    x[0, ::3] = I32_MIN
    x[1, 1::3] = I32_MAX
    return x.astype(np.int32)


def test_mul_fixed_matches_jax_on_edges():
    edges = np.array([0, 1, -1, 2, -2, 0x7FFF, 0x8000, 0xFFFF, 0x10000,
                      -0x8000, -0x10000, -0x10001, 1 << 29, 1 << 30,
                      -(1 << 30), I32_MAX, I32_MIN, I32_MIN + 1,
                      123456789, -987654321], np.int32)
    a, b = (x.ravel() for x in np.meshgrid(edges, edges))
    rng = np.random.default_rng(1)
    a = np.concatenate([a, rng.integers(I32_MIN, I32_MAX + 1, 4000,
                                        dtype=np.int64).astype(np.int32)])
    b = np.concatenate([b, rng.integers(I32_MIN, I32_MAX + 1, 4000,
                                        dtype=np.int64).astype(np.int32)])
    want = np.asarray(JE._mul_fixed(jnp.asarray(a), jnp.asarray(b)))
    got = PE._i32(PE._mul_fixed(torch.from_numpy(a), torch.from_numpy(b)))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    # MUL(a, b) == MUL(b, a); from int64 operands taken mod 2^32
    swapped = PE._i32(PE._mul_fixed(torch.from_numpy(b), torch.from_numpy(a)))
    assert torch.equal(got, swapped)
    wide = torch.from_numpy(a.astype(np.int64) + (5 << 32))
    assert torch.equal(PE._i32(PE._mul_fixed(wide, torch.from_numpy(b))), got)


def test_q30_mul_is_not_odd():
    """MUL truncates with arithmetic shifts: MUL(-1, 2^29) = -1 while
    -MUL(1, 2^29) = 0, so the float z's folded signs cannot carry over;
    the fixed z keeps each value's own sign (z[2i] == z[255-2i] on a long
    row, z[2i] == -z[255-2i] in float)."""
    m = lambda a, b: int(PE._i32(PE._mul_fixed(torch.tensor([a]),
                                               torch.tensor([b])))[0])
    jm = lambda a, b: int(JE._mul_fixed(jnp.int32(a), jnp.int32(b)))
    assert m(-1, 1 << 29) == jm(-1, 1 << 29) == -1
    assert -m(1, 1 << 29) == -jm(1, 1 << 29) == 0
    x = _rows("q30", np.random.default_rng(2), n=2)
    z, _ = PE.split_fb_fixed_ref(torch.from_numpy(x))
    i = np.arange(64)
    assert torch.equal(z[:, 2 * i], z[:, 255 - 2 * i])
    zf, _ = PE.split_fb_exact_ref(torch.from_numpy(x).float() * 2.0 ** -30)
    assert torch.equal(zf[:, 2 * i], -zf[:, 255 - 2 * i])


@pytest.mark.parametrize("scale", ["q30", "full"])
@pytest.mark.parametrize("name", ["imdct512", "imdct256"])
def test_imdct_matches_jax(name, scale):
    rng = np.random.default_rng({"q30": 3, "full": 4}[scale])
    x, delay = _rows(scale, rng), _rows(scale, rng, width=128)
    bias = np.int32(0)
    jo, jd = _jax(name)(x, delay, bias)
    po, pd = PE.get_variant("fixed")[name](
        torch.from_numpy(x), torch.from_numpy(delay), torch.tensor(bias))
    assert po.dtype == pd.dtype == torch.int32
    np.testing.assert_array_equal(po.numpy(), np.asarray(jo))
    np.testing.assert_array_equal(pd.numpy(), np.asarray(jd))


@pytest.mark.parametrize("scale", ["q30", "full"])
def test_filterbank_matches_jax(scale):
    """get_variant("fixed")["filterbank"] (the split's plain version, then
    the eager overlap-add) and the split plus _ola_fixed written out, on
    rows mixing long and short blocks, a non-zero bias included."""
    rng = np.random.default_rng({"q30": 5, "full": 6}[scale])
    x, delay = _rows(scale, rng), _rows(scale, rng, width=128)
    blksw = rng.random(R) < 0.5
    bias = rng.integers(-1000, 1000, R).astype(np.int32)
    bias[:3] = 0
    jo, jd = _jax("filterbank")(x, delay, blksw, bias)
    tx, td, tb = map(torch.from_numpy, (x, delay, blksw))
    po, pd = PE.get_variant("fixed")["filterbank"](tx, td, tb,
                                                   torch.from_numpy(bias))
    np.testing.assert_array_equal(po.numpy(), np.asarray(jo))
    np.testing.assert_array_equal(pd.numpy(), np.asarray(jd))
    z, d = PE.split_fb_fixed_ref(tx, tb)
    out = PE._ola_fixed(z, td, tb, torch.from_numpy(bias)[:, None])
    np.testing.assert_array_equal(out.numpy(), np.asarray(jo))
    np.testing.assert_array_equal(d.numpy(), np.asarray(jd))


def test_float_variant_is_the_exact_filterbank():
    """get_variant("float") gives the float entry points: its filterbank
    is filterbank_exact, its imdct512 the exact long transform."""
    v = PE.get_variant("float")
    assert v["filterbank"] is PE.filterbank_exact
    rng = np.random.default_rng(7)
    x = torch.from_numpy((rng.standard_normal((3, 256)) * .05)
                         .astype(np.float32))
    d = torch.from_numpy((rng.standard_normal((3, 128)) * .05)
                         .astype(np.float32))
    o, dn = v["imdct512"](x, d, torch.tensor(0.0))
    o2, dn2 = PE.filterbank_exact(x, d, torch.zeros(3, dtype=torch.bool),
                                  torch.zeros(3))
    assert torch.equal(o, o2) and torch.equal(dn, dn2)
    with pytest.raises(ValueError, match="float|fixed"):
        PE.get_variant("double")


def test_fixed_tables_are_the_packed_ones():
    """The Q30 tables equal JAX's _tw_fixed, and the kernel's packed table
    holds them at the offsets the float one uses."""
    jtw, ptw = JE._tw_fixed(), PE._tw_fixed()
    assert set(jtw) == set(ptw)
    for k in jtw:
        np.testing.assert_array_equal(ptw[k], np.asarray(jtw[k]), err_msg=k)
    packed = PE._tw_on("cpu", "fixed")["packed"]
    assert packed.dtype == torch.int32 and packed.numel() == 632
    off = 0
    for key, n in PE._PACKED:
        np.testing.assert_array_equal(packed[off:off + n].numpy(), ptw[key])
        off += n


def test_split_fb_fixed_refuses_bad_inputs():
    x = torch.zeros(4, 256, dtype=torch.int32)
    before = PE.launches_fixed
    z, d = PE.split_fb_fixed(x, torch.zeros(4, dtype=torch.bool))
    assert PE.launches_fixed == before, "CPU tensors must not launch B1Q"
    assert z.dtype == d.dtype == torch.int32
    assert z.shape == (4, 256) and d.shape == (4, 128)
    with pytest.raises(TypeError, match="int32"):
        PE.split_fb_fixed(x.float())
    with pytest.raises(ValueError):
        PE.split_fb_fixed(torch.zeros(4, 255, dtype=torch.int32))
    with pytest.raises(ValueError, match="contiguous"):
        PE.split_fb_fixed(torch.zeros(256, 4, dtype=torch.int32).t())
    with pytest.raises(ValueError, match="aligned"):
        PE.split_fb_fixed(torch.zeros(4 * 256 + 1,
                                      dtype=torch.int32)[1:].view(4, 256))
    with pytest.raises(TypeError):
        PE.split_fb_fixed(x, torch.zeros(4, dtype=torch.uint8))
    with pytest.raises(ValueError):
        PE.split_fb_fixed(x, torch.zeros(3, dtype=torch.bool))


def _parse_fixed(path, flags, nframes):
    """ac3h_sdec_parse_fixed over the first frames of a golden: the fixed
    device path's blocks, as numpy, one dict a frame, with its meta."""
    from ac3acm_tpu_torch.host.native import _frames
    lib = get_lib()
    d = lib.ac3h_sdec_new(0)
    out = []
    try:
        for fb in list(_frames(open(path, "rb").read()))[:nframes]:
            freq = np.zeros((6, 6, 256), np.int32)
            blksw = np.zeros((6, 5), np.uint8)
            czero = np.zeros((6, 5), np.uint8)
            meta = np.zeros(6, np.int32)
            rc = lib.ac3h_sdec_parse_fixed(
                d, fb, flags, float(1 << 26), C.c_void_p(freq.ctypes.data),
                C.c_void_p(blksw.ctypes.data), C.c_void_p(czero.ctypes.data),
                C.c_void_p(meta.ctypes.data))
            assert rc == 0
            out.append((meta.copy(), {
                "freq": freq, "blksw": blksw.astype(bool),
                "coeff": 1.0 - czero.astype(np.float32),
                "remat": np.zeros((6, 256), bool),
                "bias": np.zeros(6, np.int32)}))
    finally:
        lib.ac3h_sdec_free(d, 0)
    return out


def test_fixed_block_pipeline_matches_jax():
    """Three frames of the 5.1 golden downmixed to stereo (the frequency
    path and its carry fixups) through both pipelines from the zero
    carry: every block's PCM and the carry after each frame equal, int32
    throughout; the carry survives a device round trip on the CPU."""
    frames = _parse_fixed(os.path.join(GOLDEN, "bench_51_448.ac3"),
                          T.A52_STEREO | T.A52_ADJUST_LEVEL, 3)
    jc = JD.init_fixed_carry()
    pc = PD.init_fixed_carry(device="cpu")
    assert pc[0].dtype == torch.int32 and pc[0].shape == (6, 128)
    assert bool(pc[1]) and pc[1].shape == ()
    for meta, blocks in frames:
        spec = dict(acmod=int(meta[0]), output=int(meta[1]),
                    slev_zero=bool(meta[3]), chanbias=int(meta[2]))
        jc, jp = JD.fixed_block_pipeline(JD.StreamFormat(**spec))(
            jc, {k: jnp.asarray(v) for k, v in blocks.items()})
        pc, pp = PD.fixed_block_pipeline(PD.StreamFormat(**spec))(pc, blocks)
        assert pp.dtype == pc[0].dtype == torch.int32
        np.testing.assert_array_equal(pp.numpy(), np.asarray(jp))
        np.testing.assert_array_equal(pc[0].numpy(), np.asarray(jc[0]))
        assert bool(pc[1]) == bool(jc[1])
    assert pp.shape == (6, 2, 256) and int(pp.abs().max()) > 0


def test_no_card_no_fixed_carry(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        PD.init_fixed_carry()
