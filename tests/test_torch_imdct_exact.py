"""Port: the order-exact IMDCT and the exact steady body vs the JAX package.

Inputs are made with numpy from a seed and handed to both packages.  The
exact mode is held to equality BY VALUE (np.array_equal, where -0.0 and
+0.0 are one value): the JAX package's guard against FMA contraction on
the CPU turns -0.0 products into +0.0 (ac3acm_tpu/ops/imdct_exact.py:
77-79), the port's eager ops keep the sign.

JAX's exact transform is compiled once for the module, at a fixed row
count; the JAX pipelines reach it through a host callback, so each of
them compiles only its own elementwise part (an exact pipeline compiled
whole costs 15-40 s on a CPU).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ac3acm_tpu.models import decoder as JD
from ac3acm_tpu.ops import imdct_exact as JE
import ac3acm_tpu_torch.tables as PT
from ac3acm_tpu_torch.models import decoder as PD
from ac3acm_tpu_torch.ops import imdct_exact as PE
from tests.test_torch_decoder import BRANCHES, _steady_blocks

ROWS = 512                      # rows per call of the compiled JAX split


@pytest.fixture(scope="module")
def jax_split():
    """-> numpy (coeffs [..., 256], blksw [...] or None) -> (z, d) through
    JAX's split_fb_exact, compiled once for [ROWS, 256]."""
    fn = jax.jit(JE.split_fb_exact)

    def split(coeffs, blksw=None):
        lead = coeffs.shape[:-1]
        c = np.asarray(coeffs, np.float32).reshape(-1, 256)
        b = (np.zeros(len(c), bool) if blksw is None
             else np.asarray(blksw, bool).reshape(-1))
        pad = -len(c) % ROWS
        c = np.concatenate([c, np.zeros((pad, 256), np.float32)])
        b = np.concatenate([b, np.zeros(pad, bool)])
        zs, ds = [], []
        for k in range(0, len(c), ROWS):
            z, d = fn(c[k:k + ROWS], b[k:k + ROWS])
            zs.append(np.asarray(z))
            ds.append(np.asarray(d))
        n = len(c) - pad
        return (np.concatenate(zs)[:n].reshape(lead + (256,)),
                np.concatenate(ds)[:n].reshape(lead + (128,)))

    return split


@pytest.fixture
def jax_exact_callback(jax_split, monkeypatch):
    """JAX's pipelines with their split_fb_exact routed to jax_split."""
    def patched(coeffs, blksw=None):
        shapes = (jax.ShapeDtypeStruct(coeffs.shape[:-1] + (256,),
                                       jnp.float32),
                  jax.ShapeDtypeStruct(coeffs.shape[:-1] + (128,),
                                       jnp.float32))
        if blksw is None:
            blksw = jnp.zeros(coeffs.shape[:-1], bool)
        return jax.pure_callback(jax_split, shapes, coeffs, blksw,
                                 vmap_method="broadcast_all")
    monkeypatch.setattr(JE, "split_fb_exact", patched)


def _rows(seed, n=96):
    """Seeded rows with the edge cases: all +0, all -0, a sprinkling of
    -0, unit-scale signs, small and near-full-scale values."""
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((n, 256)) * 0.05).astype(np.float32)
    x[0] = 0.0
    x[1] = -0.0
    x[2, ::3] = -0.0
    x[3] = np.sign(rng.standard_normal(256)).astype(np.float32)
    x[4] = (rng.random(256) * 2 - 1).astype(np.float32) * np.float32(0.999)
    x[5] *= np.float32(1e-20)
    return x


def _same(mine, ref, what=""):
    mine, ref = np.asarray(mine), np.asarray(ref)
    assert mine.shape == ref.shape and mine.dtype == ref.dtype, what
    assert np.array_equal(mine, ref), \
        (what, float(np.abs(mine.astype(np.float64) - ref).max()))


def test_plain_split_matches_jax(jax_split):
    """imdct512_z, imdct256_z and split_fb_exact (long-only and mixed
    blksw) equal JAX's by value."""
    x = _rows(0)
    blk = np.random.default_rng(1).random(len(x)) < 0.5
    blk[:6] = [False, True, False, True, False, True]
    ones = np.ones(len(x), bool)
    xt = torch.from_numpy(x)
    for name, b, mine in (
            ("imdct512_z", None, PE.imdct512_z(xt)),
            ("imdct256_z", ones, PE.imdct256_z(xt)),
            ("split long-only", None, PE.split_fb_exact(xt)),
            ("split mixed", blk, PE.split_fb_exact(xt, torch.from_numpy(blk)))):
        ref = jax_split(x, b)
        _same(mine[0].numpy(), ref[0], name + " z")
        _same(mine[1].numpy(), ref[1], name + " d")


@pytest.mark.parametrize("size", ["512", "256"])
def test_imdct_exact_entries_match_jax(size):
    """imdct512_exact / imdct256_exact (data, delay, bias) and the float
    variant's imdct*_z equal JAX's by value; get_variant("float") has
    JAX's five keys and "fixed" its three."""
    rng = np.random.default_rng(int(size))
    x = _rows(7, 24)
    delay = (rng.standard_normal((24, 128)) * 0.05).astype(np.float32)
    bias = np.float32(0.375)
    jo, jd = getattr(JE, f"imdct{size}_exact")(x, delay, bias)
    xt, dt = torch.from_numpy(x), torch.from_numpy(delay)
    po, pd = getattr(PE, f"imdct{size}_exact")(xt, dt, torch.tensor(bias))
    _same(po.numpy(), jo, f"imdct{size}_exact out")
    _same(pd.numpy(), jd, f"imdct{size}_exact delay")
    for variant in ("float", "fixed"):
        assert PE.get_variant(variant).keys() == \
            JE.get_variant(variant).keys(), variant
    jz, jzd = JE.get_variant("float")[f"imdct{size}_z"](x)
    pz, pzd = PE.get_variant("float")[f"imdct{size}_z"](xt)
    _same(pz.numpy(), jz, f"imdct{size}_z z")
    _same(pzd.numpy(), jzd, f"imdct{size}_z d")


def test_split_leading_axes_and_plain_twin():
    """The wrapper keeps the leading axes, runs the plain version on the
    CPU (no kernel launch) and the two short-block halves use the
    interleaved coefficients (a short row differs from a long one)."""
    x = torch.from_numpy(_rows(2, 24).reshape(2, 3, 4, 256))
    blk = torch.from_numpy(np.random.default_rng(3).random((2, 3, 4)) < 0.5)
    before = PE.launches
    z, d = PE.split_fb_exact(x, blk)
    assert PE.launches == before, "CPU tensors must not launch the kernel"
    assert z.shape == (2, 3, 4, 256) and d.shape == (2, 3, 4, 128)
    zr, dr = PE.split_fb_exact_ref(x.reshape(-1, 256), blk.reshape(-1))
    assert torch.equal(z.reshape(-1, 256), zr)
    assert torch.equal(d.reshape(-1, 128), dr)
    zl, _ = PE.imdct512_z(x)
    zs, _ = PE.imdct256_z(x)
    assert not torch.equal(zl[blk], zs[blk])
    assert torch.equal(z[blk], zs[blk]) and torch.equal(z[~blk], zl[~blk])


def test_split_refuses_bad_inputs():
    x = torch.zeros(4, 256)
    with pytest.raises(TypeError):
        PE.split_fb_exact(x.double())
    with pytest.raises(ValueError):
        PE.split_fb_exact(torch.zeros(4, 255))
    with pytest.raises(ValueError, match="contiguous"):
        PE.split_fb_exact(torch.zeros(256, 4).t())
    with pytest.raises(TypeError):
        PE.split_fb_exact(x, torch.zeros(4, dtype=torch.uint8))
    with pytest.raises(ValueError):
        PE.split_fb_exact(x, torch.zeros(3, dtype=torch.bool))
    with pytest.raises(ValueError, match="contiguous"):
        PE.split_fb_exact(torch.zeros(2, 2, 256),
                          torch.zeros(2, 2, dtype=torch.bool).t())


def test_twiddle_tables_are_the_packed_ones():
    """The kernel's packed table is imdct_twiddles() bit for bit, at the
    offsets csrc/imdct_exact.cu names."""
    import ac3acm_tpu_torch.tables as PT
    tw, packed = PT.imdct_twiddles(), PE._tw_on("cpu")["packed"].numpy()
    offsets = {"pre1_r": 0, "pre1_i": 128, "post1_r": 256, "post1_i": 320,
               "pre2_r": 384, "pre2_i": 448, "post2_r": 512, "post2_i": 544,
               "roots16": 576, "roots32": 579, "roots64": 586,
               "roots128": 601}
    assert len(packed) == 632
    for key, off in offsets.items():
        np.testing.assert_array_equal(
            packed[off:off + len(tw[key])].view(np.uint32),
            np.asarray(tw[key], np.float32).view(np.uint32), err_msg=key)
    src = open(PE.__file__.replace("ops/imdct_exact.py",
                                   "csrc/imdct_exact.cu")).read()
    for key, off in offsets.items():
        assert f"{key.upper()} = {off}" in src, key


@pytest.mark.parametrize("branch", list(BRANCHES))
@pytest.mark.parametrize("long_only", [True, False])
def test_pipeline_steady_exact_matches_jax(jax_exact_callback, branch,
                                           long_only):
    """_pipeline_steady(exact=True) equals JAX's by value: PCM, delay and
    flag, on every branch, both downmixed entry states, a non-zero
    carry in."""
    spec, premixed = BRANCHES[branch]
    jfmt, fmt = JD.StreamFormat(*spec), PD.StreamFormat(*spec)
    rng = np.random.default_rng(31)
    B = 3
    blocks = _steady_blocks(fmt, premixed, long_only, rng, B=B, n=6)
    blocks["bias"] = rng.standard_normal((B, 6)).astype(np.float32)
    assert PD.steady_ok(fmt, blocks)
    delay = (rng.standard_normal((B, 6, 128)) * 0.05).astype(np.float32)
    downmixed = np.array([True, False, True])
    body = lambda c, b: JD._pipeline_steady(jfmt, c, b, long_only=long_only,
                                            premixed=premixed, exact=True)
    (jd, jm), jp = jax.jit(jax.vmap(body))(
        (jnp.asarray(delay), jnp.asarray(downmixed)), blocks)
    (md, mm), mp = PD._pipeline_steady(
        fmt, (torch.from_numpy(delay), torch.from_numpy(downmixed)),
        {k: torch.from_numpy(v) for k, v in blocks.items()},
        long_only=long_only, premixed=premixed, exact=True)
    assert mp.shape == (B, 6, fmt.nch_out, 256)
    _same(mp.numpy(), jp, "pcm")
    _same(md.numpy(), jd, "delay")
    np.testing.assert_array_equal(mm.numpy(), np.asarray(jm))


@pytest.mark.parametrize("branch", ["reduce_lfe", "pass_premixed"])
def test_steady_pipeline_exact_matches_jax(jax_exact_callback, branch):
    """steady_pipeline(fmt, long_only, premixed, exact=True), one stream
    with short blocks, equals JAX's by value (JAX's lru_cache is passed
    by, so its program is built with the split routed as above)."""
    spec, premixed = BRANCHES[branch]
    jfmt, fmt = JD.StreamFormat(*spec), PD.StreamFormat(*spec)
    rng = np.random.default_rng(33)
    blocks = _steady_blocks(fmt, premixed, False, rng, B=1, n=6)
    blocks["bias"] = rng.standard_normal((1, 6)).astype(np.float32)
    one = {k: v[0] for k, v in blocks.items()}
    delay = (rng.standard_normal((6, 128)) * 0.05).astype(np.float32)
    (jd, jm), jp = JD.steady_pipeline.__wrapped__(jfmt, False, premixed,
                                                  True)(
        (jnp.asarray(delay), jnp.asarray(True)), one)
    (md, mm), mp = PD.steady_pipeline(fmt, False, premixed, True)(
        (torch.from_numpy(delay), torch.tensor(True)), one)
    assert mp.shape == (6, fmt.nch_out, 256)
    _same(mp.numpy(), jp, "pcm")
    _same(md.numpy(), jd, "delay")
    assert bool(mm) == bool(jm)


# the shared-memory layouts of csrc/imdct_exact.cu (B1 and B1F), as its
# source writes them
LAYOUTS = {
    "XS": ("i ^ ((i >> 5) & 7)", lambda i: i ^ ((i >> 5) & 7), 256),
    "CS": ("i ^ (((i >> 4) & 7) << 2)", lambda i: i ^ (((i >> 4) & 7) << 2),
           128),
    "DS": ("i ^ ((i >> 5) & 1)", lambda i: i ^ ((i >> 5) & 1), 128),
}


def _wavefronts(words, width=1):
    """Shared-memory wavefronts of one warp instruction: words[lane] is the
    first 4-byte word a lane touches (None: inactive), width its words;
    a 4/8/16-byte access is served in groups of 32/16/8 lanes, each group
    taking as many wavefronts as the most distinct words in one bank."""
    group = {1: 32, 2: 16, 4: 8}[width]
    total = 0
    for g in range(0, 32, group):
        banks = {}
        for w in words[g:g + group]:
            for k in range(width if w is not None else 0):
                banks.setdefault((w + k) % 32, set()).add(w + k)
        total += max(map(len, banks.values()), default=0)
    return total


def test_shared_layouts_are_conflict_free():
    """The kernel's three layouts are bijections, and every warp
    instruction of the transform's schedule that they serve takes the
    fewest wavefronts its width allows: the fftorder gathers of the
    pre-twiddles, the leaves' float4 loads, each pass level's butterfly
    loads, the post-twiddles' z and d writes and B1F's epilogue reads."""
    src = open(PE.__file__.replace("ops/imdct_exact.py",
                                   "csrc/imdct_exact.cu")).read()
    for name, (expr, f, size) in LAYOUTS.items():
        assert f"{name}(int i) {{ return {expr}; }}" in src, name
        assert sorted(map(f, range(size))) == list(range(size)), name
    XS, CS, DS = (LAYOUTS[k][1] for k in ("XS", "CS", "DS"))
    order = np.asarray(PT.imdct_twiddles()["fftorder"], int)
    lanes = np.arange(32)
    one = lambda idx, f: _wavefronts([f(int(i)) for i in idx]) == 1
    for it in range(4):                                     # long pre-twiddle
        o = order[32 * it + lanes]
        assert one(o, XS) and one(255 - o, XS)
        assert one(32 * it + lanes, CS)
    for it in range(2):                                     # short
        k = order[32 * it + lanes]
        for idx in (k, 254 - k, k + 1, 255 - k):
            assert one(idx, XS)
        assert one(32 * it + lanes, CS) and one(64 + 32 * it + lanes, CS)
    sched = src[src.index("int SCHED[SCHED_SIZE] = {"):]
    sched = [eval(v.strip()) for v in
             sched[sched.index("{") + 1:sched.index("}")].split(",")]
    assert len(sched) == 59
    for leaves in (sched[:21], sched[21:43]):        # long, short; by lane
        for kind, steps in ((0x100, (0, 4)), (0, (0,))):
            offs = [e & 0xff if e & 0x100 == kind else None for e in leaves]
            active = [o for o in offs if o is not None]
            for step in steps:
                assert all(CS(o + step) + j == CS(o + step + j)
                           for o in active for j in range(4))
                words = [None if o is None else CS(o + step) for o in offs]
                groups = {lane // 8 for lane, o in enumerate(offs)
                          if o is not None}
                assert _wavefronts(words + [None] * (32 - len(words)),
                                   4) == len(groups), (kind, step)
    for nodes, n in (([0, 32, 48, 64, 96], 4), ([0, 64, 96], 8), ([0], 16),
                     ([0], 32), ([0, 32, 48, 64, 96, 112], 4), ([0, 64], 8),
                     ([0, 64], 16)):
        slots = [(a, k) for a in nodes for k in range(n)]
        for q in range(4):
            assert one([a + k + q * n for a, k in slots], CS), (nodes, n, q)
    for fn in (lambda i: 255 - 2 * i, lambda i: 2 * i, lambda i: 2 * i + 1,
               lambda i: 254 - 2 * i, lambda i: 128 + 2 * i,
               lambda i: 127 - 2 * i, lambda i: 129 + 2 * i,
               lambda i: 126 - 2 * i):
        for it in range(2):
            assert one(fn(32 * it + lanes), XS)
    for fn in (lambda i: 2 * i, lambda i: 2 * i + 1, lambda i: 127 - 2 * i,
               lambda i: 126 - 2 * i):
        assert one(fn(lanes), DS)
    for k in range(8):                                      # B1F epilogue
        assert one(lanes + 32 * k, XS)
        assert one(lanes + 32 * k if k < 4 else 255 - lanes - 32 * k, DS)
