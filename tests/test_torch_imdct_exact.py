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
    loads, the post-twiddles' z and d writes and the one-row kernels'
    reads of z and d (B1F's pair accesses:
    test_pair_accesses_are_conflict_free)."""
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
    for k in range(8):                          # B1's and B1Q's z, d out
        assert one(lanes + 32 * k, XS)
        assert k >= 4 or one(lanes + 32 * k, DS)


# ---------------------------------------------------------------------------
# B1F's pair schedule (ops/fused_steady_exact.py:pair_table): a warp
# transforms two rows at once, their leaves and ifft_pass butterflies
# dealt to lanes from the table.  A numpy replay of the kernel's pair
# transform (and of the one-row code that mixed pairs take) against the
# plain split and JAX's, and a decoding of the table.

from ac3acm_tpu_torch.ops import fused_steady_exact as FE  # noqa: E402

_F = np.float32


def _finish(a, t1, t2, t3, t4):
    """csrc/imdct_exact.cu finish: a = [a0r, a0i, a1r, a1i, a2r, a2i, a3r,
    a3i] -> the butterfly's outputs in the inputs' slots."""
    b0r, b0i, b1r, b1i = a[0], a[1], a[2], a[3]
    return [b0r + t1, b0i + t2, b1r + t3, b1i + t4, b0r - t1, b0i - t2,
            b1r - t3, b1i - t4]


def _bf_zero(a):
    return _finish(a, a[4] + a[6], a[5] + a[7], a[5] - a[7], a[6] - a[4])


def _bf_half(a, w):
    t5, t6 = (a[4] + a[5]) * w, (a[5] - a[4]) * w
    t7, t8 = (a[6] - a[7]) * w, (a[7] + a[6]) * w
    return _finish(a, t5 + t7, t6 + t8, t6 - t8, t7 - t5)


def _bf(a, wr, wi):
    t5 = wi * a[5] + wr * a[4]
    t6 = wr * a[5] - wi * a[4]
    t8 = wi * a[6] + wr * a[7]
    t7 = wr * a[6] - wi * a[7]
    return _finish(a, t5 + t7, t6 + t8, t6 - t8, t7 - t5)


def _ifft4(r, i):
    t1, t2, t3, t4 = r[0] + r[1], r[3] + r[2], i[0] + i[1], i[2] + i[3]
    t5, t6, t7, t8 = r[0] - r[1], i[0] - i[1], i[2] - i[3], r[3] - r[2]
    return ([t1 + t2, t5 + t7, t1 - t2, t5 - t7],
            [t3 + t4, t6 + t8, t3 - t4, t6 - t8])


def _ifft8(r, i, w16):
    r[:4], i[:4] = _ifft4(r[:4], i[:4])
    for s in (4, 6):
        r[s], r[s + 1] = r[s] + r[s + 1], r[s] - r[s + 1]
        i[s], i[s + 1] = i[s] + i[s + 1], i[s] - i[s + 1]
    z = _bf_zero([r[0], i[0], r[2], i[2], r[4], i[4], r[6], i[6]])
    h = _bf_half([r[1], i[1], r[3], i[3], r[5], i[5], r[7], i[7]], w16)
    r[0], i[0], r[2], i[2], r[4], i[4], r[6], i[6] = z
    r[1], i[1], r[3], i[3], r[5], i[5], r[7], i[7] = h
    return r, i


def _pre(x, re, im, kind, word, tw, order):
    """The pre-twiddle of one row into re/im at word(i)."""
    if kind == "long":
        o = order[:128]
        dk, dm = x[o], x[255 - o]
        tr, ti = tw["pre1_r"], tw["pre1_i"]
        at = [word(i) for i in range(128)]
        re[at], im[at] = ti * dm + tr * dk, tr * dm - ti * dk
    else:
        k = order[:64]
        d1a, d1b, d2a, d2b = x[k], x[254 - k], x[k + 1], x[255 - k]
        tr, ti = tw["pre2_r"], tw["pre2_i"]
        a1, a2 = [word(c) for c in range(64)], [word(64 + c)
                                                for c in range(64)]
        re[a1], im[a1] = ti * d1b + tr * d1a, tr * d1b - ti * d1a
        re[a2], im[a2] = ti * d2b + tr * d2a, tr * d2b - ti * d2a


def _post(re, im, kind, word, tw):
    """The post-twiddle of one row from re/im at word(i) -> (z, d)."""
    z, d = np.zeros(256, _F), np.zeros(128, _F)
    if kind == "long":
        i = np.arange(64)
        f, g = [word(v) for v in i], [word(127 - v) for v in i]
        tr, ti = tw["post1_r"], tw["post1_i"]
        a_r, a_i = tr * re[f] + ti * im[f], ti * re[f] - tr * im[f]
        b_r, b_i = ti * re[g] + tr * im[g], tr * re[g] - ti * im[g]
        z[255 - 2 * i], z[2 * i], z[2 * i + 1], z[254 - 2 * i] = \
            a_r, -a_r, b_r, -b_r
        d[2 * i], d[2 * i + 1] = a_i, b_i
    else:
        i = np.arange(32)
        v = [[word(e) for e in idx] for idx in (i, 63 - i, 64 + i, 127 - i)]
        tr, ti = tw["post2_r"], tw["post2_i"]
        b1r, b1i, g1r, g1i = re[v[0]], im[v[0]], re[v[1]], im[v[1]]
        b2r, b2i, g2r, g2i = re[v[2]], im[v[2]], re[v[3]], im[v[3]]
        a_r, a_i = tr * b1r + ti * b1i, ti * b1r - tr * b1i
        b_r, b_i = ti * g1r + tr * g1i, tr * g1r - ti * g1i
        c_r, c_i = tr * b2r + ti * b2i, ti * b2r - tr * b2i
        d_r, d_i = ti * g2r + tr * g2i, tr * g2r - ti * g2i
        z[255 - 2 * i], z[2 * i] = a_r, -a_r
        z[128 + 2 * i], z[127 - 2 * i] = a_i, -a_i
        z[129 + 2 * i], z[126 - 2 * i] = b_r, -b_r
        z[254 - 2 * i], z[2 * i + 1] = b_i, -b_i
        d[127 - 2 * i], d[2 * i], d[2 * i + 1], d[126 - 2 * i] = \
            c_r, c_i, d_r, d_i
    return z, d


def _leaf(re, im, w0, w4, ifft8, w16):
    if ifft8:
        at = list(range(w0, w0 + 4)) + list(range(w4, w4 + 4))
        r, i = _ifft8(list(re[at]), list(im[at]), w16)
    else:
        at = list(range(w0, w0 + 4))
        r, i = _ifft4(list(re[at]), list(im[at]))
    re[at], im[at] = r, i


def _butterfly(re, im, p, wr=None, wi=None):
    a = [v for q in p for v in (re[q], im[q])]
    out = _bf_zero(a) if wr is None else _bf(a, wr, wi)
    for m, q in enumerate(p):
        re[q], im[q] = out[2 * m], out[2 * m + 1]


def _split_pair(xa, xb, kind, tw, order, pt):
    """The kernel's pair_rows on two rows of one kind, from the table."""
    re, im = np.zeros(256, _F), np.zeros(256, _F)
    for r, x in ((0, xa), (1, xb)):
        _pre(x, re, im, kind, lambda i, r=r: FE.pair_word(r, i), tw, order)
    kk = ("long", "short").index(kind)
    w16 = tw["roots16"][1]
    for ph in (0, 1):                               # ifft8s, then ifft4s
        for e in pt[FE.PT_LEAF + (2 * kk + ph) * 32:][:32]:
            if e >= 0:
                _leaf(re, im, e & 0xffff, e >> 16, ph == 0, w16)
    rounds = pt[FE.PT_PASS:].reshape(-1, 32, 4)
    first = 0 if kind == "long" else sum(FE.PAIR_ROUNDS["long"])
    for rd in rounds[first:first + sum(FE.PAIR_ROUNDS[kind])]:
        for a01, a23, wr, wi in rd:
            if a01 >= 0:
                p = (a01 & 0xffff, a01 >> 16, a23 & 0xffff, a23 >> 16)
                w = np.array([wr, wi], np.int32).view(_F)
                _butterfly(re, im, p, *((None, None) if wr == wi == 0
                                        else w))
    return [_post(re, im, kind, lambda i, r=r: FE.pair_word(r, i), tw)
            for r in (0, 1)]


def _split_one(x, kind, tw, order):
    """The one-row code (long_row / short_row) on one row, from the
    source's schedule."""
    re, im = np.zeros(128, _F), np.zeros(128, _F)
    cs = LAYOUTS["CS"][1]
    _pre(x, re, im, kind, cs, tw, order)
    w16 = tw["roots16"][1]
    for e in FE.LEAVES[kind]:
        o = e & 0xff
        _leaf(re, im, cs(o), cs(o + 4), bool(e & 0x100), w16)
    for offs, n, roots in FE.LEVELS[kind]:
        for a in offs:
            for k in range(n):
                p = [cs(a + k + m * n) for m in range(4)]
                _butterfly(re, im, p, *((None, None) if k == 0 else
                                        (tw[roots][k - 1],
                                         tw[roots][n - 1 - k])))
    return _post(re, im, kind, cs, tw)


@pytest.mark.parametrize("kinds", [("long", "long"), ("short", "short"),
                                   ("long", "short"), ("short", "long")])
def test_pair_replay_matches_plain_split(jax_split, kinds):
    """The kernel's pair transform (both rows of one kind, from the pair
    table) and the one-row code a mixed pair takes, replayed in numpy
    float32 with the kernel's operations, give the plain split's z and d
    and JAX's by value, row by row."""
    tw = {k: np.asarray(v, _F) for k, v in PT.imdct_twiddles().items()
          if k != "fftorder"}
    order = np.asarray(PT.imdct_twiddles()["fftorder"], int)
    pt = FE.pair_table()
    x = _rows(40 + len(kinds[0]) + 3 * len(kinds[1]), 12)
    blk = np.array([kinds[i % 2] == "short" for i in range(len(x))])
    zr, dr = PE.split_fb_exact_ref(torch.from_numpy(x), torch.from_numpy(blk))
    zj, dj = jax_split(x, blk)
    for a in range(0, len(x), 2):
        if kinds[0] == kinds[1]:
            got = _split_pair(x[a], x[a + 1], kinds[0], tw, order, pt)
        else:
            got = [_split_one(x[a + r], kinds[r], tw, order) for r in (0, 1)]
        for r in (0, 1):
            _same(got[r][0], zr[a + r].numpy(), (kinds, a + r, "z"))
            _same(got[r][1], dr[a + r].numpy(), (kinds, a + r, "d"))
            _same(got[r][0], zj[a + r], (kinds, a + r, "z, JAX"))
            _same(got[r][1], dj[a + r], (kinds, a + r, "d, JAX"))


def _word_of():
    """word -> (row, IFFT value) of a pair's re/im buffers."""
    return {FE.pair_word(r, i): (r, i) for r in (0, 1) for i in range(128)}


@pytest.mark.parametrize("kind", ["long", "short"])
def test_pair_schedule_covers_every_butterfly(kind):
    """Every leaf and every ifft_pass butterfly of both rows of a pair is in
    the table once, in its level's rounds and in level order, with its
    twiddles; the leaves and the source's schedule agree; row B's layout
    is the kernel's; the table is laid out as the kernel reads it."""
    src = open(PE.__file__.replace("ops/imdct_exact.py",
                                   "csrc/imdct_exact.cu")).read()
    assert f"constexpr int PAIR_XOR = {FE.PAIR_XOR};" in src
    assert (f"PT_LEAF = {FE.PT_LEAF}, PT_PASS = {FE.PT_PASS}, PT_ROUNDS = "
            f"{sum(sum(r) for r in FE.PAIR_ROUNDS.values())}") in src
    sched = src[src.index("int SCHED[SCHED_SIZE] = {"):]
    sched = [eval(v.strip()) for v in
             sched[sched.index("{") + 1:sched.index("}")].split(",")]
    assert tuple(sched[:21]) == FE.LEAVES["long"]
    assert tuple(sched[21:43]) == FE.LEAVES["short"]
    for offs, (key, n) in zip((sched[43:48], sched[48:51], sched[51:57],
                               sched[57:59]),
                              ((("long", 0), 4), (("long", 1), 8),
                               (("short", 0), 4), (("short", 1), 8))):
        assert tuple(offs[:len(FE.LEVELS[key[0]][key[1]][0])]) == \
            FE.LEVELS[key[0]][key[1]][0], key
    words = _word_of()
    assert len(words) == 256
    tw = PT.imdct_twiddles()
    pt = FE.pair_table()
    assert pt.shape == (FE.PT_SIZE,) and pt.dtype == np.int32
    kk = ("long", "short").index(kind)
    for ph, flag in enumerate((0x100, 0)):
        got = []
        for e in pt[FE.PT_LEAF + (2 * kk + ph) * 32:][:32]:
            if e >= 0:
                r, o = words[e & 0xffff]
                if flag:
                    assert words[e >> 16] == (r, o + 4)
                got.append((r, o))
        want = [(r, e & 0xff) for r in (0, 1) for e in FE.LEAVES[kind]
                if e & 0x100 == flag]
        assert sorted(got) == sorted(want), (kind, ph)
    rounds = pt[FE.PT_PASS:].reshape(-1, 32, 4)
    r = 0 if kind == "long" else sum(FE.PAIR_ROUNDS["long"])
    for (offs, n, roots), nr in zip(FE.LEVELS[kind], FE.PAIR_ROUNDS[kind]):
        got = []
        for rd in rounds[r:r + nr]:
            for a01, a23, wr, wi in rd:
                if a01 < 0:
                    assert (a01, a23, wr, wi) == (-1, -1, 0, 0)
                    continue
                q = [words[a01 & 0xffff], words[a01 >> 16],
                     words[a23 & 0xffff], words[a23 >> 16]]
                row, q0 = q[0]
                node = max(a for a in offs if a <= q0)
                k = q0 - node
                assert q == [(row, q0 + m * n) for m in range(4)]
                w = np.asarray(tw[roots], np.float32).view(np.int32)
                assert (wr, wi) == ((0, 0) if k == 0 else
                                    (w[k - 1], w[n - 1 - k]))
                got.append((row, node, k))
        want = [(row, a, k) for row in (0, 1) for a in offs
                for k in range(n)]
        assert sorted(got) == sorted(want), (kind, n)
        r += nr


def test_pair_accesses_are_conflict_free():
    """B1F's pair transform and epilogue and B1QS's walk take the fewest
    wavefronts their widths allow: each packed round's four loads (and
    stores) over 32 banks, the packed leaves' float4 accesses one a group
    of 8 lanes, row B's pre- and post-twiddle accesses at CB, the
    epilogue's 8-byte reads of z (XS), the previous d (DS) and the window,
    and B1QS's walk reading z at XS(j) (j = k or 255 - k) and d at DS(k)."""
    XS, CS, DS = (LAYOUTS[k][1] for k in ("XS", "CS", "DS"))
    CB = lambda i: FE.pair_word(1, i)
    lanes = np.arange(32)
    pt = FE.pair_table()
    one = lambda idx, f: _wavefronts([f(int(i)) for i in idx]) == 1
    for rd in pt[FE.PT_PASS:].reshape(-1, 32, 4):
        for half, sh in ((0, 0), (0, 16), (1, 0), (1, 16)):
            words = [None if a < 0 else (a >> sh) & 0xffff
                     for a in rd[:, half]]
            assert _wavefronts(words) == 1, rd
    for base in range(0, 128, 32):
        entries = pt[FE.PT_LEAF + base:][:32]
        groups = {lane // 8 for lane in range(32) if entries[lane] >= 0}
        for sh in ((0, 16) if base in (0, 64) else (0,)):
            words = [None if e < 0 else (e >> sh) & 0xffff for e in entries]
            assert _wavefronts(words, 4) == len(groups), (base, sh)
    for it in range(4):                                   # row B's writes
        assert one(32 * it + lanes, CB)
    for it in range(2):
        assert one(32 * it + lanes, CB) and one(64 + 32 * it + lanes, CB)
        i = 32 * it + lanes
        assert one(i, CB) and one(127 - i, CB)
    for idx in (lanes, 63 - lanes, 64 + lanes, 127 - lanes):
        assert one(idx, CB)
    for k in range(4):                                    # B1F epilogue
        j = 2 * lanes + 64 * k
        assert _wavefronts([int(w) for w in j ^ (2 * k)], 2) == 2
        # the pair at j ^ 2k holds z[j] and z[j + 1], swapped for h = 1
        for lane in range(32):
            h, w = lane >> 4, int(j[lane] ^ (2 * k))
            assert {XS(w), XS(w + 1)} == {int(j[lane]), int(j[lane]) + 1}
            assert XS(w) == int(j[lane]) + h
        e = j if k < 2 else 254 - j
        assert _wavefronts([int(w) for w in e], 2) == 2
        for w in e:
            f = (int(w) >> 5) & 1
            assert (DS(int(w)), DS(int(w) + 1)) == (int(w) + f,
                                                    int(w) + 1 - f)
        assert _wavefronts([int(w) for w in j], 2) == 2
        assert _wavefronts([int(w) for w in 254 - j], 2) == 2
    for w in range(8):                                    # B1QS walk
        k = 32 * (w % 4) + lanes
        j = k if w < 4 else 255 - k
        assert one(j, XS) and one(k, DS)
