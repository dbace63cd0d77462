"""Port: the encoder's window, normalize and MDCT (ops.window_mdct, kernel
M1) on the CPU, bitwise against the JAX package.

  * window_mdct_ref (what window_mdct runs on CPU tensors) equals JAX's
    ops/mdct.py:window_norm_block then mdct512, jitted on the CPU, in coef
    and exp_samples, on chip_smoke.py's crafted rows (m1_case, the rows it
    holds M1 to on the card: square waves at +-32767 and -32768, silence,
    impulses at 0, 100 and 255, a DC ladder that reaches every shift, noise
    at four scales, -32768 at x[384] where the rotation negates it) for 1
    to 6 channels and 1, 3 and 17 rows, and on rows of int32 outside
    int16, where the window's products wrap.
  * kernel_model replays csrc/window_mdct.cu's order in numpy (a lane's 16
    samples and int4 window reads, the OR reduce, the int16 shared row as
    8-byte stores, the pre-rotation's bit-reversed stores of packed (re,
    im) int16 pairs, two butterflies a lane a pass, the 16-byte output
    stores): it must give window_mdct_ref's values, so the kernel's
    decomposition is checked here, where the kernel cannot run.
  * The wrapper refuses what the kernel does not take, a CPU tensor never
    reaches the CUDA build, and a frame core calls window_mdct once and no
    eager window, normalize or MDCT step of its own.
"""
import re
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

import chip_smoke as CS
from ac3acm_tpu.ops import mdct as JM
from ac3acm_tpu_torch.models import encoder as PE
from ac3acm_tpu_torch.ops import _cuda
from ac3acm_tpu_torch.ops import mdct as PM
from ac3acm_tpu_torch.ops import window_mdct as WM

CASES = [(nch, rows) for nch in CS.M1_CHANNELS for rows in (1, 3, 17)]


def _case(nch, rows, wide=False):
    return CS.m1_case(nch, rows, 1800 + 10 * nch + rows, wide)


def _jax_all():
    """JAX's window_norm_block + mdct512 on every case's transforms, one
    jitted call over them all: -> {(nch, rows, wide): (coef, exp_samples)}."""
    keys = [(n, r, w) for n, r in CASES for w in (False, True)]
    ins = [_case(*k) for k in keys]
    prev = np.concatenate([p.reshape(-1, 256) for p, _ in ins])
    cur = np.concatenate([c.reshape(-1, 256) for _, c in ins])

    def fn(p, c):
        x, _, es = JM.window_norm_block(p, c)
        return JM.mdct512(x), es

    coef, es = (np.asarray(a) for a in jax.jit(fn)(prev, cur))
    out, at = {}, 0
    for k, (p, _) in zip(keys, ins):
        n = p.size // 256
        out[k] = (coef[at:at + n].reshape(p.shape),
                  es[at:at + n].reshape(p.shape[:3]))
        at += n
    return out


@pytest.fixture(scope="module")
def jax_out():
    return _jax_all()


@pytest.mark.parametrize("wide", [False, True], ids=["int16", "int32"])
@pytest.mark.parametrize("nch,rows", CASES)
def test_plain_version_matches_jax(jax_out, nch, rows, wide):
    """window_mdct (the CPU route, window_mdct_ref) equals JAX's
    window_norm_block + mdct512 bitwise."""
    prev, cur = _case(nch, rows, wide)
    coef, es = WM.window_mdct(torch.from_numpy(prev), torch.from_numpy(cur))
    want_coef, want_es = jax_out[(nch, rows, wide)]
    assert coef.dtype == es.dtype == torch.int32
    assert np.array_equal(coef.numpy(), want_coef)
    assert np.array_equal(es.numpy(), want_es)


def test_edge_rows_reach_their_cases():
    """The edge pairs give every shift 0..14, a silent block, a -32768 in
    the normalized block's back quarter (x[384:], negated by the
    rotation)."""
    e = CS.m1_edges()
    prev = torch.from_numpy(np.ascontiguousarray(e[:, 0]))
    cur = torch.from_numpy(np.ascontiguousarray(e[:, 1]))
    x, v, _ = PM.window_norm_block(prev, cur)
    assert set(v.tolist()) == set(range(15))
    assert bool((x[:, 384:] == -32768).any())
    assert bool((x == 0).all(dim=-1).any())


# ---------------------------------------------------------------- the model

def _w32(a):
    return ((a + (1 << 31)) % (1 << 32)) - (1 << 31)


def _w16(a):
    return ((a + (1 << 15)) % (1 << 16)) - (1 << 15)


def _mul(a, b):
    return _w32(a * b)


def _pack(re, im):
    return (re & 0xFFFF) | ((im & 0xFFFF) << 16)


def _lo16(w):
    return _w16(w & 0xFFFF)


def _hi16(w):
    return _w32(w) >> 16


def kernel_model(prev, cur):
    """csrc/window_mdct.cu's algorithm in numpy, in its order, a warp's 32
    lanes at once over every transform: -> (coef, exp_samples)."""
    shape = prev.shape
    P = prev.reshape(-1, 256).astype(np.int64)
    Cb = cur.reshape(-1, 256).astype(np.int64)
    T = len(P)
    tab = WM.table_numpy().astype(np.int64)
    at = {name: a for name, a, _ in WM.LAYOUT}
    W = tab[at["window"]:at["window"] + 256]
    XC = tab[at["xcos1"]:at["xcos1"] + 128]
    XS = tab[at["xsin1"]:at["xsin1"] + 128]
    COS = tab[at["costab"]:at["costab"] + 64]
    SIN = tab[at["sintab"]:at["sintab"] + 64]
    lane = np.arange(32)
    # a lane's samples: two int4 loads of each block
    idx = np.stack([4 * lane + (k & 3) + (k >> 2) * 128 for k in range(8)],
                   1)                                 # [32, 8]
    ws = W[idx]
    w4 = W.reshape(64, 4)
    ba, bb = w4[63 - lane], w4[31 - lane]             # [32, 4]
    wr = np.concatenate([ba[:, ::-1], bb[:, ::-1]], 1)
    v = np.concatenate([_w16(_mul(P[:, idx], ws) >> 15),
                        _w16(_mul(Cb[:, idx], wr) >> 15)], 2)  # [T, 32, 16]
    ored = np.bitwise_or.reduce(np.abs(v), axis=2)     # a lane's OR
    ored = np.bitwise_or.reduce(ored, axis=1)          # __reduce_or_sync
    top = np.where(ored > 0, np.frexp(np.maximum(ored, 1))[1] - 1, 0)
    sh = np.clip(14 - top, 0, 14)
    v = _w16(_w32(v << sh[:, None, None]))
    # the int16 shared row, 8-byte stores x2[lane + 32 g] = v[4g .. 4g+3]
    x = np.zeros((T, 512), np.int16)
    for g in range(4):
        for e in range(4):
            x[:, 4 * (lane + 32 * g) + e] = v[:, :, 4 * g + e]
    x = x.astype(np.int64)
    # rotation and pre-rotation: z at bit-reversed positions, packed
    z = np.zeros((T, 128), np.int64)
    for j in range(4):
        i = lane + 32 * j
        r0 = _w16(-x[:, 2 * i + 384]) if j < 2 else x[:, 2 * i - 128]
        r1 = x[:, 383 - 2 * i]
        r2 = x[:, 128 + 2 * i]
        r3 = x[:, 127 - 2 * i] if j < 2 else _w16(-x[:, 639 - 2 * i])
        reA = _w32(r0 - r1) >> 1
        imA = _w32(-_w32(r2 - r3)) >> 1
        nxc, xs = -XC[i], XS[i]
        zre = _w16(_w32(_mul(reA, nxc) - _mul(imA, xs)) >> 15)
        zim = _w16(_w32(_mul(reA, xs) + _mul(nxc, imA)) >> 15)
        rev = np.array([int(f"{k:07b}"[::-1], 2) for k in i])
        z[:, rev] = _pack(zre, zim)
    # the seven passes, butterflies lane and lane + 32
    for s in range(7):
        for h in range(2):
            b = lane + 32 * h
            half = 1 << s
            ll = b & (half - 1)
            p = ((b >> s) << (s + 1)) | ll
            q = p + half
            pre, pim = _lo16(z[:, p]), _hi16(z[:, p])
            qre, qim = _lo16(z[:, q]), _hi16(z[:, q])
            tre, tim = qre.copy(), qim.copy()
            if s == 1:
                one = ll == 1
                tre[:, one], tim[:, one] = qim[:, one], _w32(-qre[:, one])
            elif s >= 2:
                tw = ll != 0
                c = COS[ll << (6 - s)]
                sn = SIN[ll << (6 - s)]
                twre = _w32(_mul(c, qre) + _mul(sn, qim)) >> 15
                twim = _w32(_mul(c, qim) - _mul(sn, qre)) >> 15
                tre[:, tw], tim[:, tw] = twre[:, tw], twim[:, tw]
            z[:, p] = _pack(_w16(_w32(pre + tre) >> 1),
                            _w16(_w32(pim + tim) >> 1))
            z[:, q] = _pack(_w16(_w32(pre - tre) >> 1),
                            _w16(_w32(pim - tim) >> 1))
    # post-rotation: lane writes coef[4m .. 4m + 3], m = lane + 32 h
    out = np.zeros((T, 256), np.int64)
    for h in range(2):
        m = lane + 32 * h
        for k in range(2):
            j = 2 * m + k
            r = 127 - j
            out[:, 4 * m + 2 * k] = _w32(
                _mul(_lo16(z[:, j]), XC[j]) + _mul(XS[j], _hi16(z[:, j]))) >> 15
            out[:, 4 * m + 2 * k + 1] = _w32(
                _mul(_lo16(z[:, r]), XS[r]) - _mul(_hi16(z[:, r]), XC[r])) >> 15
    return (out.reshape(shape).astype(np.int32),
            (sh - 9).reshape(shape[:3]).astype(np.int32))


@pytest.mark.parametrize("wide", [False, True], ids=["int16", "int32"])
@pytest.mark.parametrize("nch", CS.M1_CHANNELS)
def test_kernel_model_matches_plain_version(nch, wide):
    """The model gives window_mdct_ref's coef and exp_samples bitwise on
    the crafted rows (17 rows: every edge pair)."""
    prev, cur = _case(nch, 17, wide)
    want = WM.window_mdct_ref(torch.from_numpy(prev), torch.from_numpy(cur))
    got = kernel_model(prev, cur)
    for name, g, w in zip(("coef", "exp_samples"), got, want):
        assert np.array_equal(g, w.numpy()), name


def test_table_layout_matches_the_kernel_source():
    """The table's offsets are the TAB_* constants of csrc/window_mdct.cu,
    and its values the plain version's window and twiddles."""
    src = (Path(WM.__file__).parent.parent / "csrc" / "window_mdct.cu"
           ).read_text()
    consts = {m.group(1): int(m.group(2)) for m in re.finditer(
        r"constexpr int TAB_(\w+) = (\d+);", src)}
    want = {"WINDOW": 0, "XCOS": 256, "XSIN": 384, "COS": 512, "SIN": 576,
            "INTS": WM.TABLE_INTS}
    assert consts == want
    assert [a for _, a, _ in WM.LAYOUT] == [consts[k] for k in (
        "WINDOW", "XCOS", "XSIN", "COS", "SIN")]
    tab = WM.table_numpy()
    costab, sintab, xcos1, xsin1, _ = PM._twiddles()
    assert np.array_equal(tab[:256], PM._tables_on(torch.device("cpu"))[
        "window"].numpy())
    assert np.array_equal(tab[256:384], xcos1)
    assert np.array_equal(tab[384:512], xsin1)
    assert np.array_equal(tab[512:576], costab)
    assert np.array_equal(tab[576:640], sintab)


# ---------------------------------------------------------------- the wrapper

def _good():
    prev, cur = _case(2, 3)
    return [torch.from_numpy(prev), torch.from_numpy(cur)]


def _offset_view(t):
    flat = torch.zeros(t.numel() + 4, dtype=t.dtype)
    out = flat[1:1 + t.numel()].view(t.shape)
    out.copy_(t)
    return out


BAD = {
    "prev int64": (0, lambda t: t.long(), TypeError),
    "cur int16": (1, lambda t: t.to(torch.int16), TypeError),
    "cur int64": (1, lambda t: t.long(), TypeError),
    "prev int16": (0, lambda t: t.to(torch.int16), TypeError),
    "shapes differ": (1, lambda t: t[:2].contiguous(), ValueError),
    "5 blocks": (0, lambda t: t[:, :5].contiguous(), ValueError),
    "both 5 blocks": (None, lambda t: t[:, :5].contiguous(), ValueError),
    "255 bins": (None, lambda t: t[..., :255].contiguous(), ValueError),
    "7 channels": (None, lambda t: torch.cat([t] * 4, 2)[:, :, :7]
                   .contiguous(), ValueError),
    "cur strided": (1, lambda t: t.transpose(0, 1).contiguous()
                    .transpose(0, 1), ValueError),
    "prev strided": (0, lambda t: t.transpose(2, 3).contiguous()
                     .transpose(2, 3), ValueError),
    "cur unaligned": (1, _offset_view, ValueError),
    "prev on meta": (0, lambda t: t.to("meta"), ValueError),
    "both on meta": (None, lambda t: t.to("meta"), ValueError),
}


@pytest.mark.parametrize("bad", sorted(BAD))
def test_wrapper_refuses(bad):
    """The wrapper's checks hold on the CPU as on the card, and no CPU
    call launches the kernel."""
    args = _good()
    i, make, err = BAD[bad]
    for k in ((0, 1) if i is None else (i,)):
        args[k] = make(args[k])
    before = WM.launches_window_mdct
    with pytest.raises(err):
        WM.window_mdct(*args)
    assert WM.launches_window_mdct == before == 0


def test_cpu_never_reaches_the_cuda_build(monkeypatch):
    """CPU tensors take the plain version: the CUDA build is never touched
    and the launch count never moves; no rows give empty outputs."""
    def refuse(*a, **k):
        raise AssertionError("a CPU call reached the CUDA route")

    monkeypatch.setattr(_cuda, "load", refuse)
    monkeypatch.setattr(_cuda, "build", refuse)
    prev, cur = _good()
    got = WM.window_mdct(prev, cur)
    want = WM.window_mdct_ref(prev, cur)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    coef, es = WM.window_mdct(prev[:0], cur[:0])
    assert coef.shape == (0, 6, 2, 256) and es.shape == (0, 6, 2)
    assert WM.launches_window_mdct == 0


@pytest.fixture
def m1_spy(monkeypatch):
    """Records every window_mdct call frame_core makes (its arguments) and
    counts the eager window, normalize and MDCT calls made inside a frame
    core but outside window_mdct."""
    w = dict(calls=[], eager=0)
    state = dict(core=False, m1=False)
    core, m1 = PE.frame_core, PE.window_mdct

    def core_spy(*a, **k):
        state["core"] = True
        try:
            return core(*a, **k)
        finally:
            state["core"] = False

    def m1_spy_fn(prev, cur):
        w["calls"].append((prev, cur))
        state["m1"] = True
        try:
            return m1(prev, cur)
        finally:
            state["m1"] = False

    def counted(fn):
        def call(*a, **k):
            w["eager"] += state["core"] and not state["m1"]
            return fn(*a, **k)
        return call

    monkeypatch.setattr(PE, "frame_core", core_spy)
    monkeypatch.setattr(PE, "window_mdct", m1_spy_fn)
    for mod, names in ((PM, ("window_norm_block", "mdct512", "_fft128")),
                       (WM, ("window_norm_block", "mdct512"))):
        for name in names:
            monkeypatch.setattr(mod, name, counted(getattr(mod, name)))
    return w


def test_frame_core_calls_window_mdct_once(m1_spy):
    """frame_core reaches the window, normalize and MDCT through
    window_mdct alone, once, and hands its coefficients on."""
    cfg = PE.make_config(48000, 192000, 2)
    prev, cur = _case(2, 4)
    res = PE.frame_core(cfg, torch.from_numpy(cur), torch.from_numpy(prev))
    assert len(m1_spy["calls"]) == 1 and m1_spy["eager"] == 0
    p, c = m1_spy["calls"][0]
    assert np.array_equal(p.numpy(), prev) and np.array_equal(c.numpy(), cur)
    assert torch.equal(res["new_last"], torch.from_numpy(cur[:, 5]))


def test_encode_pipeline_view_goes_through(m1_spy):
    """encode_pipeline hands frame_core the transposed view of its samples
    (_blocks): window_mdct gets it as a contiguous copy of the same values,
    once, and the fields equal a frame core fed contiguous blocks."""
    cfg = PE.make_config(48000, 192000, 2)
    rng = np.random.default_rng(4)
    samples = torch.from_numpy(rng.integers(-20000, 20000, (3, 1536, 2))
                               .astype(np.int16))
    last = torch.from_numpy(rng.integers(-20000, 20000, (3, 2, 256))
                            .astype(np.int32))
    csnr = torch.full((3,), 40, dtype=torch.int32)
    view = PE._blocks(samples, 2)
    assert not view.is_contiguous()
    res = PE.encode_pipeline(cfg)(samples, last, csnr)
    assert len(m1_spy["calls"]) == 1 and m1_spy["eager"] == 0
    p, c = m1_spy["calls"][0]
    assert c.is_contiguous() and p.is_contiguous()
    assert torch.equal(c, view) and torch.equal(p[:, 0], last)
    want = PE.frame_core(cfg, view.contiguous(), p.clone())
    for k, v in want.items():
        if k != "M":
            assert torch.equal(res[k], v), k
    assert torch.equal(res["new_last"], view[:, 5])
