"""Port: the encoder's exponent stage (ops.exponents, kernel X1) on the CPU,
bitwise against the JAX package.

  * exponents_ref (what exponents runs on CPU tensors) from the port's
    window + MDCT of crafted PCM (silence, noise, tones, tiny signals and
    full-scale squares a block, so that every strategy, run pattern and
    overrange case occurs) equals the fields of JAX's frame core
    (ac3acm_tpu/models/encoder.py:_frame_core) in strat and enc_exp & 0xFF,
    and its exp_bits the count of JAX's _encode_exp_static bits under
    JAX's strat.  The port runs 1 to 6 channels; JAX's core runs the same
    PCM as 5 full-band channels and as 5.1 (two compiles), and the port's
    channels are held to the leading ones (the stage is per channel but
    for exp_bits, which is counted over the port's channels).
  * On chip_smoke.py's crafted rows (x1_case, the rows it holds X1 to on
    the card: every new-block pattern, diff sums of exactly 1000 and 1001,
    dead bins 223-228 below the live ones, all-zero blocks, overranging
    coefficients, |c| near 2^17 and 2^31) the raw exponents and the zeroed
    coefficients equal JAX's ops/mdct.py:extract_exponents, and strat and
    enc_exp & 0xFF those of JAX's frame core run on the crafted
    coefficients in place of its MDCT's (a full-band channel in a slot of
    the 5-channel config, the LFE in 5.1's), exp_bits JAX's count.
  * kernel_model replays csrc/exponents.cu's order (raw exponents and
    warp sums, the strategy from each channel's bitmask of new blocks, the
    fold a bin into the run's first block, a warp's scan entries computed
    a lane a group into an int16 row, read back 8 consecutive a lane, the
    shuffle scans, the 16-byte fan-out, half a warp a block of the run) in
    numpy: it must give exponents_ref's bytes, so the kernel's
    decomposition is checked here, where the kernel cannot run.
  * enc_exp's int8 holds on extreme coefficients; the wrapper refuses what
    the kernel does not take, a CPU tensor never reaches the CUDA build,
    and a frame core calls the stage once.
"""
from functools import lru_cache

import jax
import numpy as np
import pytest
import torch

import chip_smoke as CS
from ac3acm_tpu.models import encoder as JE
from ac3acm_tpu.ops import mdct as JM
from ac3acm_tpu_torch.models import encoder as PE
from ac3acm_tpu_torch.ops import _cuda
from ac3acm_tpu_torch.ops import exponents as EX
from ac3acm_tpu_torch.ops import mdct as PM

LANES = 96
BIG = 1 << 20


def _pcm(seed, lanes=LANES, nch=6):
    """(cur, prev) [lanes, 6, nch, 256] int32 of 7 sample blocks a lane and
    channel, each silence, loud or tiny noise, a loud or tiny tone at one
    of four frequencies, a tone with noise, or a full-scale square."""
    rng = np.random.default_rng(seed)
    shape = (lanes, 7, nch, 256)
    kind = rng.integers(0, 8, shape[:3])[..., None]
    t = np.arange(7 * 256).reshape(7, 256)[None, :, None, :]
    noise = rng.standard_normal(shape)
    f = rng.choice([0.003, 0.02, 0.11, 0.37], shape[:3])[..., None]
    tone = np.sin(2 * np.pi * f * t + rng.uniform(0, 6, shape[:3])[..., None])
    square = np.broadcast_to(np.where((t // 37) % 2 == 0, 32767.0, -32768.0),
                             shape)
    x = np.select([kind == k for k in range(7)],
                  [0 * noise, 9000 * noise, 20000 * tone, 3 * tone,
                   2 * noise, square, 20000 * tone + 300 * noise],
                  1500 * tone + 40 * noise)
    x = np.clip(np.round(x), -32768, 32767).astype(np.int32)
    return x[:, 1:], x[:, :6]


@lru_cache(maxsize=None)
def _jax_fields(nch):
    """strat and enc_exp of JAX's frame core on _pcm(nch), numpy."""
    cfg = JE.make_config(48000, 448000, nch)
    core = JE._frame_core(cfg)
    fn = jax.jit(lambda c, p: {k: core(c, p)[k] for k in ("strat",
                                                          "enc_exp")})
    cur, prev = (np.ascontiguousarray(x[:, :, :nch]) for x in _pcm(40 + nch))
    return {k: np.asarray(v) for k, v in fn(cur, prev).items()}


def _port(nch, lfe, source):
    """exponents_ref on the port's window + MDCT of the first nch channels
    of _pcm(source): -> (enc_exp, strat, exp_bits, coef before, after)."""
    cur, prev = _pcm(40 + source)
    sel = list(range(nch - int(lfe))) + [5] * int(lfe)
    cur = torch.from_numpy(np.ascontiguousarray(cur[:, :, sel]))
    prev = torch.from_numpy(np.ascontiguousarray(prev[:, :, sel]))
    w, _, es = PM.window_norm_block(prev, cur)
    coef = PM.mdct512(w)
    before = coef.clone()
    out = EX.exponents(coef, es, 223, lfe)
    return out + (before, coef)


def _jax_bits(strat, lfe):
    """exp_bits from JAX's _encode_exp_static bit counts under strat."""
    nbits = {s: JE._encode_exp_static(np.zeros((1, 256), np.int32), 223,
                                      g)[1] for s, g in ((1, 1), (2, 2),
                                                         (3, 4))}
    lfe_bits = JE._encode_exp_static(np.zeros((1, 256), np.int32), 7, 1)[1]
    fbw = strat[..., :strat.shape[-1] - int(lfe)]
    bits = sum(np.sum(fbw == s, axis=(1, 2)) * n for s, n in nbits.items())
    if lfe:
        bits = bits + np.sum(strat[..., -1] == 1, axis=1) * lfe_bits
    return bits


@pytest.mark.parametrize("nch,lfe", [(n, False) for n in range(1, 6)]
                         + [(1, True), (3, True), (6, True)])
def test_frame_core_exponents_match_jax(nch, lfe):
    """strat and enc_exp & 0xFF equal JAX's frame core's on the leading
    channels (the LFE JAX's channel 5), exp_bits JAX's count."""
    enc, strat, bits, _, _ = _port(nch, lfe, 6 if lfe else 5)
    want = _jax_fields(6 if lfe else 5)
    sel = list(range(nch - int(lfe))) + [5] * int(lfe)
    assert enc.dtype == torch.int8
    assert np.array_equal(enc.view(torch.uint8).numpy(),
                          want["enc_exp"][:, :, sel])
    assert np.array_equal(strat.numpy(), want["strat"][:, :, sel])
    assert np.array_equal(bits.numpy(),
                          _jax_bits(want["strat"][:, :, sel], lfe))


def test_crafted_pcm_reaches_every_case():
    """The PCM of the test above makes every strategy, every new-block
    pattern of blocks 1-5 (over the layouts), the LFE's two codes and
    overranging coefficients."""
    pats, codes = set(), set()
    for nch, lfe in ((5, False), (6, True)):
        enc, strat, _, before, after = _port(nch, lfe, nch)
        s = strat.numpy()
        pats |= CS.x1_patterns(s, lfe)
        codes |= set(np.unique(s[..., :5]).tolist())
        if lfe:
            assert set(np.unique(s[..., 5]).tolist()) == {0, 1}
        assert int((before != after).sum()) > 0, "no coefficient overranged"
    assert pats == set(range(32)) and codes == {0, 1, 2, 3}, (pats, codes)


def _raw_model(coef, es):
    """The kernel's raw exponents (unsigned |c|, 31 - clz) and zeroing."""
    v = np.abs(coef.astype(np.int64))
    log2 = np.where(v > 0, np.frexp(np.maximum(v, 1).astype(np.float64))[1]
                    - 1, 0)
    e = np.where(v == 0, 24, 23 - log2 + es[..., None])
    over = (v != 0) & (e >= 24)
    return np.minimum(e, 24), np.where(over, 0, coef)


@pytest.mark.parametrize("layout", CS.X1_LAYOUTS, ids=str)
def test_raw_exponents_match_jax(layout):
    """On the crafted rows: the raw exponents (the kernel model's first
    step) and exponents_ref's zeroed coefficients equal JAX's
    extract_exponents."""
    coef, es, nb, lfe = _case(layout)
    je, jc = jax.jit(JM.extract_exponents)(coef, es)
    raw, zeroed = _raw_model(coef, es)
    assert np.array_equal(raw, np.asarray(je))
    assert np.array_equal(zeroed, np.asarray(jc))
    work = torch.from_numpy(coef.copy())
    EX.exponents_ref(work, torch.from_numpy(es), nb, lfe)
    assert np.array_equal(work.numpy(), np.asarray(jc))


@lru_cache(maxsize=None)
def _jax_crafted():
    """JAX's frame core on every layout's crafted rows, its window and
    MDCT bypassed (window_norm_block hands on the coefficients and
    exp_samples as given): -> {layout: (enc_exp uint8, strat)}, numpy.
    Every full-band channel runs in a slot of the 5-channel config, every
    LFE in slot 5 of 5.1 (the other slots silent), in one call a config:
    the stage is per channel."""
    cols = {5: [], 6: []}              # (config, slot) of each column
    for layout in CS.X1_LAYOUTS:
        coef, es, _, lfe = _case(layout)
        nf = layout[0] - int(lfe)
        for c in range(layout[0]):
            cfg = 6 if lfe else 5
            if c < nf and nf > 5:                    # (6, False): 2 rows
                cols[5].append((layout, c, c // 5, c % 5))
            elif c < nf:
                cols[cfg].append((layout, c, 0, c))
            else:
                cols[6].append((layout, c, 0, 5))
    out = {layout: [None, None] for layout in CS.X1_LAYOUTS}
    wnb, mdct = JE.window_norm_block, JE.mdct512
    try:
        JE.window_norm_block = lambda prev, cur: (cur, None, prev)
        JE.mdct512 = lambda w: w
        for nch, where in cols.items():
            # one row block of R rows a (layout, block of channels)
            blocks = sorted({(lay, blk) for lay, _, blk, _ in where},
                            key=lambda x: (CS.X1_LAYOUTS.index(x[0]), x[1]))
            R = _case(CS.X1_LAYOUTS[0])[0].shape[0]
            coef = np.zeros((len(blocks) * R, 6, nch, 256), np.int32)
            es = np.zeros((len(blocks) * R, 6, nch), np.int32)
            for lay, c, blk, slot in where:
                r0 = blocks.index((lay, blk)) * R
                coef[r0:r0 + R, :, slot] = _case(lay)[0][:, :, c]
                es[r0:r0 + R, :, slot] = _case(lay)[1][:, :, c]
            core = JE._frame_core(JE.make_config(48000, 448000, nch))
            got = jax.jit(lambda c, e: {k: core(c, e)[k] for k in (
                "enc_exp", "strat")})(coef, es)
            got = {k: np.asarray(v) for k, v in got.items()}
            for lay, c, blk, slot in where:
                r0 = blocks.index((lay, blk)) * R
                ent = out[lay]
                if ent[0] is None:
                    ent[0] = np.zeros((R, 6, lay[0], 256), np.uint8)
                    ent[1] = np.zeros((R, 6, lay[0]), np.int32)
                ent[0][:, :, c] = got["enc_exp"][r0:r0 + R, :, slot]
                ent[1][:, :, c] = got["strat"][r0:r0 + R, :, slot]
    finally:
        JE.window_norm_block, JE.mdct512 = wnb, mdct
    return {k: tuple(v) for k, v in out.items()}


@pytest.mark.parametrize("layout", CS.X1_LAYOUTS, ids=str)
def test_crafted_rows_match_jax_frame_core(layout):
    """On the crafted rows (the 1000 / 1001 sums, the low dead bins
    223-228, all 32 run patterns in every full-band channel): exponents_ref's
    strat and enc_exp & 0xFF equal JAX's frame core's, and its exp_bits
    JAX's count under JAX's strat."""
    coef, es, nb, lfe = _case(layout)
    enc, strat, bits = EX.exponents_ref(torch.from_numpy(coef.copy()),
                                        torch.from_numpy(es), nb, lfe)
    want_enc, want_strat = _jax_crafted()[layout]
    assert np.array_equal(strat.numpy(), want_strat)
    assert np.array_equal(enc.view(torch.uint8).numpy(), want_enc)
    assert np.array_equal(bits.numpy(), _jax_bits(want_strat, lfe))
    # the rows reach what they are for: a sum of exactly 1000 (no new
    # block) and of 1001 (a new block), dead bins below the live ones
    raw, _ = _raw_model(coef, es)
    sums = np.abs(np.diff(raw, axis=1)).sum(-1)
    assert (sums == 1000).any() and (sums == 1001).any()
    assert (raw[..., 223:229].min(-1) < raw[..., :223].min(-1)).any()


@lru_cache(maxsize=None)
def _case(layout):
    """x1_case of a layout, as chip_smoke.py seeds it (never written)."""
    return CS.x1_case(*layout, 1600 + CS.X1_LAYOUTS.index(layout))


def kernel_model(coef, es, nb, lfe):
    """csrc/exponents.cu's algorithm in numpy, in its order, over the rows:
    -> (enc_exp int8, strat int32, exp_bits int32, coef zeroed)."""
    N, _, nch, _ = coef.shape
    raw, coef = _raw_model(coef, es)
    fold = raw.astype(np.int8)                   # staged as bytes
    # |diff| sums: a warp's 32 bins, then the CTA
    d = np.abs(np.diff(raw, axis=1))             # [N, 5, ch, 256]
    sums = d.reshape(N, 5, nch, 8, 32).sum(-1).sum(-1)
    sums = np.concatenate([np.zeros((N, 1, nch), np.int64), sums], 1)
    # the strategy: a lane a (block, channel) votes; its channel's 6-bit
    # mask of new blocks gives the run to the next set bit (__ffs)
    vote = (np.arange(6)[None, :, None] == 0) | (sums > 1000)  # [N, 6, ch]
    chmask = (vote.astype(np.int64) << np.arange(6)[None, :, None]).sum(1)
    strat = np.zeros((N, 6, nch), np.int32)
    bits = np.zeros(N, np.int32)
    for b in range(6):
        for c in range(nch):
            is_lfe = lfe and c == nch - 1
            above = chmask[:, c] >> (b + 1)
            low = above & -above                         # the next new block
            run = np.where(above > 0, np.log2(np.maximum(low, 1)).astype(
                np.int64) + 1, 6 - b)
            code = np.where(run == 1, 3, np.where(run <= 3, 2, 1))
            new = vote[:, b, c]
            s = np.where(new, 1 if is_lfe else code, 0)
            strat[:, b, c] = s
            g = np.where(is_lfe, 1, np.where(s == 3, 4, s))
            nbc = 7 if is_lfe else nb
            ng = np.where(s > 0, (nbc + 3 * g - 4) // np.maximum(3 * g, 1)
                          * 3, 0)
            bits += np.where(s > 0, 4 + ng // 3 * 7, 0).astype(np.int32)
    # the run end after each block: the next coded block (6 if none)
    end = np.full((N, 7, nch), 6)
    for b in range(5, -1, -1):
        end[:, b] = np.where(strat[:, b + 1] != 0, b + 1, end[:, b + 1]) \
            if b < 5 else 6
    blocks = np.arange(6)[None, :, None]
    # the fold, each bin's column: a run is a coded block and the reuses
    # after it; its minimum goes to the run's first block only (the one
    # the coding reads)
    live = np.arange(256)[None, :] < np.array(
        [7 if lfe and c == nch - 1 else nb for c in range(nch)])[:, None]
    for b0 in range(6):
        start = strat[:, b0] != 0                          # [N, ch]
        run = (blocks >= b0) & (blocks < end[:, b0][:, None])  # [N, 6, ch]
        m = np.where(run[..., None], fold, 127).min(1)     # [N, ch, 256]
        put = start[..., None] & live
        fold[:, b0] = np.where(put, m, fold[:, b0]).astype(np.int8)
    # the coding: entries a lane a group (lane j: j, j + 32, ...) into an
    # int16 row, a lane's 8 consecutive entries read back, shuffle scans
    # across 32 lanes
    enc = np.zeros((N, 6, nch, 256), np.int8)
    i = np.arange(256).reshape(32, 8)
    k = np.arange(256)
    for b in range(6):
        for c in range(nch):
            is_lfe = lfe and c == nch - 1
            for s in ((1,) if is_lfe else (1, 2, 3)):
                rows = np.nonzero(strat[:, b, c] == s)[0]
                if not len(rows):
                    continue
                lg = 0 if is_lfe else s - 1
                g = 1 << lg
                ngroups = ((7 if is_lfe else nb) + 3 * g - 4) // (3 * g) * 3
                nv = ngroups + 1
                e = fold[rows, b, c].astype(np.int64)      # [R, 256]
                v = np.full((len(rows), 256), BIG)
                v[:, 0] = np.minimum(e[:, 0], 15)
                grp = 1 + np.arange(ngroups)[:, None] * g + np.arange(g)
                v[:, 1:nv] = e[:, grp].min(-1) - 2 * np.arange(1, nv)
                row16 = v[:, :nv].astype(np.int16)           # the int16 row
                assert np.array_equal(row16, v[:, :nv])
                v[:, :nv] = row16
                a = np.minimum.accumulate(v.reshape(-1, 32, 8), axis=2)
                x = np.minimum.accumulate(a[:, :, -1], axis=1)
                before = np.concatenate([np.full((len(rows), 1), BIG),
                                         x[:, :-1]], 1)
                h = np.where(i < nv, np.minimum(before[..., None], a)
                             + 4 * i, BIG)
                a = np.minimum.accumulate(h[:, :, ::-1], axis=2)[:, :, ::-1]
                x = np.minimum.accumulate(a[:, ::-1, 0], axis=1)[:, ::-1]
                after = np.concatenate([x[:, 1:], np.full((len(rows), 1),
                                                          BIG)], 1)
                coded = (np.minimum(after[..., None], a) - 2 * i).reshape(
                    len(rows), 256)
                coded = np.where(i.reshape(256) < nv, coded, 0)
                src = np.clip(1 + ((k - 1) >> lg), 0, nv - 1)
                row = np.where(k == 0, coded[:, :1], np.where(
                    (k >= 1) & (k <= ngroups * g), coded[:, src], 0))
                # 16-byte stores: lanes 0-15 blocks b, b + 2, ..., lanes
                # 16-31 blocks b + 1, b + 3, ... of the run
                for half in (0, 1):
                    for bb in range(b + half, 6, 2):
                        to = end[rows, b, c] > bb
                        for m in range(16):
                            enc[rows[to], bb, c, 16 * m:16 * m + 16] = \
                                row[to, 16 * m:16 * m + 16]
    return enc, strat, bits, coef


@pytest.mark.parametrize("layout", CS.X1_LAYOUTS, ids=str)
def test_kernel_model_matches_plain_version(layout):
    """The model gives exponents_ref's outputs on the crafted rows, whose
    "pattern" rows hold every new-block pattern in every full-band
    channel."""
    coef, es, nb, lfe = _case(layout)
    work = torch.from_numpy(coef.copy())
    want = EX.exponents_ref(work, torch.from_numpy(es), nb, lfe)
    got = kernel_model(coef, es, nb, lfe)
    if layout[0] > layout[1]:
        rows = CS.X1_KINDS[0][1]
        assert CS.x1_patterns(want[1][:rows].numpy(), lfe) == set(range(32))
    for name, g, w in zip(("enc_exp", "strat", "exp_bits", "coef"), got,
                          [t.numpy() for t in want] + [work.numpy()]):
        assert np.array_equal(g, w), name


def test_int8_bound_on_extreme_coefficients():
    """|c| = 2^31 - 1 at exp_samples -9 gives the least raw exponent, -16;
    all-zero blocks 24: the coded exponents span [-16, 24] and the int8
    result equals the int32 chain's."""
    rng = np.random.default_rng(3)
    coef = np.where(rng.random((8, 6, 6, 256)) < 0.5, 2**31 - 1,
                    -(2**31 - 1)).astype(np.int32)
    coef[1::2, ::2] = 0
    coef[2, :, :, 100:] = 1
    es = np.full((8, 6, 6), -9, np.int32)
    es[3] = 5
    work = torch.from_numpy(coef.copy())
    enc, strat, bits = EX.exponents(work, torch.from_numpy(es), 223, True)
    exp, _ = PM.extract_exponents(torch.from_numpy(coef),
                                  torch.from_numpy(es))
    new, strat32 = EX.strategy(exp, True)
    enc32, bits32 = EX.encode_exponents(exp, new, strat32, 223, True)
    assert int(enc32.min()) == -16 and int(enc32.max()) == 24
    assert torch.equal(enc.to(torch.int32), enc32)
    assert torch.equal(strat, strat32) and torch.equal(bits, bits32)


def test_encoder_keeps_the_stage_names():
    """models/encoder.py's _encode_exp_static, _strategy and
    _encode_exponents still give the stage's steps."""
    coef, es, nb, lfe = _case((6, True))
    exp, _ = PM.extract_exponents(torch.from_numpy(coef),
                                  torch.from_numpy(es))
    cfg = PE.make_config(48000, 448000, 6)
    new, strat = PE._strategy(cfg, exp)
    enc, bits = PE._encode_exponents(cfg, exp, new, strat)
    want = EX.exponents_ref(torch.from_numpy(coef.copy()),
                            torch.from_numpy(es), 223, True)
    assert torch.equal(enc.to(torch.int8), want[0])
    assert torch.equal(strat, want[1]) and torch.equal(bits, want[2])
    assert PE._encode_exp_static is EX.encode_exp_static


def _good():
    coef, es, nb, lfe = _case((2, False))
    return [torch.from_numpy(coef[:4].copy()), torch.from_numpy(es[:4]),
            nb, lfe]


def _offset_view(t):
    flat = torch.zeros(t.numel() + 4, dtype=t.dtype)
    return flat[1:1 + t.numel()].view(t.shape)


BAD = {
    "coef int64": (0, lambda t: t.long(), TypeError),
    "exp_samples int16": (1, lambda t: t.to(torch.int16), TypeError),
    "coef strided": (0, lambda t: t.transpose(0, 1).contiguous()
                     .transpose(0, 1), ValueError),
    "coef unaligned": (0, _offset_view, ValueError),
    "coef 255 bins": (0, lambda t: t[..., :255].contiguous(), ValueError),
    "coef 7 channels": (0, lambda t: torch.cat([t] * 4, 2)[:, :, :7]
                        .contiguous(), ValueError),
    "coef 5 blocks": (0, lambda t: t[:, :5].contiguous(), ValueError),
    "exp_samples short": (1, lambda t: t[:1], ValueError),
    "exp_samples on meta": (1, lambda t: t.to("meta"), ValueError),
    "nb 0": (2, lambda n: 0, ValueError),
    "nb 222": (2, lambda n: 222, ValueError),
    "nb 255": (2, lambda n: 255, ValueError),
    "nb 256": (2, lambda n: 256, ValueError),
    "nb float": (2, lambda n: 223.0, ValueError),
    "lfe int": (3, lambda b: 1, TypeError),
}


@pytest.mark.parametrize("bad", sorted(BAD))
def test_wrapper_refuses(bad):
    """The wrapper's checks hold on the CPU as on the card, and no CPU
    call launches the kernel."""
    args = _good()
    i, make, err = BAD[bad]
    args[i] = make(args[i])
    before = EX.launches_exponents
    with pytest.raises(err):
        EX.exponents(*args)
    assert EX.launches_exponents == before == 0


def test_cpu_never_reaches_the_cuda_build(monkeypatch):
    """CPU tensors take the plain version: the CUDA build is never
    touched and the launch count never moves; no rows give empty
    outputs."""
    def refuse(*a, **k):
        raise AssertionError("a CPU call reached the CUDA route")

    monkeypatch.setattr(_cuda, "load", refuse)
    monkeypatch.setattr(_cuda, "build", refuse)
    args = _good()
    want = EX.exponents_ref(args[0].clone(), *args[1:])
    got = EX.exponents(*args)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    none = EX.exponents(args[0][:0], args[1][:0], 223, False)
    assert none[0].shape == (0, 6, 2, 256) and none[2].shape == (0,)
    assert EX.launches_exponents == 0


def test_frame_core_calls_the_stage_once(monkeypatch):
    """frame_core reaches the stage through exponents alone, once, and
    hands its int8 bytes on as uint8 (the same storage)."""
    calls = []
    orig = PE.exponents

    def spy(*a):
        out = orig(*a)
        calls.append(out[0])
        return out

    monkeypatch.setattr(PE, "exponents", spy)
    cfg = PE.make_config(48000, 192000, 2)
    cur, prev = _pcm(9, 4, 2)
    res = PE.frame_core(cfg, torch.from_numpy(cur), torch.from_numpy(prev))
    assert len(calls) == 1
    assert res["enc_exp"].dtype == torch.uint8
    assert res["enc_exp"].data_ptr() == calls[0].data_ptr()
