"""Port: a numpy model of B1QS's design (csrc/imdct_exact.cu:
fixed_chain_kernel) against the plain fixed chain, bitwise.

The kernel splits only the rows the chain reads (a frequency-path row
whose downmix row is all zero splits to 0; a time-path channel without
coefficients keeps its delay and is not split), and its walk is a thread
pair a position k: outputs j = k and 255 - k read fold(d) at k alone, the
mixes combine channels at the same k, and the new delay at k is the row's
d at k (or the delay the block saw), so each pair carries the delay [6]
at its k and downmixed in registers from block to block.  The model
replays exactly that, position by position (as arrays over k, with no
value crossing from one k to another), on the rows' (z, d) as the plain
split gives them, and must equal ops.fixed_chain.fixed_chain_ref (the
eager _block_step loop, held to JAX's fixed_block_pipeline by
tests/test_torch_fixed_chain.py) in PCM, delay and downmixed:

  * the 12 formats chip_smoke.py holds B1QS to: the 5.1 golden's fixed
    parse to its 8 outputs (7 blocks each) and the 4 synthetic formats;
  * n = 0 ... 13 blocks (full-range planes, mixed blksw, channels without
    coefficients, either downmixed state on entry);
  * a 5.1 -> 2.0 switch, the carry crossing the two calls;
  * a time-path format whose channel 4 has no coefficients.
"""
import numpy as np
import pytest
import torch

import chip_smoke as CS
from ac3acm_tpu_torch.models.decoder import StreamFormat
from ac3acm_tpu_torch.ops import fixed_chain as FC
from ac3acm_tpu_torch.ops import imdct_exact as IE

GOLDEN_FLAGS = (2, 10, 1, 3, 4, 6, 5, 7 | 16)
EDGE_FORMATS = (StreamFormat(7, 2, False, 31), StreamFormat(2, 2, True, 0),
                StreamFormat(7, 23, False, 0), StreamFormat(6, 1, True, 1))


def _i32(x):
    """int64 -> the int32 value congruent mod 2^32 (as int64)."""
    return (np.asarray(x, np.int64) + 2 ** 31) % 2 ** 32 - 2 ** 31


def _mul(a, b):
    """FixedOps::mul (native/ac3sample.inc's MUL) on int32 values."""
    a, b = _i32(a), _i32(b)
    tc = _i32((a & 0xffff) * (b >> 16) + (a >> 16) * (b & 0xffff))
    return _i32((tc >> 14) + ((a >> 16) * (b >> 16) << 2))


def walk_model(fmt, carry, blocks):
    """B1QS's algorithm in numpy -> ((delay, downmixed), pcm)."""
    D, cb, U = FC.affine_mixers(fmt.acmod, fmt.output, fmt.slev_zero)
    nf, nfo, lfe = fmt.nfchans, fmt.nf_out, int(fmt.lfe_out)
    dzero = [not D[p].any() for p in range(5)]
    win = np.asarray(IE._tw_on("cpu", "fixed")["window"], np.int64)
    k = np.arange(128)
    j = np.stack([k, 255 - k])                   # the pair's two outputs
    wj, wjr = win[j], win[255 - j]

    def ola(zj, df, shrt, bias):
        m, o = _mul(zj, wj), _mul(df, wjr)
        neg = j < 128 if shrt else j % 2 == 0
        return _i32(np.where(neg, o - m, o + m) + bias)

    dl = np.asarray(carry[0], np.int64).copy()   # [6, 128]: one column a k
    dmx = bool(carry[1])
    n = len(blocks["freq"])
    pcm = np.zeros((n, fmt.nch_out, 256), np.int64)
    for blk in range(n):
        f = np.asarray(blocks["freq"][blk], np.int64)
        bs = np.asarray(blocks["blksw"][blk], bool)
        cz = np.asarray(blocks["coeff"][blk]) == 0.0
        bv = int(blocks["bias"][blk])
        rm = np.asarray(blocks["remat"][blk], bool)
        coef = f[:5].copy()
        if fmt.acmod == 2:                        # the stereo rematrix
            coef[0] = _i32(np.where(rm, f[0] + f[1], f[0]))
            coef[1] = _i32(np.where(rm, f[0] - f[1], f[1]))
        fp = nfo < nf and bool((bs[:nf] == bs[0]).all())
        # the split warps: only the rows the walk reads
        need = [fp and not dzero[r] or not fp and not cz[r]
                for r in range(5)] + [bool(lfe)]
        rows = [r for r in range(6) if need[r]]
        z, d = np.zeros((6, 256), np.int64), np.zeros((6, 128), np.int64)
        if rows:
            x = np.stack([f[5] if r == 5 else _i32(D[r] @ coef) if fp
                          else coef[r] for r in rows])
            sh = [r < 5 and bool(bs[0] if fp else bs[r]) for r in rows]
            zs, ds = IE.split_fb_fixed_ref(
                torch.from_numpy(x.astype(np.int32)), torch.tensor(sh))
            z[rows], d[rows] = zs.numpy(), ds.numpy()
        # the walk: position k's delay as the block sees it
        ds_ = (_i32(D @ dl[:5]) if fp and not dmx else
               _i32(U @ dl[:5]) if not fp and dmx else dl[:5].copy())
        out = pcm[blk]
        if lfe:
            out[0][j] = ola(z[5][j], dl[5], False, bv)
            dl[5] = d[5]
        if fp:
            for p in range(5):
                if p < nfo:
                    out[lfe + p][j] = ola(z[p][j], ds_[p], bool(bs[0]), bv)
                dl[p] = d[p]                      # 0 for an all-zero row
        else:
            tout = np.zeros((5, 2, 128), np.int64)
            for c in range(5):
                tout[c] = bv if cz[c] else ola(
                    z[c][j], ds_[c], bool(bs[c]),
                    0 if (fmt.chanbias >> c) & 1 else bv)
                dl[c] = ds_[c] if cz[c] else d[c]
            for p in range(nfo):
                out[lfe + p][j] = _i32(
                    cb[p] * bv + np.tensordot(D[p], tout, axes=1))
        dmx = fp
    return (dl.astype(np.int32), np.array(dmx)), pcm.astype(np.int32)


def _plain(fmt, carry, blocks):
    (d, m), p = FC.fixed_chain_ref(
        fmt, tuple(torch.as_tensor(x) for x in carry),
        {k: torch.as_tensor(v) for k, v in blocks.items()})
    return (d.numpy(), m.numpy()), p.numpy()


def _same(fmt, carry, blocks):
    (md, mm), mp = walk_model(fmt, carry, blocks)
    (pd, pm), pp = _plain(fmt, carry, blocks)
    np.testing.assert_array_equal(mp, pp)
    np.testing.assert_array_equal(md, pd)
    assert bool(mm) == bool(pm)
    return (md, mm)


def _init():
    return np.zeros((6, 128), np.int32), np.array(True)


def _golden(flags, nframes):
    frames = CS.fixed_frames(CS.GOLDEN, flags, nframes)
    return frames[0][0], {k: np.concatenate([b[k] for _, b in frames])
                          for k in frames[0][1]}


@pytest.mark.parametrize("flags", GOLDEN_FLAGS)
def test_walk_model_golden_outputs(flags):
    """The 5.1 golden's real Q30 blocks to each output the fixed backend
    takes (7 blocks: a ring's worth and more)."""
    fmt, blocks = _golden(flags | 32, 2)
    _same(fmt, _init(), {k: v[:7] for k, v in blocks.items()})


@pytest.mark.parametrize("n", range(14))
def test_walk_model_block_counts(n):
    """n = 0 ... 13 blocks in the 4 synthetic formats (by n), full-range
    planes with mixed blksw and channels without coefficients, downmixed
    True on entry for odd n, False for even."""
    rng = np.random.default_rng(700 + n)
    _same(EDGE_FORMATS[n % 4], CS.b1qs_carry(rng, n % 2 == 1),
          CS.b1qs_blocks(rng, n, "full"))


def test_walk_model_switch_and_zero_channel():
    """A 5.1 -> 2.0 switch (the carry from the first call into the second)
    and a time-path format (5.1 to 3F2R|LFE) whose channel 4 has no
    coefficients in every block, all long."""
    b51 = _golden(CS.FLAGS_51_TO_20, 1)
    st = CS.fixed_frames(CS.STEREO_GOLDEN, CS.FLAGS_51_TO_20, 1)[0]
    _same(st[0], _same(b51[0], _init(), b51[1]), st[1])
    rng = np.random.default_rng(710)
    fmt = StreamFormat(7, 7 | 16, False, 0)
    assert fmt.nf_out >= fmt.nfchans                 # the time path
    blocks = CS.b1qs_blocks(rng, 7, "long")
    assert (blocks["coeff"][:, 4] == 0).all()
    _same(fmt, CS.b1qs_carry(rng, True), blocks)
