"""Port: the Python host parser (host.bitio, host.alloc, host.parse) vs the
JAX package's, and the port's native single-stream parser vs the port's
Python one.

Every comparison is bitwise: the parsers are pure numpy on both sides,
so the same bytes must give the same planes, side info and parser state
on every frame of a stream (the LFSR dither, the cached bap, eff_deltba
and the frame-boundary deltbae reset all carry across frames).  No JAX
program is compiled here.
"""
import os

import numpy as np
import pytest

import ac3acm_tpu.tables as JT
from ac3acm_tpu.host import alloc as JA
from ac3acm_tpu.host import bitio as JB
from ac3acm_tpu.host import parse as JP
from ac3acm_tpu_torch import tables as T
from ac3acm_tpu_torch.host import alloc as PA
from ac3acm_tpu_torch.host import bitio as PB
from ac3acm_tpu_torch.host import parse as PP
from ac3acm_tpu_torch.host.native import NativeParser
from ac3acm_tpu_torch.models.decoder import _stack_blocks
from tests.streamgen import gen_stream
from tests.test_native import CASES

GOLDEN = os.path.join(os.path.dirname(__file__), "golden")
GOLDENS = sorted(f for f in os.listdir(GOLDEN) if f.endswith(".ac3"))
FLAGS = T.A52_STEREO | T.A52_ADJUST_LEVEL


def _frames(es):
    out, pos = [], 0
    while pos + 7 <= len(es):
        size = PP.syncinfo(es[pos:pos + 7])[0]
        if size == 0:
            pos += 1
            continue
        if pos + size > len(es):
            break
        out.append(es[pos:pos + size])
        pos += size
    return out


def _golden_frames(name):
    return _frames(open(os.path.join(GOLDEN, name), "rb").read())


def _same(a, b, what):
    """Equal values of equal type (numpy arrays: dtype and shape too)."""
    if isinstance(b, np.ndarray) or isinstance(a, np.ndarray):
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape, what
        assert np.array_equal(a, b), what
    else:
        assert type(a) is type(b), (what, type(a), type(b))
        assert a == b or (a != a and b != b), (what, a, b)


def _same_frame(fp, fj, what):
    for k in ("acmod", "lfeon", "output", "nfchans", "bias", "slev"):
        _same(getattr(fp, k), getattr(fj, k), f"{what} {k}")
    assert len(fp.blocks) == len(fj.blocks) == 6
    for i, (bp, bj) in enumerate(zip(fp.blocks, fj.blocks)):
        for k in ("q", "a", "b", "blksw", "coeff", "chanbias", "remat_mask",
                  "lfe_scale"):
            _same(getattr(bp, k), getattr(bj, k), f"{what} block {i} {k}")


def _same_state(sp, sj, what):
    """Every DecoderState field, ChannelBA lists included."""
    vp, vj = vars(sp), vars(sj)
    assert vp.keys() == vj.keys(), what
    for k in vj:
        if k == "dynrng_call":
            continue
        a, b = vp[k], vj[k]
        if isinstance(b, list):
            for i, (x, y) in enumerate(zip(a, b)):
                _same_state(x, y, f"{what} {k}[{i}]")
        elif isinstance(b, JP.ChannelBA):
            _same_state(a, b, f"{what} {k}")
        else:
            _same(a, b, f"{what} {k}")


def _same_rec(rp, rj, what):
    assert rp.keys() == rj.keys(), what
    for k in rj:
        _same(rp[k], rj[k], f"{what} {k}")


# -- bitio and alloc ---------------------------------------------------------

def test_bitio_matches_jax():
    rng = np.random.default_rng(0)
    buf = rng.integers(0, 256, 4096, dtype=np.uint8).tobytes()
    rp, rj = PB.BitReader(buf, 3), JB.BitReader(buf, 3)
    for n in rng.integers(0, 33, 500):
        n = int(n)
        if n and rng.random() < 0.3:
            assert rp.read_signed(n) == rj.read_signed(n)
        else:
            assert rp.read(n) == rj.read(n)
        rp.skip(n % 5)
        rj.skip(n % 5)
        assert rp.pos == rj.pos
    offs = rng.integers(0, 8 * 4096 - 16, 2000)
    widths = rng.integers(0, 17, 2000)
    gp, gj = rp.gather(offs, widths), rj.gather(offs, widths)
    _same(gp, gj, "gather")
    _same(PB.to_signed(gp, widths), JB.to_signed(gj, widths), "to_signed")
    wp, wj = PB.BitWriter(), JB.BitWriter()
    for w, v in zip(rng.integers(0, 25, 300), rng.integers(0, 1 << 30, 300)):
        wp.write(int(w), int(v))
        wj.write(int(w), int(v))
    wp.write_many([3, 7, 0], [5, 100, 1])
    wj.write_many([3, 7, 0], [5, 100, 1])
    assert wp.bit_length == wj.bit_length
    assert wp.flush() == wj.flush()


def test_alloc_matches_jax():
    """bit_allocate over seeded random exponents and parameters (fbw,
    coupling with leaks, LFE, delta bit allocation), and the side-info
    decoders."""
    rng = np.random.default_rng(1)
    for trial in range(60):
        exp = rng.integers(0, 25, 256).astype(np.uint8)
        kind = trial % 3
        if kind == 0:          # fbw
            start, end = 0, int(rng.integers(1, 254))
            kw = {}
        elif kind == 1:        # coupling
            start = int(rng.integers(37, 200))
            end = int(rng.integers(start + 1, 254))
            kw = dict(cplfleak=int(rng.integers(0, 8)),
                      cplsleak=int(rng.integers(0, 8)))
        else:                  # LFE
            start, end = 0, 7
            kw = dict(is_lfe=True)
        if rng.random() < 0.4:
            kw["deltba"] = rng.integers(-4, 5, 50).astype(np.int8)
        halfrate = int(rng.integers(0, 3))
        bai = int(rng.integers(0, 1 << 11))
        side = JA.decode_side_params(bai, halfrate)
        assert side == PA.decode_side_params(bai, halfrate)
        csnr, fsnr = int(rng.integers(0, 64)), int(rng.integers(0, 16))
        snr = JA.decode_snroffset(csnr, fsnr)
        assert snr == PA.decode_snroffset(csnr, fsnr)
        args = (exp, start, end, snr, int(JT.FGAINTAB[trial % 8]))
        common = dict(fscod=int(rng.integers(0, 3)), halfratecod=halfrate,
                      **side, **kw)
        _same(PA.bit_allocate(*args, **common),
              JA.bit_allocate(*args, **common), f"trial {trial}")
    for bai in range(0, 1 << 11, 7):
        for half in range(3):
            assert PA.decode_side_params(bai, half) == \
                JA.decode_side_params(bai, half)


def test_downmix_coeff_matches_jax():
    """Every (acmod, output) pair the negotiation can give, at a few
    levels: the same float32 coefficient vector and chanbias (the MUL_L /
    MUL_C rounding decides the decode path)."""
    levels = [1.0, 2.0, np.float32(0.70710677), np.float32(1.4142135)]
    clevs = [np.float32(v) for v in (JT.LEVEL_3DB, JT.LEVEL_45DB,
                                      JT.LEVEL_6DB)]
    slevs = [np.float32(v) for v in (JT.LEVEL_3DB, JT.LEVEL_6DB, 0.0)]
    seen = 0
    for acmod in range(8):
        for req in list(range(11)) + [T.A52_DOLBY]:
            for adjust in (0, T.A52_ADJUST_LEVEL):
                out, lvl = PP.downmix_init(acmod, req | adjust, 1.0,
                                           clevs[0], slevs[0])
                jout, jlvl = JP.downmix_init(acmod, req | adjust, 1.0,
                                             clevs[0], slevs[0])
                assert (out, lvl) == (jout, jlvl)
                if out < 0:
                    continue
                for level in levels:
                    for c in clevs:
                        for s in slevs:
                            cp, bp = PP.downmix_coeff(acmod, out, level, c, s)
                            cj, bj = JP.downmix_coeff(acmod, out, level, c, s)
                            _same(cp, cj, (acmod, out, level))
                            assert bp == bj
                            seen += 1
    assert seen > 500


# -- A52Parser ---------------------------------------------------------------

def _parse_all(frames, flags, bias=0.0, level=1.0, **kw):
    """Both parsers over a stream -> [(port FrameData, JAX FrameData)],
    the parsers compared field for field after every frame."""
    pp, pj = PP.A52Parser(**kw), JP.A52Parser(**kw)
    out = []
    for i, fb in enumerate(frames):
        fp = pp.decode_frame(fb, flags, level, bias)
        fj = pj.decode_frame(fb, flags, level, bias)
        _same_frame(fp, fj, f"frame {i}")
        _same_state(pp.s, pj.s, f"state after frame {i}")
        if pj.rec is not None:
            assert len(pp.rec) == len(pj.rec) == 6 * (i + 1)
        out.append((fp, fj))
    return pp, pj


@pytest.mark.parametrize("name", GOLDENS)
def test_parser_matches_jax_on_goldens(name):
    """decode_frame on every frame of every golden: each BlockData field
    bitwise, the parser state after every frame; the stereo downmix of
    the golden check and, on the 5.1 streams, the 3F2R|LFE output."""
    frames = _golden_frames(name)
    _parse_all(frames, FLAGS)
    if "51" in name:
        _parse_all(frames[:3], T.A52_3F2R | T.A52_LFE, bias=384.0)


@pytest.mark.parametrize("seed,acmod,lfeon,kw", CASES)
def test_parser_matches_jax_on_generated_streams(seed, acmod, lfeon, kw):
    """tests/streamgen.py's coupling, short-block, delta-bit-allocation
    and zero-SNR streams: decode_frame and the record_raw records of
    every block equal JAX's."""
    es = gen_stream(seed, acmod, lfeon, nframes=4, **kw)
    flags = acmod | (T.A52_LFE if lfeon else 0) | T.A52_ADJUST_LEVEL
    pp, pj = _parse_all(_frames(es), flags, record_raw=True)
    for i, (rp, rj) in enumerate(zip(pp.rec, pj.rec)):
        _same_rec(rp, rj, f"rec {i}")


@pytest.mark.parametrize("name", ["bench_51_448.ac3", "cpl51_hazard.ac3",
                                  "spec_cpl51_hazard.ac3",
                                  "blksw20_hazard.ac3", "stereo_192.ac3"])
def test_sideinfo_only_recs_match_jax(name):
    """sideinfo_only (the raw_py host half) skips the mantissas by a
    width sum: the records, the zero planes and the parser state equal
    JAX's on every block, and the records equal the full parse's."""
    frames = _golden_frames(name)
    pp, pj = _parse_all(frames, FLAGS, sideinfo_only=True)
    full = PP.A52Parser(record_raw=True)
    for fb in frames:
        full.decode_frame(fb, FLAGS, 1.0, 0.0)
    assert len(pp.rec) == len(full.rec) == 6 * len(frames)
    for i, (rp, rj, rf) in enumerate(zip(pp.rec, pj.rec, full.rec)):
        _same_rec(rp, rj, f"rec {i}")
        _same_rec(rp, rf, f"rec {i} vs the full parse")


def test_drc_callback_matches_jax():
    """DecoderState.dynrng_call (a52_dynrng's user hook) remaps the range
    before the level scale, on both sides (on a stream that codes dynrng);
    DRC off gives the level alone."""
    frames = _golden_frames("cpl51_hazard.ac3")
    pp, pj = PP.A52Parser(), JP.A52Parser()
    pp.s.dynrng_call = lambda r: r * np.float32(0.5) + np.float32(0.25)
    pj.s.dynrng_call = lambda r: r * np.float32(0.5) + np.float32(0.25)
    plain = PP.A52Parser()
    moved = False
    for i, fb in enumerate(frames):
        fp = pp.decode_frame(fb, FLAGS, 1.0, 0.0)
        _same_frame(fp, pj.decode_frame(fb, FLAGS, 1.0, 0.0), f"frame {i}")
        moved |= not np.array_equal(
            fp.blocks[0].coeff,
            plain.decode_frame(fb, FLAGS, 1.0, 0.0).blocks[0].coeff)
    assert moved, "the callback never changed a coefficient"
    pp, pj = PP.A52Parser(), JP.A52Parser()
    pp.s.dynrnge = pj.s.dynrnge = False
    for i, fb in enumerate(frames):
        _same_frame(pp.decode_frame(fb, FLAGS, 1.0, 0.0),
                    pj.decode_frame(fb, FLAGS, 1.0, 0.0), f"off {i}")


def test_rejected_frames_match_jax():
    """A frame with damaged side info raises FrameError (or the same
    error) in both parsers, and the next frame parses the same."""
    frames = _golden_frames("bench_51_448.ac3")
    rng = np.random.default_rng(5)
    errors = 0
    pp, pj = PP.A52Parser(), JP.A52Parser()
    for i, fb in enumerate(frames * 3):
        bad = bytearray(fb)
        if i % 3 == 1:
            for k in rng.integers(8, 64, 6):
                bad[k] ^= int(rng.integers(1, 256))
        results = []
        for p in (pp, pj):
            try:
                results.append(p.decode_frame(bytes(bad), FLAGS, 1.0, 0.0))
            except Exception as e:               # noqa: BLE001
                results.append(type(e).__name__)
        if isinstance(results[1], str):
            errors += 1
            assert results[0] == results[1]
        else:
            _same_frame(results[0], results[1], f"frame {i}")
    assert errors >= 1


@pytest.mark.parametrize("seed,acmod,lfeon,kw", CASES)
def test_native_parser_matches_python(seed, acmod, lfeon, kw):
    """The port's NativeParser (the C++ copy) against the port's
    A52Parser on the generated streams: the stacked planes bitwise."""
    es = gen_stream(seed, acmod, lfeon, nframes=4, **kw)
    flags = acmod | (T.A52_LFE if lfeon else 0) | T.A52_ADJUST_LEVEL
    res = NativeParser().decode_frames(es, 4, flags, 1.0, 0.0)
    assert res is not None
    blocks_n, meta = res
    pp = PP.A52Parser()
    blocks_p = _stack_blocks([pp.decode_frame(fb, flags, 1.0, 0.0)
                              for fb in _frames(es)])
    for k in ("freq", "coeff", "bias", "blksw", "remat"):
        np.testing.assert_array_equal(blocks_n[k], blocks_p[k], err_msg=k)
    assert meta["acmod"] == acmod and meta["lfeon"] == int(lfeon)
