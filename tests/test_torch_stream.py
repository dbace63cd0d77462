"""Port: the stream layer (io.stream), the a52 decode API and the config
and logging utilities against the JAX package's.

  * The format model (formats, frame sizes, ACM orders, channel maps,
    suggestions, buffer math) equal to JAX's.
  * Ac3ToPcmStream fed uneven pieces equals the one-shot call in both
    modes; in the default fast mode it tracks JAX's Ac3ToPcmStream (one
    JAX compile) through resync after corruption within 1 int16 LSB (two
    matmul filterbanks); with exact=True its int16 equals the native C++
    decoder's float through the same conversion, bit for bit.
  * The a52 API (on the native decoder, as in JAX) equal to JAX's,
    dynrng callback and negotiated flags included.
"""
import logging
import os

import numpy as np
import pytest

import ac3acm_tpu.a52 as ja52
import ac3acm_tpu.io.stream as JS
import ac3acm_tpu.tables as JT
from ac3acm_tpu.utils.config import CodecConfig as JConfig
import ac3acm_tpu_torch.a52 as a52
import ac3acm_tpu_torch.io.stream as PS
from ac3acm_tpu_torch import tables as T
from ac3acm_tpu_torch.host.native import NativeDecoder
from ac3acm_tpu_torch.utils.config import CodecConfig
from ac3acm_tpu_torch.utils.trace import log as port_log
from tests.streamgen import gen_stream
from tests.test_torch_general_decode import _frames

GOLDEN = os.path.join(os.path.dirname(__file__), "golden")


def _corrupt(es):
    """bench_51_448 with two syncwords clobbered and garbage between
    frames (tests/test_stream.py's damage)."""
    sizes = []
    pos = 0
    while pos < len(es):
        sizes.append(T.frame_size_bytes(es[pos + 4] >> 6, es[pos + 4] & 63))
        pos += sizes[-1]
    bad = bytearray(es)
    off = sum(sizes[:2])
    bad[off] ^= 0xFF
    off5 = sum(sizes[:5])
    bad[off5 + 1] ^= 0x55
    return bytes(bad[:off]) + b"\x0b\x00garbage" + bytes(bad[off:])


def _i16(planes):
    """tests/test_stream.py's float -> interleaved int16 (stereo)."""
    x = np.clip(np.round((planes.astype(np.float64) - 384.0) * 32768.0),
                -32768, 32767)
    return x.transpose(0, 2, 1).reshape(-1, planes.shape[1]).astype(np.int16)


def test_format_model_matches_jax():
    assert PS.SAMPLE_RATES == JS.SAMPLE_RATES
    np.testing.assert_array_equal(PS.FRAMESIZES, JS.FRAMESIZES)
    assert PS.ACM_ORDER == JS.ACM_ORDER
    for n in (1, 2, 3, 4, 5, 6):
        np.testing.assert_array_equal(PS.create_channel_map(n),
                                      JS.create_channel_map(n))
    mine = list(PS.enumerate_ac3_formats())
    ref = list(JS.enumerate_ac3_formats())
    assert len(mine) == len(ref) == 342
    for a, b in zip(mine, ref):
        assert (a.channels, a.sample_rate, a.bitrate) == \
            (b.channels, b.sample_rate, b.bitrate)
        assert (a.block_align, a.avg_bytes_per_sec) == \
            (b.block_align, b.avg_bytes_per_sec)
        for src_is_ac3 in (True, False):
            for q in (True, False):
                for n in (1, 700, a.block_align, 100000):
                    pcm = PS.PcmFormat(a.channels, a.sample_rate)
                    jpcm = JS.PcmFormat(b.channels, b.sample_rate)
                    assert PS.stream_size(src_is_ac3, n, a, pcm, q) == \
                        JS.stream_size(src_is_ac3, n, b, jpcm, q)
    for rate in PS.SAMPLE_RATES:
        for ba in range(60, 3900, 7):
            assert PS.guess_frame_size(block_align=ba, sample_rate=rate) == \
                JS.guess_frame_size(block_align=ba, sample_rate=rate)
            assert PS.guess_frame_size(avg_bytes=ba * 10,
                                       sample_rate=rate) == \
                JS.guess_frame_size(avg_bytes=ba * 10, sample_rate=rate)
    for bad in ((7, 48000, 192), (2, 96000, 192), (2, 48000, 100)):
        with pytest.raises(ValueError):
            PS.Ac3Format(*bad)
    assert PS.PcmFormat(2, 44100).is_valid()
    assert not PS.PcmFormat(2, 44100, 24).is_valid()
    assert PS.stream_copy(b"abcdef", 4) == JS.stream_copy(b"abcdef", 4)
    assert PS.stream_copy(b"abc") == b"abc"


def test_suggest_and_config_match_jax(tmp_path):
    for kw in ({}, dict(multichannel=False), dict(dolby_surround=True,
                                                  multichannel=False),
               dict(default_bitrate_per_channel=64)):
        cfg, jcfg = CodecConfig(**kw), JConfig(**kw)
        for ch in range(1, 7):
            for rate in PS.SAMPLE_RATES:
                a = PS.suggest_pcm(PS.Ac3Format(ch, rate, 448), cfg)
                b = JS.suggest_pcm(JS.Ac3Format(ch, rate, 448), jcfg)
                assert (a.channels, a.sample_rate) == \
                    (b.channels, b.sample_rate)
                a = PS.suggest_ac3(PS.PcmFormat(ch, rate), cfg)
                b = JS.suggest_ac3(JS.PcmFormat(ch, rate), jcfg)
                assert (a.channels, a.sample_rate, a.bitrate) == \
                    (b.channels, b.sample_rate, b.bitrate)
            assert cfg.default_bitrate(ch) == jcfg.default_bitrate(ch)
        for coded in range(11):
            assert cfg.output_flags(coded) == jcfg.output_flags(coded)
    path = str(tmp_path / "cfg.json")
    CodecConfig(multichannel=False, default_bitrate_per_channel=64).save(path)
    assert CodecConfig.load(path) == CodecConfig(
        multichannel=False, default_bitrate_per_channel=64)
    assert JConfig.load(path) == JConfig(multichannel=False,
                                         default_bitrate_per_channel=64)


@pytest.mark.parametrize("exact", [True, False])
def test_uneven_feeds_equal_one_shot(exact):
    """Pieces of 7 B, 1,000 B and the rest (the first piece holds no
    whole header, the second ends mid-frame) give the one-shot PCM."""
    es = _frames("bench_51_448.ac3") + _frames("stereo_192.ac3")
    whole = PS.Ac3ToPcmStream(2, exact=exact, device="cpu").convert(es)
    dec = PS.Ac3ToPcmStream(2, exact=exact, device="cpu")
    parts = [dec.convert(es[:7]), dec.convert(es[7:1007]),
             dec.convert(es[1007:])]
    assert parts[0].shape == (0, 2)
    np.testing.assert_array_equal(np.concatenate(parts), whole)
    assert whole.shape == (14 * 1536, 2) and whole.dtype == np.int16


def test_exact_stream_equals_native_decoder():
    """exact=True: the stream layer's int16 equals the native C++
    decoder's float output (the same negotiated flags, level 1, bias 384)
    through the same int16 conversion, on a damaged stream (resync)."""
    bad = _corrupt(_frames("bench_51_448.ac3"))
    dec = PS.Ac3ToPcmStream(dst_channels=2, exact=True, device="cpu")
    out = np.concatenate([dec.convert(bad[i:i + 777])
                          for i in range(0, len(bad), 777)])
    want = NativeDecoder().decode_stream(
        bad, T.A52_STEREO | T.A52_ADJUST_LEVEL, 1.0, 384.0)
    assert want.shape[0] == 36          # frames 2 and 5 dropped by resync
    np.testing.assert_array_equal(out, _i16(want))


def test_fast_stream_tracks_jax_through_resync():
    """The default (fast) mode against JAX's Ac3ToPcmStream on the same
    damaged stream in the same pieces: the same frames survive resync,
    each piece gives the same number of samples, and the PCM is within 1
    int16 LSB (two matmul filterbanks summing in different orders)."""
    bad = _corrupt(_frames("bench_51_448.ac3"))
    mine = PS.Ac3ToPcmStream(dst_channels=2, device="cpu")
    ref = JS.Ac3ToPcmStream(dst_channels=2)
    for i in range(0, len(bad), 2222):
        a = mine.convert(bad[i:i + 2222])
        b = ref.convert(bad[i:i + 2222])
        assert a.shape == b.shape and a.dtype == b.dtype == np.int16
        if len(a):
            assert np.abs(a.astype(np.int32) - b.astype(np.int32)).max() <= 1
    assert mine.buf == ref.buf


def test_request_flags_and_acm_order():
    """The ACM request tree (mono, stereo / Dolby, multichannel) and the
    interleave order: a 5.1 stream decoded with multichannel on lands in
    FL, FR, FC, LFE, BL, BR (ACM_ORDER), equal to the native decoder's
    planes in that order."""
    es = _frames("bench_51_448.ac3", 2)
    for dst, cfg, want in (
            (1, None, T.A52_MONO), (2, None, T.A52_STEREO),
            (None, CodecConfig(multichannel=False, dolby_surround=True),
             T.A52_DOLBY), (None, None, T.A52_3F2R | T.A52_LFE)):
        s = PS.Ac3ToPcmStream(dst, cfg, exact=True, device="cpu")
        j = JS.Ac3ToPcmStream(dst, JConfig(**vars(cfg)) if cfg else None)
        assert s._request_flags(T.A52_3F2R | T.A52_LFE) == \
            j._request_flags(JT.A52_3F2R | JT.A52_LFE) == \
            want | T.A52_ADJUST_LEVEL
    out = PS.Ac3ToPcmStream(exact=True, device="cpu").convert(es)
    planes = NativeDecoder().decode_stream(
        es, T.A52_3F2R | T.A52_LFE | T.A52_ADJUST_LEVEL, 1.0, 384.0)
    order = PS.ACM_ORDER[T.A52_3F2R | T.A52_LFE]
    assert out.shape == (2 * 1536, 6)
    x = np.clip(np.round((planes[:, order].astype(np.float64) - 384.0)
                         * 32768.0), -32768, 32767).astype(np.int16)
    np.testing.assert_array_equal(out, x.transpose(0, 2, 1).reshape(-1, 6))


def test_resync_is_logged(caplog):
    bad = _corrupt(_frames("bench_51_448.ac3"))
    with caplog.at_level(logging.INFO, logger=port_log.name):
        PS.Ac3ToPcmStream(2, exact=True, device="cpu").convert(bad)
        PS.suggest_pcm(PS.Ac3Format(6, 48000, 448))
    msgs = [r.getMessage() for r in caplog.records
            if r.name == "ac3acm_tpu_torch"]
    assert any(m.startswith("resync: skipped") for m in msgs), msgs
    assert any(m.startswith("format_suggest ac3->pcm") for m in msgs), msgs


# -- the a52 decode API ------------------------------------------------------

def _a52_blocks(mod, es, flags, dynrng=None):
    """Every block of es through mod's a52_* calls -> ([blocks], [flags])."""
    st = mod.a52_init(0)
    if dynrng == "off":
        mod.a52_dynrng(st)
    elif dynrng is not None:
        mod.a52_dynrng(st, *dynrng)
    out, got = [], []
    pos = 0
    while pos + 7 <= len(es):
        size, _, _, _ = mod.a52_syncinfo(es[pos:pos + 7])
        if size == 0:
            pos += 1
            continue
        assert mod.a52_frame(st, es[pos:pos + size], flags, 1.0, 0.0) == 0
        got.append(mod.a52_flags(st))
        for _ in range(6):
            assert mod.a52_block(st) == 0
            out.append(mod.a52_samples(st).copy())
        assert mod.a52_block(st) == 1
        pos += size
    mod.a52_free(st)
    return np.stack(out), got


@pytest.mark.parametrize("flags", [T.A52_STEREO | T.A52_ADJUST_LEVEL,
                                   T.A52_3F2R | T.A52_LFE, T.A52_MONO])
def test_a52_api_matches_jax_and_native(flags):
    es = _frames("bench_51_448.ac3")
    if flags != T.A52_3F2R | T.A52_LFE:       # one plane count throughout
        es += _frames("stereo_192.ac3", 2)
    mine, fl = _a52_blocks(a52, es, flags)
    ref, jfl = _a52_blocks(ja52, es, flags)
    np.testing.assert_array_equal(mine, ref)
    assert fl == jfl
    np.testing.assert_array_equal(
        mine, NativeDecoder().decode_stream(es, flags, 1.0, 0.0))


def test_a52_dynrng_callback_matches_jax():
    """a52_dynrng(state, fn, data) remaps the decoded range, a52_dynrng
    (state) disables DRC: the same blocks as the JAX API, the user data
    handed through, and both change the output."""
    es = gen_stream(7, 2, False, nframes=3, want_cpl=False,
                    want_deltba=False, want_dynrng=True)
    seen = []

    def half(r, data):
        seen.append(data)
        return r * 0.5

    outs = {}
    for mod in (a52, ja52):
        outs[mod] = [_a52_blocks(mod, es, T.A52_STEREO, d)[0]
                     for d in (None, (half, "user"), "off",
                               (lambda r, d: r, None))]
    for a, b in zip(outs[a52], outs[ja52]):
        np.testing.assert_array_equal(a, b)
    base, halved, off, ident = outs[a52]
    assert seen and set(seen) == {"user"}
    assert not np.array_equal(halved, base)
    assert not np.array_equal(off, base)
    np.testing.assert_array_equal(ident, base)


def test_a52_namespace_and_syncinfo():
    pub = [n for n in dir(a52) if not n.startswith("_")
           and n not in ("annotations", "np", "T")]
    prefixes = ("a52_", "A52_", "MM_", "AC3_")
    for n in pub:
        assert n.startswith(prefixes), n
    assert {n for n in dir(ja52) if n.startswith(prefixes)} == set(pub)
    es = open(os.path.join(GOLDEN, "bench_51_448.ac3"), "rb").read()
    for off in (0, 1, 1792, 3000):
        assert a52.a52_syncinfo(es[off:off + 7]) == \
            ja52.a52_syncinfo(es[off:off + 7])
    junk = b"\x0b\x77" + bytes(range(60))
    st, jst = a52.a52_init(), ja52.a52_init()
    assert a52.a52_frame(st, junk, T.A52_STEREO) == \
        ja52.a52_frame(jst, junk, T.A52_STEREO)
    assert a52.a52_block(st) == ja52.a52_block(jst) == 1
