"""Port: the shell around the codec on the CPU (io.sinks, io.demux,
io.driver, utils.meter, utils.trace.profile), against the JAX package's
copies where there is one to compare with.

  * Every sink make_sink accepts (but the OSS device) writes the bytes of
    JAX's on the same planes; convert_s16 and the channel orders.
  * The demux: one-shot and chunked PS/TS against JAX's.
  * CodecDriver: the ACM lifecycle of tests/test_driver.py on the port,
    its decode and encode streams equal to Ac3ToPcmStream and
    PcmToAc3Stream on the same bytes; no card, no stream.
  * FpsMeter and profile() (a Chrome trace JSON in place of XPlane).
"""
import glob
import io
import json
import os

import numpy as np
import pytest
import torch

from ac3acm_tpu import tables as JT
from ac3acm_tpu.io import demux as JDX
from ac3acm_tpu.io import sinks as JS
from ac3acm_tpu_torch import tables as T
from ac3acm_tpu_torch.io import demux as DX
from ac3acm_tpu_torch.io import sinks as S
from ac3acm_tpu_torch.io.driver import CodecDriver, FormatTagDetails
from ac3acm_tpu_torch.io.stream import (Ac3Format, Ac3ToPcmStream, PcmFormat,
                                        PcmToAc3Stream)
from ac3acm_tpu_torch.utils.config import CodecConfig
from tests.test_torch_cli import ps_wrap, ts_wrap

GOLDEN = os.path.join(os.path.dirname(__file__), "golden")
BENCH = os.path.join(GOLDEN, "bench_51_448.ac3")

SINKS = ["float", "floatdolby", "null", "null4", "null6", "peak",
         "peakdolby", "wav", "wavdolby", "wav6", "aif", "aifdolby"]


def _planes(rng, nch):
    """Biased (+384) float planes with values past full scale, so the
    clip is exercised."""
    x = rng.standard_normal((nch, 256)).astype(np.float32) * 0.4
    return (x + np.float32(384.0)).astype(np.float32)


@pytest.mark.parametrize("name", SINKS)
def test_sink_bytes_match_jax(name, capsys):
    outs = []
    for make in (S.make_sink, JS.make_sink):
        fp = io.BytesIO()
        sink = make(name, fp)
        flags, level, bias = sink.setup(44100)
        nch = int(T.NFCHANS[flags & T.A52_CHANNEL_MASK]
                  + bool(flags & T.A52_LFE))
        for i in range(5):
            sink.play(flags, _planes(np.random.default_rng(i), nch))
        sink.close()
        outs.append((flags, level, bias, fp.getvalue(),
                     capsys.readouterr().err,
                     getattr(sink, "blocks", None)))
    assert outs[0] == outs[1]
    if name.startswith(("wav", "aif", "float")):
        assert len(outs[0][3]) > 5 * 256


def test_sink_registry_and_orders():
    with pytest.raises(ValueError, match="unknown output driver"):
        S.make_sink("mp3")
    assert S.WAV_ORDER == JS.WAV_ORDER and S.SPEAKER_TBL == JS.SPEAKER_TBL
    planes = np.full((6, 256), 384.0, np.float32)
    for ch in range(6):
        planes[ch] += (ch + 1) / 32768.0
    out = S.convert_s16(planes, T.A52_3F2R | T.A52_LFE)
    assert list(out[:6]) == [2, 4, 3, 1, 5, 6]
    rng = np.random.default_rng(3)
    for flags in S.WAV_ORDER:
        p = _planes(rng, len(S.WAV_ORDER[flags]) + 1)
        np.testing.assert_array_equal(S.convert_s16(p, flags),
                                      JS.convert_s16(p, flags))


def test_demux_matches_jax():
    es = open(os.path.join(GOLDEN, "mono_96.ac3"), "rb").read()
    ts, ps = ts_wrap(es), ps_wrap(es)
    for kind, data, kw in (("ts", ts, dict(pid=0x42)), ("ps", ps, {}),
                           ("auto", ps, {}), ("es", es, {})):
        got = DX.extract_es(data, kind, **kw)
        assert got == JDX.extract_es(data, kind, **kw), kind
    assert DX.extract_es(ps, "ps") == es
    assert list(DX.es_frames(es)) == list(JDX.es_frames(es))
    for csz in (61, 188, 517):
        d, j = DX.TsDemux(0x42), JDX.TsDemux(0x42)
        got = b"".join(d.feed(ts[i:i + csz]) for i in range(0, len(ts), csz))
        assert got == b"".join(j.feed(ts[i:i + csz])
                               for i in range(0, len(ts), csz))
        d = DX.PsDemux(0)
        got = b"".join(d.feed(ps[i:i + csz]) for i in range(0, len(ps), csz))
        assert got == es and d.ended
    with pytest.raises(ValueError):
        DX.extract_es(es, "mkv")


def test_driver_formats_and_negotiation():
    with CodecDriver(device="cpu") as drv:
        assert "PyTorch" in drv.NAME
        tags = {t.tag: t for t in drv.formattag_details()}
        assert isinstance(tags["ac3"], FormatTagDetails)
        assert tags["ac3"].n_formats == 342 and tags["pcm"].n_formats == 18
        ac3 = drv.format_details("ac3")
        assert len(set(ac3)) == 342 and all(drv.is_valid(f) for f in ac3)
        assert "AC-3" in drv.format_name(ac3[0])
        assert "PCM" in drv.format_name(drv.format_details("pcm")[0])
        with pytest.raises(ValueError):
            drv.format_details("mp3")
    drv = CodecDriver(cfg=CodecConfig(multichannel=False), device="cpu")
    assert drv.format_suggest(Ac3Format(6, 48000, 448)) == PcmFormat(2, 48000)
    enc = drv.format_suggest(PcmFormat(2, 48000))
    assert isinstance(enc, Ac3Format) and enc.bitrate == 192
    with pytest.raises(TypeError):
        drv.format_suggest("pcm")


def test_driver_stream_open_validation():
    drv = CodecDriver(device="cpu")
    for src, dst in ((Ac3Format(2, 48000, 192), PcmFormat(2, 44100)),
                     (Ac3Format(2, 48000, 192), Ac3Format(2, 48000, 256)),
                     (Ac3Format(6, 48000, 448), PcmFormat(4, 48000)),
                     (PcmFormat(4, 48000), Ac3Format(2, 48000, 192))):
        with pytest.raises(ValueError):
            drv.stream_open(src, dst)
    with pytest.raises(ValueError):
        CodecDriver(cfg=CodecConfig(multichannel=False),
                    device="cpu").stream_open(Ac3Format(6, 48000, 448),
                                              PcmFormat(6, 48000))
    s = drv.stream_open(Ac3Format(6, 48000, 448), PcmFormat(6, 48000))
    assert s.mode == "decode"
    s.close()
    assert s not in drv._streams
    with pytest.raises(RuntimeError):
        s.convert(b"\x0b\x77")


def test_driver_streams_equal_the_stream_layer():
    """The driver's decode and encode streams give the bytes of
    Ac3ToPcmStream and PcmToAc3Stream on the same input; copy passes
    bytes through; close() drains."""
    es = open(BENCH, "rb").read()
    cfg = CodecConfig(multichannel=False)
    with CodecDriver(cfg=cfg, device="cpu") as drv:
        src = Ac3Format(6, 48000, 448)
        dec = drv.stream_open(src, drv.format_suggest(src))
        pcm = dec.convert(es[: 3 * src.block_align])
        want = Ac3ToPcmStream(dst_channels=2, cfg=cfg, device="cpu").convert(
            es[: 3 * src.block_align])
        assert pcm.dtype == np.int16 and pcm.shape == (3 * 1536, 2)
        np.testing.assert_array_equal(pcm, want)
        assert pcm.nbytes <= dec.size(3 * src.block_align)
        fmt = Ac3Format(2, 48000, 192)
        enc = drv.stream_open(PcmFormat(2, 48000), fmt)
        out = enc.convert(pcm)
        assert out == PcmToAc3Stream(fmt, cfg=cfg, device="cpu").convert(pcm)
        assert out[:2] == b"\x0b\x77" and len(out) == 3 * fmt.block_align
        assert len(out) <= enc.size(pcm.nbytes)
        cp = drv.stream_open(src, src)
        assert cp.mode == "copy" and cp.convert(b"abc") == b"abc"
    assert not drv._streams


def test_driver_configure_and_no_card(tmp_path, monkeypatch):
    p = str(tmp_path / "drv.json")
    drv = CodecDriver(config_path=p)
    cfg = drv.configure(dolby_surround=True, multichannel=False)
    drv.save_config()
    assert CodecConfig.load(p) == cfg
    assert drv.cfg.output_flags(T.A52_3F2R) == T.A52_DOLBY
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for src, dst in ((Ac3Format(2, 48000, 192), PcmFormat(2, 48000)),
                     (PcmFormat(2, 48000), Ac3Format(2, 48000, 192))):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            CodecDriver().stream_open(src, dst)
    assert CodecDriver().stream_open(PcmFormat(2, 48000),
                                     PcmFormat(2, 48000)).mode == "copy"


def test_meter(capsys):
    from ac3acm_tpu_torch.utils.meter import FpsMeter
    m = FpsMeter(48000, period=0.0, enabled=True)
    m.tick(10, streams=4)
    m.close()
    err = capsys.readouterr().err
    assert "frames" in err and "realtime" in err
    assert m.frames == 40 and m._xrt(31.25) == 1.0
    quiet = FpsMeter(48000, enabled=False)
    quiet.tick(3)
    quiet.close()
    assert capsys.readouterr().err == "" and quiet.frames == 3


def test_profile_trace(tmp_path, monkeypatch):
    """profile() writes a Chrome trace JSON (the JAX package writes an
    XPlane dump) holding the traced ops; AC3TPU_TRACE_DIR is its default
    directory."""
    from ac3acm_tpu_torch.utils.trace import profile
    d = str(tmp_path / "trace")
    with profile(d) as out:
        (torch.arange(8.0) ** 2).sum()
    assert out == d
    files = glob.glob(os.path.join(d, "*.json"))
    assert len(files) == 1
    events = json.load(open(files[0]))["traceEvents"]
    assert any("pow" in str(e.get("name", "")) for e in events)
    monkeypatch.setenv("AC3TPU_TRACE_DIR", str(tmp_path / "env"))
    with profile() as out:
        torch.ones(2).sum()
    assert out == str(tmp_path / "env")
    assert glob.glob(os.path.join(out, "*.pt.trace.json"))
    failed = str(tmp_path / "failed")
    with pytest.raises(ZeroDivisionError):
        with profile(failed):
            torch.ones(3).sum()
            1 / 0
    assert len(glob.glob(os.path.join(failed, "*.pt.trace.json"))) == 1
    assert JT.A52_STEREO == T.A52_STEREO
