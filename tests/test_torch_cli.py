"""Port: the command-line tools (ac3acm_tpu_torch.cli) on the CPU, against
the JAX package's CLI run in-process on the same files.

  * decode to wav: the port's device backend (--device cpu) and its
    native backend write the bytes JAX's native backend writes; the fixed
    sample type (device and native) those of JAX's fixed native build;
    the double type; the fast accuracy mode within its contract.
  * encode: the bytes of JAX's encode of the same wav.
  * info (with --check-crc) prints JAX's text; extract demuxes synthetic
    PS and TS wraps as JAX's extract does; _stream_frames yields what a
    whole-buffer scan finds with bounded memory.
  * No card and no --device cpu: one "error:" line, exit 2.
"""
import io
import os

import numpy as np
import pytest
import torch

from ac3acm_tpu import cli as JC
from ac3acm_tpu_torch import cli as PC
from ac3acm_tpu_torch.io import demux
from ac3acm_tpu_torch.models import decoder as PD

GOLDEN = os.path.join(os.path.dirname(__file__), "golden")
SRC = os.path.join(GOLDEN, "stereo_192.ac3")


@pytest.fixture(autouse=True)
def _accuracy_restored():
    before = PD.ACCURACY
    yield
    PD.ACCURACY = before


def _run(main, tmp_path, name, *args):
    """main(cmd, input, -o tmp_path/name, the rest) -> the output's bytes
    (-q but for extract, which has no meter)."""
    out = tmp_path / name
    quiet = [] if args[0] == "extract" else ["-q"]
    assert main([*args[:2], "-o", str(out), *args[2:], *quiet]) == 0
    return out.read_bytes()


@pytest.fixture(scope="module")
def jax_wavs(tmp_path_factory):
    """JAX's native float and fixed decodes of the golden, as wav bytes."""
    d = tmp_path_factory.mktemp("jax")
    return {st: _run(JC.main, d, f"{st}.wav", "decode", SRC,
                     "--backend", "native", "--sample-type", st)
            for st in ("float", "fixed", "double")}


@pytest.mark.parametrize("sample_type", ["float", "fixed", "double"])
@pytest.mark.parametrize("backend", [["--device", "cpu"],
                                     ["--backend", "native"]])
def test_decode_wav_matches_jax(tmp_path, jax_wavs, sample_type, backend):
    got = _run(PC.main, tmp_path, "p.wav", "decode", SRC,
               "--sample-type", sample_type, *backend)
    assert len(got) > 30000 and got[:4] == b"RIFF"
    assert got == jax_wavs[sample_type]


def test_decode_outputs_and_fast_mode(tmp_path, jax_wavs, capsys):
    """--output float and wavdolby match JAX's; --accuracy fast sets the
    package policy and stays within 1 LSB of the reference wav."""
    for sink in ("float", "wavdolby", "aif"):
        got = _run(PC.main, tmp_path, f"p.{sink}", "decode", SRC,
                   "--device", "cpu", "--output", sink)
        want = _run(JC.main, tmp_path, f"j.{sink}", "decode", SRC,
                    "--backend", "native", "--output", sink)
        assert got == want, sink
    fast = _run(PC.main, tmp_path, "fast.wav", "decode", SRC, "--device",
                "cpu", "--accuracy", "fast")
    assert PD.ACCURACY == "fast"
    a = np.frombuffer(fast[44:], "<i2").astype(int)
    b = np.frombuffer(jax_wavs["float"][44:], "<i2").astype(int)
    assert fast[:44] == jax_wavs["float"][:44]
    assert np.abs(a - b).max() <= 1
    assert PC.main(["decode", SRC, "-o", str(tmp_path / "n.wav"), "-q",
                    "--device", "cpu", "--no-drc", "--gain", "-6"]) == 0


def test_encode_matches_jax(tmp_path, jax_wavs):
    wav = tmp_path / "in.wav"
    wav.write_bytes(jax_wavs["float"])
    got = _run(PC.main, tmp_path, "p.ac3", "encode", str(wav), "--device",
               "cpu", "-b", "192")
    want = _run(JC.main, tmp_path, "j.ac3", "encode", str(wav), "-b", "192")
    assert got[:2] == b"\x0b\x77" and got == want


def test_info_matches_jax(capsys):
    for args in (["info", SRC], ["info", SRC, "--check-crc"]):
        assert PC.main(args) == 0
        mine = capsys.readouterr().out
        assert JC.main(args) == 0
        assert mine == capsys.readouterr().out
        assert "2/0, 48000 Hz, 192 kbps" in mine


def test_info_bad_crc(tmp_path, capsys):
    bad = bytearray(open(SRC, "rb").read())
    bad[100] ^= 0xFF
    f = tmp_path / "bad.ac3"
    f.write_bytes(bytes(bad))
    assert PC.main(["info", str(f), "--check-crc"]) == 1
    mine = capsys.readouterr().out
    assert JC.main(["info", str(f), "--check-crc"]) == 1
    assert mine == capsys.readouterr().out and "bad CRC" in mine


def ts_wrap(es, pid=0x42):
    """A minimal transport stream of es on pid (tests/test_regression.py's
    wrap)."""
    ts = bytearray()
    pos = 0
    first = True
    while pos < len(es):
        chunk = es[pos:pos + 184]
        pos += 184
        hdr = bytes([0x47, (0x40 if first else 0) | (pid >> 8), pid & 0xFF,
                     0x10])
        if first:
            pes = b"\x00\x00\x01\xbd" + b"\x00\x00" + b"\x80\x00\x00"
            body = pes + chunk[: 184 - len(pes)]
            pos = len(body) - len(pes)
            first = False
        else:
            body = chunk
        body = body + b"\xff" * (184 - len(body))
        ts += hdr + body
    return bytes(ts)


def ps_wrap(es, seg=1000):
    """A program stream of es in PES packets of seg bytes, substream 0x80
    (tests/test_regression.py's wrap)."""
    ps = bytearray(b"\x00\x00\x01\xba"
                   + bytes([0x44, 0, 4, 0, 4, 1, 0, 1, 0x89, 0xc8]))
    for off in range(0, len(es), seg):
        part = es[off:off + seg]
        pes_len = 3 + 1 + 1 + 3 + len(part)
        ps += (b"\x00\x00\x01\xbd" + bytes([pes_len >> 8, pes_len & 0xFF])
               + b"\x80\x80\x01" + b"\xff" + b"\x80" + b"\x01\x00\x01"
               + part)
    return bytes(ps + b"\x00\x00\x01\xb9")


@pytest.mark.parametrize("kind", ["ts", "ps", "es"])
def test_extract_matches_jax(tmp_path, kind):
    es = open(os.path.join(GOLDEN, "mono_96.ac3"), "rb").read()
    data = {"ts": ts_wrap, "ps": ps_wrap, "es": lambda x: x}[kind](es)
    src = tmp_path / f"in.{kind}"
    src.write_bytes(data)
    extra = ["--pid", "0x42"] if kind == "ts" else []
    got = _run(PC.main, tmp_path, "p.ac3", "extract", str(src), *extra)
    want = _run(JC.main, tmp_path, "j.ac3", "extract", str(src), *extra)
    assert got == want and got.startswith(b"\x0b\x77")
    if kind != "ts":
        assert got == es
    # decode straight from the container, as from the ES
    wav = _run(PC.main, tmp_path, "c.wav", "decode", str(src),
               "--backend", "native", *extra)
    assert wav == _run(JC.main, tmp_path, "cj.wav", "decode", str(src),
                       "--backend", "native", *extra)


def test_stream_frames_bounded_memory():
    """The 4 KB-chunk frame source yields exactly the frames a whole-buffer
    scan finds, for raw ES (clean and damaged) and a TS container read
    in small pieces (tests/test_stream.py's check, on the port)."""
    es = open(SRC, "rb").read() * 4
    want = [f for f, _, _ in demux.es_frames(es)]
    assert [f for f, _, _ in PC._stream_frames(io.BytesIO(es), "auto", 0,
                                               0)] == want
    cut = es[: len(es) // 2] + b"\xde\xad" * 33 + es[len(es) // 2:]
    assert [f for f, _, _ in PC._stream_frames(io.BytesIO(cut), "es", 0, 0)
            ] == [f for f, _, _ in demux.es_frames(cut)]
    ts = ts_wrap(es)
    want_ts = [f for f, _, _ in demux.es_frames(
        demux.extract_es(ts, "ts", pid=0x42))]
    got_ts = [f for f, _, _ in PC._stream_frames(io.BytesIO(ts), "ts", 0,
                                                 0x42, chunk=1024)]
    assert got_ts == want_ts and len(got_ts) >= len(want) - 1
    # a long stream: the carry buffer is compacted past 64 KB
    long = es * 20
    n = sum(1 for _ in PC._stream_frames(io.BytesIO(long), "es", 0, 0))
    assert n == len(want) * 20


def test_no_card_is_one_error_line(monkeypatch, tmp_path, capsys,
                                   jax_wavs):
    wav = tmp_path / "x.wav"
    wav.write_bytes(jax_wavs["float"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for args in (["decode", SRC], ["decode", SRC, "--sample-type", "fixed"],
                 ["encode", str(wav)]):
        assert PC.main([*args, "-o", str(tmp_path / "o"), "-q"]) == 2
        err = capsys.readouterr().err.strip().splitlines()
        assert len(err) == 1 and err[0].startswith("error: "), err
        assert "--device cpu" in err[0]
    # the host backends need no card
    assert PC.main(["decode", SRC, "--backend", "native", "-o",
                    str(tmp_path / "n.wav"), "-q"]) == 0
    assert PC.main(["decode", SRC, "--sample-type", "double", "-o",
                    str(tmp_path / "d.wav"), "-q"]) == 0
