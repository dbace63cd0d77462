"""Port: imports no JAX and nothing of the JAX package; refuses to run on
the CPU unless asked; launches its kernel only for CUDA tensors."""
import os
import re
import subprocess
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "ac3acm_tpu_torch")


def test_import_every_module_without_jax():
    code = (
        "import pkgutil, sys\n"
        "import ac3acm_tpu_torch as pkg\n"
        "names = [m.name for m in pkgutil.walk_packages(pkg.__path__, "
        "pkg.__name__ + '.')]\n"
        "for n in names:\n"
        "    __import__(n)\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'ac3acm_tpu' or m.startswith('ac3acm_tpu.')]\n"
        "assert not bad, bad\n"
        "new = {'ac3acm_tpu_torch.ops.bitgather', 'ac3acm_tpu_torch.ops.alloc',"
        " 'ac3acm_tpu_torch.ops.unpack_device', 'ac3acm_tpu_torch.a52',"
        " 'ac3acm_tpu_torch.host.bitio', 'ac3acm_tpu_torch.host.alloc',"
        " 'ac3acm_tpu_torch.host.parse', 'ac3acm_tpu_torch.io.stream',"
        " 'ac3acm_tpu_torch.utils.config', 'ac3acm_tpu_torch.utils.trace',"
        " 'ac3acm_tpu_torch.ops.mdct', 'ac3acm_tpu_torch.models.encoder',"
        " 'ac3acm_tpu_torch.host.pack', 'ac3acm_tpu_torch.ops.pack_device',"
        " 'ac3acm_tpu_torch.parallel.encode',"
        " 'ac3acm_tpu_torch.parallel.transcode',"
        " 'ac3acm_tpu_torch.cli', 'ac3acm_tpu_torch.io.driver',"
        " 'ac3acm_tpu_torch.io.demux', 'ac3acm_tpu_torch.io.sinks',"
        " 'ac3acm_tpu_torch.utils.meter',"
        " 'ac3acm_tpu_torch.parallel.mesh',"
        " 'ac3acm_tpu_torch.ops.fixed_chain',"
        " 'ac3acm_tpu_torch.ops.snr_search'}\n"
        "assert new <= set(names), names\n"
        "assert len(names) >= 35, names\n"
        "print(len(names))\n")
    env = dict(os.environ, PYTHONPATH=ROOT)
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr


_FORBIDDEN = re.compile(
    r"^\s*(import\s+jax\b|from\s+jax\b)|ac3acm_tpu\.|"
    r"(from|import)\s+ac3acm_tpu(\s|$|\.)", re.M)


def test_sources_name_no_jax():
    files = [os.path.join(ROOT, "chip_smoke.py")]
    for d, _, names in os.walk(PKG):
        files += [os.path.join(d, n) for n in names if n.endswith(".py")]
    assert len(files) >= 30
    for path in files:
        text = open(path).read()
        m = _FORBIDDEN.search(text)
        assert m is None, f"{path}: {m.group(0)!r}"


def test_entry_points_refuse_without_a_card(monkeypatch):
    from ac3acm_tpu_torch import tables as T
    from ac3acm_tpu_torch.parallel.pipeline import (BatchedDecoder,
                                                    init_batched_carry)
    from ac3acm_tpu_torch.utils.state import carry_from_numpy
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        init_batched_carry(4)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        BatchedDecoder(2, T.A52_STEREO)
    for parser in ("raw", "python", "raw_py"):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            BatchedDecoder(2, T.A52_STEREO, parser=parser)
    from ac3acm_tpu_torch.io.stream import Ac3ToPcmStream
    from ac3acm_tpu_torch.models.decoder import Decoder, init_carry
    for make in (Decoder, lambda: Decoder(exact=False), init_carry,
                 Ac3ToPcmStream, lambda: Ac3ToPcmStream(2, exact=True)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make()
    assert Decoder(device="cpu").device.type == "cpu"
    assert Ac3ToPcmStream(device="cpu").dec.device.type == "cpu"
    from ac3acm_tpu_torch.ops.unpack_device import init_unpack_carry
    with pytest.raises(RuntimeError, match="no CUDA device"):
        init_unpack_carry(2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        carry_from_numpy(torch.zeros(2, 6, 128).numpy(),
                         torch.ones(2, dtype=torch.bool).numpy())
    from ac3acm_tpu_torch.a52 import AC3_encode_init
    from ac3acm_tpu_torch.io.stream import Ac3Format, PcmToAc3Stream
    from ac3acm_tpu_torch.models.encoder import Encoder
    from ac3acm_tpu_torch.parallel.encode import BatchedEncoder
    from ac3acm_tpu_torch.parallel.transcode import Transcoder
    from ac3acm_tpu_torch.utils.state import load_encode_state
    for make in (lambda: Encoder(48000, 192000, 2),
                 lambda: BatchedEncoder(2, 48000, 192000, 2),
                 lambda: BatchedEncoder(2, 48000, 192000, 2, pack="native"),
                 lambda: Transcoder(2, 192000, 2),
                 lambda: Transcoder(2, 192000, 2, parser="raw"),
                 lambda: PcmToAc3Stream(Ac3Format(2, 48000, 192)),
                 lambda: AC3_encode_init(48000, 192000, 2),
                 lambda: load_encode_state("unused.npz")):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make()
    for make in (lambda: BatchedEncoder(2, 48000, 192000, 2, mesh=object(),
                                        device="cpu"),
                 lambda: Transcoder(2, 192000, 2, mesh=object(),
                                    device="cpu")):
        with pytest.raises(TypeError, match="Mesh"):
            make()
    assert Encoder(48000, 192000, 2, device="cpu").device.type == "cpu"
    from ac3acm_tpu_torch.host.native import SampleDecoder
    from ac3acm_tpu_torch.io.driver import CodecDriver
    from ac3acm_tpu_torch.io.stream import PcmFormat
    from ac3acm_tpu_torch.models.decoder import init_fixed_carry
    for make in (lambda: SampleDecoder("fixed"), init_fixed_carry,
                 lambda: CodecDriver().stream_open(
                     Ac3Format(2, 48000, 192), PcmFormat(2, 48000)),
                 lambda: CodecDriver().stream_open(
                     PcmFormat(2, 48000), Ac3Format(2, 48000, 192))):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make()
    assert SampleDecoder("fixed", device="cpu").device.type == "cpu"
    delay, downmixed = init_batched_carry(4, device="cpu")
    assert delay.device.type == "cpu" and delay.shape == (4, 6, 128)
    assert bool(downmixed.all())


def test_cpu_tensors_take_the_plain_version():
    from ac3acm_tpu_torch.ops import fused_steady as FS
    freq = torch.zeros((2, 6, 2, 256))
    d0 = torch.zeros((2, 2, 128))
    bias = torch.full((2, 6), 384.0)
    before = FS.launches
    pcm, dlast = FS.fused_steady(freq, d0, bias)
    assert FS.launches == before
    assert pcm.dtype == torch.int16 and pcm.shape == (2, 6, 2, 256)
    assert dlast.shape == (2, 2, 128)
    assert int(pcm.abs().max()) == 0
    from ac3acm_tpu_torch.ops import imdct_exact as IE
    before = IE.launches, IE.launches_fixed
    z, d = IE.split_fb_fixed(torch.zeros((3, 256), dtype=torch.int32))
    assert (IE.launches, IE.launches_fixed) == before
    assert z.dtype == torch.int32 and not bool(z.any())
    from ac3acm_tpu_torch.models.decoder import StreamFormat, init_fixed_carry
    from ac3acm_tpu_torch.ops import fixed_chain as FC
    before = FC.launches_fixed_chain
    blocks = {"freq": torch.zeros((2, 6, 256), dtype=torch.int32),
              "blksw": torch.zeros((2, 5), dtype=torch.bool),
              "coeff": torch.ones((2, 5)),
              "remat": torch.zeros((2, 256), dtype=torch.bool),
              "bias": torch.zeros(2, dtype=torch.int32)}
    (delay, downmixed), pcm = FC.fixed_chain(
        StreamFormat(7, 2, False, 31), init_fixed_carry("cpu"), blocks)
    assert FC.launches_fixed_chain == before
    assert pcm.shape == (2, 2, 256) and not bool(pcm.any())
