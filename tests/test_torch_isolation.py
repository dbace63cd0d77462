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
        "assert len(names) >= 12, names\n"
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
    assert len(files) >= 14
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
    with pytest.raises(RuntimeError, match="no CUDA device"):
        carry_from_numpy(torch.zeros(2, 6, 128).numpy(),
                         torch.ones(2, dtype=torch.bool).numpy())
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
