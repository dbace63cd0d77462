"""Port: SampleDecoder, the LIBA52_FIXED / LIBA52_DOUBLE sample types, on
the CPU, bitwise against the JAX package's SampleDecoder.

  * "fixed" and "double" through backend="native" (the C++ builds of the
    two sample types, each package its own copy) on goldens and output
    modes, DRC on and off.
  * The port's backend="device" with device="cpu" (ac3h_sdec_parse_fixed
    on the host, fixed_block_pipeline with the plain version of kernel
    B1Q) against JAX's backend="tpu" on three formats (one JAX compile
    each) and against the port's native backend on more.
  * The backend names and the kinds each takes; no card, no device
    backend.
"""
import os

import numpy as np
import pytest
import torch

from ac3acm_tpu.host.native import SampleDecoder as JSampleDecoder
from ac3acm_tpu_torch import tables as T
from ac3acm_tpu_torch.host.native import SampleDecoder, _frames
from ac3acm_tpu_torch.ops import imdct_exact as PE

GOLDEN = os.path.join(os.path.dirname(__file__), "golden")
ADJ = T.A52_ADJUST_LEVEL


def _es(name, nframes=None):
    es = open(os.path.join(GOLDEN, name), "rb").read()
    if nframes is None:
        return es
    return b"".join(list(_frames(es))[:nframes])


@pytest.mark.parametrize("kind", ["fixed", "double"])
@pytest.mark.parametrize("name,flags", [
    ("bench_51_448.ac3", T.A52_STEREO),
    ("bench_51_448.ac3", T.A52_3F2R | T.A52_LFE),
    ("bench_51_448.ac3", T.A52_DOLBY),
    ("stereo_192.ac3", T.A52_STEREO),
    ("mono_96.ac3", T.A52_MONO),
    ("blksw20_hazard.ac3", T.A52_STEREO),
    ("cpl51_hazard.ac3", T.A52_STEREO),
    ("halfrate24_64.ac3", T.A52_STEREO),
])
def test_native_backend_matches_jax(kind, name, flags):
    es = _es(name)
    for drc in (True, False):
        mine, theirs = (SampleDecoder(kind, backend="native"),
                        JSampleDecoder(kind, backend="native"))
        mine.set_drc_enabled(drc)
        theirs.set_drc_enabled(drc)
        m = mine.decode_stream(es, flags | ADJ)
        t = theirs.decode_stream(es, flags | ADJ)
        assert m.dtype == t.dtype == {"fixed": np.int32,
                                      "double": np.float64}[kind]
        assert m.shape == t.shape and m.shape[0] > 0
        np.testing.assert_array_equal(m, t, err_msg=f"{name} drc={drc}")


# (golden, output flags, frames): the three formats put through JAX's
# device backend (one compile each)
JAX_CASES = [("bench_51_448.ac3", T.A52_3F2R | T.A52_LFE, 3),
             ("stereo_192.ac3", T.A52_STEREO, 3),
             ("mono_96.ac3", T.A52_STEREO, 3)]


@pytest.mark.parametrize("name,flags,nframes", JAX_CASES)
def test_device_backend_matches_jax(name, flags, nframes):
    """The port's device backend on the CPU against JAX's "tpu" backend
    and the port's native backend, DRC on and off; the plain versions
    run (no kernel launch), and two calls carry the delay across."""
    es = _es(name, nframes)
    first = b"".join(list(_frames(es))[:1])
    rest = es[len(first):]
    for drc in (True, False):
        dev = SampleDecoder("fixed", device="cpu")
        jdev = JSampleDecoder("fixed", backend="tpu")
        nat = SampleDecoder("fixed", backend="native")
        for d in (dev, jdev, nat):
            d.set_drc_enabled(drc)
        before = PE.launches_fixed
        m = np.concatenate([dev.decode_stream(first, flags | ADJ),
                            dev.decode_stream(rest, flags | ADJ)])
        assert PE.launches_fixed == before
        j = jdev.decode_stream(es, flags | ADJ)
        n = nat.decode_stream(es, flags | ADJ)
        assert m.dtype == np.int32 and m.shape == j.shape == n.shape
        np.testing.assert_array_equal(m, j, err_msg=f"{name} drc={drc}")
        np.testing.assert_array_equal(m, n, err_msg=f"{name} drc={drc}")


@pytest.mark.parametrize("name,flags,nframes", [
    ("blksw20_hazard.ac3", T.A52_STEREO, 3),
    ("bench_51_448.ac3", T.A52_STEREO, 2),
    ("cpl51_hazard.ac3", T.A52_DOLBY, 2),
])
def test_device_backend_matches_native(name, flags, nframes):
    """More formats (short blocks, the 5.1 -> 2.0 frequency path,
    coupling into Dolby) against the port's native fixed backend, which
    test_native_backend_matches_jax holds to JAX's."""
    es = _es(name, nframes)
    for drc in (True, False):
        dev = SampleDecoder("fixed", device="cpu")
        nat = SampleDecoder("fixed", backend="native")
        dev.set_drc_enabled(drc)
        nat.set_drc_enabled(drc)
        np.testing.assert_array_equal(dev.decode_stream(es, flags | ADJ),
                                      nat.decode_stream(es, flags | ADJ))


def test_backend_names_and_kinds(monkeypatch):
    with pytest.raises(ValueError, match="device"):
        SampleDecoder("fixed", backend="tpu")
    with pytest.raises(ValueError, match="native"):
        SampleDecoder("double")                 # the device backend default
    with pytest.raises(ValueError, match="native"):
        SampleDecoder("double", backend="device", device="cpu")
    with pytest.raises(ValueError, match="fixed|double"):
        SampleDecoder("float", backend="native")
    with pytest.raises(ValueError, match="native|device"):
        SampleDecoder("fixed", backend="cuda")
    assert SampleDecoder("fixed", device="cpu").device.type == "cpu"
    assert SampleDecoder("double", backend="native").device is None
    empty = SampleDecoder("fixed", device="cpu").decode_stream(b"\0" * 64,
                                                               T.A52_STEREO)
    assert empty.shape == (0, 0, 256) and empty.dtype == np.int32
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        SampleDecoder("fixed")
    SampleDecoder("fixed", backend="native")    # the host needs no card
