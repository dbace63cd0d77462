"""Port: raw_batched_pipeline(pallas=True) -- device premix + K1 -- vs the
JAX package's raw pallas=True body and the port's plain raw tail.

The port's counterpart of tests/test_raw_pipeline.py::
test_raw_fused_tail_matches_xla: the golden 5.1 stream at 448 kbit/s on 2
lanes x 8 frames, in two 4-frame chunks so that every carry hands over.
On the CPU the port's K1 runs its plain version (FP32); JAX's runs its
Pallas kernel in interpret mode (the bf16 hi/lo product), so the two are
held to the fused-path contract: PCM within PCM_LSB_TOL int16 LSB, the
OLA delay within CARRY_ATOL, the unpack carry and the downmixed flag
bitwise.  JAX's gathers run on its numpy oracle, as in the other raw
tests.
"""
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ac3acm_tpu.tables as JT
from ac3acm_tpu.host.native import SideinfoBatchParser as JSideinfo
from ac3acm_tpu.models import decoder as JD
from ac3acm_tpu.ops import pallas_steady as PS
from ac3acm_tpu.ops import unpack_device as JU
from ac3acm_tpu.parallel import pipeline as JP
from ac3acm_tpu_torch.host.native import SideinfoBatchParser
from ac3acm_tpu_torch.models import decoder as PD
from ac3acm_tpu_torch.ops import fused_steady as FS
from ac3acm_tpu_torch.ops import unpack_device as PU
from ac3acm_tpu_torch.parallel import pipeline as PP
from tests.test_torch_fused_steady import count_k1  # noqa: F401 (fixture)
from tests.test_torch_unpack_device import _jax_gathers

GOLDEN = os.path.join(os.path.dirname(__file__), "golden")
FLAGS51 = JT.A52_STEREO | JT.A52_ADJUST_LEVEL
NFRAMES, LANES, CHUNK = 8, 2, 4


def _inputs(parser, U, fmt_cls):
    """One side-info parse of the golden stream, on `parser`'s package:
    -> (fmt, frame bytes [L, F, MB], pruned meta {key: [L, 6F, ...]},
    bias [L, 6F], cpl_fc)."""
    es = open(os.path.join(GOLDEN, "bench_51_448.ac3"), "rb").read()
    r = parser.parse([es * 2], NFRAMES, FLAGS51, 1.0, 384.0)
    assert int(r["nframes"][0]) == NFRAMES and r["valid"][0].all()
    mb = max(-(-int(r["fsizes"][0].max()) // 128) * 128, 128)
    recs = r["recs"][0]
    meta1 = U.prune_raw_meta(
        {k: np.ascontiguousarray(recs[k]) for k in recs.dtype.names})
    fmt = fmt_cls(acmod=int(r["fmt"][0, 0, 0]), output=int(r["fmt"][0, 0, 1]),
                  slev_zero=bool(r["fmt"][0, 0, 2]),
                  chanbias=int(recs[0]["chanbias"]))
    fu8 = np.broadcast_to(r["frames"][0, :, :mb][None],
                          (LANES, NFRAMES, mb)).copy()
    meta = {k: np.broadcast_to(v[None], (LANES,) + v.shape).copy()
            for k, v in meta1.items()}
    bias = np.full((LANES, 6 * NFRAMES), 384.0, np.float32)
    return fmt, fu8, meta, bias, U.static_cpl_fc(meta1)


def _chunks(fu8, meta, bias, to):
    for f0 in range(0, NFRAMES, CHUNK):
        b = slice(6 * f0, 6 * (f0 + CHUNK))
        yield (to(fu8[:, f0:f0 + CHUNK]), {k: to(v[:, b])
                                           for k, v in meta.items()},
               to(bias[:, b]))


def _run(fn, carry, chunks, as_numpy):
    pcms = []
    for fu8, meta, bias in chunks:
        carry, pcm = fn(carry, fu8, meta, bias)
        pcms.append(as_numpy(pcm).astype(np.int64))
    return carry, np.concatenate(pcms, axis=1)


@pytest.fixture(scope="module")
def golden():
    port = _inputs(SideinfoBatchParser(1), PU, PD.StreamFormat)
    jax = _inputs(JSideinfo(1, nthreads=1), JU, JD.StreamFormat)
    for a, b in zip(port[1:], jax[1:]):      # one stream, one parse
        if isinstance(a, dict):
            assert a.keys() == b.keys()
            for k in a:
                np.testing.assert_array_equal(a[k], b[k], err_msg=k)
        else:
            np.testing.assert_array_equal(a, b)
    return port, jax


def test_raw_fused_tail_matches_plain_and_jax(golden, count_k1, monkeypatch):
    """pallas=True: K1 once a chunk, PCM within PCM_LSB_TOL of the port's
    plain fast tail (pallas=False, exact=False) and of JAX's pallas=True;
    the carries after the second chunk by value."""
    (fmt, fu8, meta, bias, fc), (jfmt, *_) = golden
    plan = dict(emit_int16=True, steady=True, long_only=True, cpl_fc=fc)
    assert PD.steady_ok(fmt, {"blksw": meta["blksw"].astype(bool),
                              "coeff": meta["coeff"]})
    assert not meta["blksw"].any(), "the golden stream is long-only"
    port = {}
    for pallas in (True, False):
        before = len(count_k1)
        fn = PP.raw_batched_pipeline(fmt, pallas=pallas,
                                     exact=None if pallas else False, **plan)
        carry = (PU.init_unpack_carry(LANES, "cpu"),
                 PP.init_batched_carry(LANES, device="cpu"))
        port[pallas] = _run(fn, carry, _chunks(fu8, meta, bias,
                                               torch.from_numpy),
                            lambda t: t.numpy())
        assert len(count_k1) - before == (NFRAMES // CHUNK if pallas else 0)

    with monkeypatch.context() as mp:
        _jax_gathers(mp)
        mp.setattr(PS, "INTERPRET", True)
        JP._raw_pipeline_cached.cache_clear()
        fn = JP.raw_batched_pipeline(jfmt, pallas=True, **plan)
        carry = (JU.init_unpack_carry(LANES), JP.init_batched_carry(LANES))
        jax = _run(fn, carry, _chunks(fu8, meta, bias, jnp.asarray),
                   np.asarray)
        JP._raw_pipeline_cached.cache_clear()

    (pu, (pd, pm)), pp = port[True]
    for (ou, (od, om)), op in (port[False], jax):
        assert pp.shape == op.shape == (LANES, 6 * NFRAMES, 2, 256)
        assert np.abs(pp - op).max() <= FS.PCM_LSB_TOL
        np.testing.assert_allclose(pd.numpy(), np.asarray(od), rtol=0,
                                   atol=FS.CARRY_ATOL)
        np.testing.assert_array_equal(pm.numpy(), np.asarray(om))
        for k in ("exp", "cplco", "dpos"):
            np.testing.assert_array_equal(pu[k].numpy(), np.asarray(ou[k]),
                                          err_msg=k)
    assert np.abs(pp).max() > 1000, "the golden stream is not silent"


def test_raw_fused_tail_asserts_what_jax_asserts(golden):
    """pallas=True refuses reference mode, a chunk that is not steady or
    not long-only, float output, and a format that cannot be premixed (an
    upmix); an explicit pallas=True with exact=None means fast."""
    fmt = golden[0][0]
    ok = dict(emit_int16=True, steady=True, long_only=True)
    PP.raw_batched_pipeline(fmt, pallas=True, **ok)
    for bad in ({"exact": True}, {"steady": False}, {"long_only": False},
                {"emit_int16": False}):
        with pytest.raises(AssertionError):
            PP.raw_batched_pipeline(fmt, pallas=True, **dict(ok, **bad))
    upmix = PD.StreamFormat(JT.A52_STEREO, JT.A52_3F2R, False, 0)
    assert not (upmix.nf_out < upmix.nfchans or upmix.identity_mix)
    with pytest.raises(AssertionError, match="premixable"):
        PP.raw_batched_pipeline(upmix, pallas=True, **ok)
    # JAX's slot order: (..., cpl_fc, pallas, exp_pts, alloc_pts, exact,
    # emax) binds positionally as there
    with pytest.raises(AssertionError):
        PP.raw_batched_pipeline(fmt, None, True, True, True, -1, True, 6, 6,
                                True)
