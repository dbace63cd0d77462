"""Port: decode state saved by the JAX package resumes in the port, and
the port's files load in the JAX package: the batched carry, and the
single-stream carry with the Python parser's state."""
import jax.numpy as jnp
import numpy as np
import torch

import ac3acm_tpu.tables as JT
from ac3acm_tpu.models.decoder import StreamFormat as JFormat
from ac3acm_tpu.parallel.pipeline import batched_pipeline as jax_pipeline
from ac3acm_tpu.utils.state import load_decode_state as jax_load
from ac3acm_tpu.utils.state import save_decode_state as jax_save
from ac3acm_tpu_torch.models.decoder import StreamFormat
from ac3acm_tpu_torch.ops import fused_steady as FS
from ac3acm_tpu_torch.parallel.pipeline import batched_pipeline
from ac3acm_tpu_torch.utils import state as S

SPEC = (JT.A52_3F2R, JT.A52_STEREO | JT.A52_LFE, False, 0)


def _chunk(rng, B=3, n=12):
    return {"freq": (rng.standard_normal((B, n, 3, 256)) * 0.02
                     ).astype(np.float32),
            "blksw": np.zeros((B, n, 5), bool),
            "bias": np.full((B, n), 384.0, np.float32)}


def test_jax_checkpoint_resumes_in_port(tmp_path):
    rng = np.random.default_rng(4)
    B = 3
    first, second = _chunk(rng, B), _chunk(rng, B)
    jfn = jax_pipeline(JFormat(*SPEC), emit_int16=True, steady=True,
                       long_only=True, premixed=True, pallas=False,
                       exact=False)
    delay0 = (rng.standard_normal((B, 6, 128)) * 0.02).astype(np.float32)
    carry = (jnp.asarray(delay0), jnp.asarray([True, False, True]))
    carry, _ = jfn(carry, first)
    path = str(tmp_path / "state.npz")
    jax_save(path, carry)

    resumed = S.load_decode_state(path, device="cpu")
    delay, downmixed = S.carry_to_numpy(resumed)
    np.testing.assert_array_equal(delay, np.asarray(carry[0]))
    np.testing.assert_array_equal(downmixed, np.asarray(carry[1]))
    assert resumed[0].dtype == torch.float32 and resumed[1].dtype == torch.bool

    # the next chunk from the loaded carry matches JAX's next chunk
    carry_j, pcm_j = jfn(carry, second)
    fn = batched_pipeline(StreamFormat(*SPEC), emit_int16=True, steady=True,
                          long_only=True, premixed=True, exact=False)
    carry_p, pcm_p = fn(resumed, {k: torch.from_numpy(v)
                                  for k, v in second.items()})
    assert np.abs(pcm_p.numpy().astype(np.int64)
                  - np.asarray(pcm_j, np.int64)).max() <= FS.PCM_LSB_TOL
    np.testing.assert_allclose(carry_p[0].numpy(), np.asarray(carry_j[0]),
                               rtol=0, atol=FS.CARRY_ATOL)

    # and the port's checkpoint loads back into JAX unchanged
    path2 = str(tmp_path / "port.npz")
    S.save_decode_state(path2, carry_p)
    (jd, jm), pstate = jax_load(path2)
    assert pstate is None
    np.testing.assert_array_equal(np.asarray(jd), carry_p[0].numpy())
    np.testing.assert_array_equal(np.asarray(jm), carry_p[1].numpy())


def _stream_frames(name):
    from tests.test_torch_parser import _golden_frames
    return _golden_frames(name)


def _resumed_decoder(path):
    """A fresh port Decoder on the CPU with the carry and parser state of
    a checkpoint file."""
    from ac3acm_tpu_torch.models.decoder import Decoder
    dec = Decoder(device="cpu")
    delay, downmixed = S.load_decode_state(path, device="cpu")
    dec._carry = (delay, downmixed)
    dec.parser.s = S.load_parser_state(path)
    return dec


def test_parser_state_round_trip(tmp_path):
    """A single-stream decode checkpointed after 3 frames (carry and
    parser state: the LFSR, the cached bap, the coupling state) resumes in
    a fresh Decoder bit for bit; the file holds no pickle."""
    from ac3acm_tpu_torch.models.decoder import Decoder
    flags = JT.A52_STEREO | JT.A52_ADJUST_LEVEL
    frames = _stream_frames("cpl51_hazard.ac3")
    whole, _ = Decoder(device="cpu").decode_frames(frames, flags)
    dec = Decoder(device="cpu")
    first, _ = dec.decode_frames(frames[:3], flags)
    path = str(tmp_path / "single.npz")
    S.save_decode_state(path, dec._carry, dec.parser)
    with np.load(path, allow_pickle=False) as z:
        assert all(z[k].dtype != object for k in z.files)
    rest, _ = _resumed_decoder(path).decode_frames(frames[3:], flags)
    np.testing.assert_array_equal(np.concatenate([first, rest]), whole)
    S.save_decode_state(str(tmp_path / "carry.npz"), dec._carry)
    assert S.load_parser_state(str(tmp_path / "carry.npz")) is None


def test_jax_parser_checkpoint_resumes_in_port(tmp_path):
    """save_decode_state(..., parser=...) written by the JAX package (its
    A52Parser after 3 frames, beside the carry of those frames) resumes in
    the port: the next frames decode bit for bit as an unbroken decode;
    and the port's file loads back into JAX with every parser field
    equal, its next frame parsing the same."""
    from ac3acm_tpu.host.parse import A52Parser as JaxParser
    from ac3acm_tpu_torch.models.decoder import Decoder
    from tests.test_torch_parser import _same_frame, _same_state
    flags = JT.A52_STEREO | JT.A52_ADJUST_LEVEL
    frames = _stream_frames("cpl51_hazard.ac3")
    whole, _ = Decoder(device="cpu").decode_frames(frames, flags)
    dec = Decoder(device="cpu")
    dec.decode_frames(frames[:3], flags)
    jp = JaxParser()
    for fb in frames[:3]:
        jp.decode_frame(fb, flags, 1.0, 0.0)
    path = str(tmp_path / "jax.npz")
    jax_save(path, S.carry_to_numpy(dec._carry), parser=jp)
    rest, _ = _resumed_decoder(path).decode_frames(frames[3:], flags)
    np.testing.assert_array_equal(rest, whole[18:])

    path2 = str(tmp_path / "port.npz")
    S.save_decode_state(path2, dec._carry, dec.parser)
    (jd, jm), pstate = jax_load(path2)
    np.testing.assert_array_equal(np.asarray(jd), dec._carry[0].numpy())
    np.testing.assert_array_equal(np.asarray(jm), dec._carry[1].numpy())
    _same_state(dec.parser.s, pstate, "loaded in JAX")
    jp2 = JaxParser()
    jp2.s = pstate
    _same_frame(dec.parser.decode_frame(frames[3], flags, 1.0, 0.0),
                jp2.decode_frame(frames[3], flags, 1.0, 0.0), "frame 3")
