"""Port: a decode carry saved by the JAX package resumes in the port."""
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
