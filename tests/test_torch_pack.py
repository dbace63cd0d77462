"""Port: the frame packers vs the JAX package.

Frame fields from the port's encoder (device="cpu") go through the JAX
package's numpy-only host/pack.py:pack_frame (no compile) and the port's
three packers: its copy of pack_frame, the threaded native packer and the
device packer (ops/pack_device.py).  All four must agree byte for byte,
on the configs of tests/test_encoder.py::test_device_packer_byte_identity
and at all 19 bitrates.  The encoder digests chip_smoke.py holds the card
to are recomputed here from the JAX package's BatchedEncoder.
"""
import numpy as np
import pytest
import torch

import ac3acm_tpu.tables as JT
import chip_smoke as CS
from ac3acm_tpu.host import pack as JP
from ac3acm_tpu.parallel.encode import BatchedEncoder as JaxBatched
from ac3acm_tpu_torch.host import pack as PP
from ac3acm_tpu_torch.models import encoder as PE
from ac3acm_tpu_torch.ops import pack_device as PD
from ac3acm_tpu_torch.parallel.encode import BatchedEncoder
from tests.test_decode import make_pcm

KEYS = ("bap", "qmant", "enc_exp", "strat", "csnroffst", "fsnroffst")


def _fields(cfg, pcm):
    """pcm [B, 1536, nch] -> the port encoder's fields as numpy."""
    B = pcm.shape[0]
    res = PE.encode_pipeline(cfg)(
        torch.from_numpy(pcm), torch.zeros((B, cfg.channels, 256),
                                           dtype=torch.int32),
        torch.full((B,), 40, dtype=torch.int32))
    res = {k: v.numpy() for k, v in res.items()}
    assert res["ok"].all()
    return res


def _all_packers_agree(cfg, res):
    B = res["bap"].shape[0]
    want = [JP.pack_frame(cfg, res, b) for b in range(B)]
    assert [PP.pack_frame(cfg, res, b) for b in range(B)] == want
    assert PP.pack_frames_native(cfg, res) == want
    dev = PD.pack_frames_device(cfg, *(torch.from_numpy(res[k])
                                       for k in KEYS))
    assert dev.dtype == torch.uint8 and dev.shape == (B, cfg.frame_size * 2)
    assert [dev[b].numpy().tobytes() for b in range(B)] == want
    return want


@pytest.mark.parametrize("nch,freq,kbps", [
    (2, 48000, 192), (6, 48000, 640), (2, 44100, 128), (1, 32000, 96),
    (3, 48000, 256), (4, 48000, 384), (5, 48000, 448), (6, 44100, 448),
    (1, 48000, 64), (2, 48000, 640),
])
def test_packers_byte_identity(nch, freq, kbps):
    cfg = PE.make_config(freq, kbps * 1000, nch)
    pcm = np.concatenate([
        CS.mixed_pcm(nch, 1, nch * 3 + kbps, 3)[:, :1536],
        (np.random.default_rng(kbps).standard_normal((1, 1536, nch))
         * 8000).astype(np.int16)])
    _all_packers_agree(cfg, _fields(cfg, pcm))


def test_all_19_bitrates():
    """Every standard bitrate: quiet mono content fits at each one, and
    the four packers agree; the leading axes of the device packer's input
    are kept ([F, B, ...] in, [F, B, bytes] out)."""
    pcm = (make_pcm(1, 1, seed=77) // 64).astype(np.int16)
    for kbps in [int(b) for b in JT.BIT_RATES]:
        cfg = PE.make_config(48000, kbps * 1000, 1)
        res = _fields(cfg, np.stack([pcm, pcm[::-1]]))
        want = _all_packers_agree(cfg, res)
        two = PD.pack_frames_device(cfg, *(torch.from_numpy(res[k])[None]
                                           for k in KEYS))
        assert two.shape == (1, 2, cfg.frame_size * 2)
        assert [two[0, b].numpy().tobytes() for b in range(2)] == want


def test_mant_tokens_grouping_edges():
    """Grouped classes across channel boundaries, incomplete last groups
    and rows without members: the device packer's heads against a direct
    walk of the reference's combine loop (host/pack.py:pack_frame)."""
    rng = np.random.default_rng(3)
    R, L = 7, 446
    cls = rng.choice([0, 1, 2, 3, 4, 5, 9, 15], (R, L)).astype(np.int8)
    cls[0] = 0
    cls[1] = 1
    cls[2, :-1] = 4
    q = rng.integers(0, 11, (R, L)).astype(np.int32)
    lens, vals = PD._mant_tokens(torch.from_numpy(cls), torch.from_numpy(q))
    groups = {1: (3, 5, (9, 3, 1)), 2: (3, 7, (25, 5, 1)), 4: (2, 7, (11, 1))}
    for r in range(R):
        members = {c: [i for i in range(L) if cls[r, i] == c] for c in groups}
        for c, (g, bits, mults) in groups.items():
            idx = members[c]
            for k, i in enumerate(idx):
                if k % g:
                    assert int(lens[r, i]) == 0
                    continue
                want = sum(m * int(q[r, idx[k + j]]) for j, m in
                           enumerate(mults) if k + j < len(idx))
                assert (int(lens[r, i]), int(vals[r, i])) == (bits, want)


@pytest.mark.parametrize("config", CS.ENC_DIGEST_CONFIGS)
def test_chip_smoke_encoder_digests(config):
    """chip_smoke.py's encoder digests, recomputed from the JAX package's
    BatchedEncoder; the port on the CPU gives them too."""
    jax_digest, _ = CS.encode_digest(
        lambda *a: JaxBatched(*a, pack="native"), config)
    assert jax_digest == CS.ENC_DIGESTS[config]
    port_digest, _ = CS.encode_digest(
        lambda *a: BatchedEncoder(*a, device="cpu"), config)
    assert port_digest == CS.ENC_DIGESTS[config]
