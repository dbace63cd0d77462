"""Port: the encoder (frame core, BatchedEncoder, Encoder, PcmToAc3Stream,
the a52 encode API, encode state) vs the JAX package.

The same seeded numpy PCM goes through the JAX encoder (jitted on the
CPU) and the port's (device="cpu"); fields and bytes are held to
equality.  The single-stream tests share one format (2.0, 48 kHz,
192 kbps) and feed frames so that the JAX side compiles few shapes: a
JAX encode compiles in about 8 s a shape on this CPU.
"""
import numpy as np
import pytest
import torch

import ac3acm_tpu.tables as JT
from ac3acm_tpu import a52 as JA52
from ac3acm_tpu.io import stream as JS
from ac3acm_tpu.models import encoder as JE
from ac3acm_tpu.parallel.encode import BatchedEncoder as JaxBatched
from ac3acm_tpu.utils import state as JST
from ac3acm_tpu_torch import a52 as PA52
from ac3acm_tpu_torch.io import stream as PS
from ac3acm_tpu_torch.models import encoder as PE
from ac3acm_tpu_torch.parallel.encode import BatchedEncoder
from ac3acm_tpu_torch.utils import state as PST
from tests.test_decode import make_pcm

FIELDS = ("bap", "qmant", "enc_exp", "strat", "fsnroffst", "new_last",
          "csnroffst", "ok", "new_csnr")


def mixed_pcm(nch, nframes, seed, lanes=1):
    """Seeded PCM [lanes, nframes*1536, nch] int16 mixing tones, noise,
    silence and full-scale segments (exponent reuse, every strategy,
    grouped mantissas and overrange exponents all occur)."""
    rng = np.random.default_rng(seed)
    n = nframes * 1536
    t = np.arange(n)[None, :, None]
    f = rng.uniform(40, 9000, (lanes, 1, nch))
    x = 0.5 * np.sin(2 * np.pi * f * t / 48000 + rng.uniform(0, 6, f.shape))
    x += rng.choice([0.0, 0.02, 0.3], (lanes, 1, nch)) \
        * rng.standard_normal((lanes, n, nch))
    x *= 20000
    seg = rng.integers(0, 4, (lanes, n // 256 + 1, 1))
    seg = np.repeat(seg, 256, axis=1)[:, :n]
    x = np.where(seg == 0, 0.0, x)                                # silence
    sq = np.where((t // 37) % 2 == 0, 32767.0, -32768.0)
    x = np.where(seg == 1, np.broadcast_to(sq, x.shape), x)       # full scale
    return np.clip(np.round(x), -32768, 32767).astype(np.int16)


@pytest.mark.parametrize("nch,freq,kbps", [
    (2, 48000, 192), (6, 48000, 640), (1, 32000, 96), (2, 44100, 128)])
def test_encode_pipeline_fields_match_jax(nch, freq, kbps):
    """Every field of encode_pipeline, bitwise, from a random carry (the
    carried csnroffst decides `ok`)."""
    cfg_j = JE.make_config(freq, kbps * 1000, nch)
    cfg_p = PE.make_config(freq, kbps * 1000, nch)
    assert cfg_j.__dict__ == cfg_p.__dict__
    B = 6
    pcm = mixed_pcm(nch, 1, nch * 31 + kbps, B)[:, :1536]
    rng = np.random.default_rng(kbps)
    last = rng.integers(-32768, 32768, (B, nch, 256)).astype(np.int32)
    last[0] = 0
    csnr = rng.integers(0, 64, B).astype(np.int32)
    csnr[0] = 40
    rj = JE.encode_pipeline(cfg_j)(pcm, last, csnr)
    rp = PE.encode_pipeline(cfg_p)(torch.from_numpy(pcm),
                                   torch.from_numpy(last),
                                   torch.from_numpy(csnr))
    assert set(rp) == set(FIELDS)
    for k in FIELDS:
        a, b = rp[k].numpy(), np.asarray(rj[k])
        assert a.shape == b.shape and a.dtype == b.dtype, k
        assert np.array_equal(a, b), k
    assert rp["ok"].any()


def test_batched_encoder_matches_jax(monkeypatch):
    """encode_frames bytes equal JAX's BatchedEncoder in both pack modes;
    F encode_step calls equal one encode_frames; the frame grouping of the
    core (CORE_ROWS) does not change a byte."""
    pcm = mixed_pcm(2, 4, 5, 3)
    want = JaxBatched(3, 48000, 192000, 2, pack="native").encode_frames(pcm)
    for pack in ("device", "native"):
        got = BatchedEncoder(3, 48000, 192000, 2, pack=pack,
                             device="cpu").encode_frames(pcm)
        assert got == want, pack
    steps = BatchedEncoder(3, 48000, 192000, 2, device="cpu")
    per = [steps.encode_step(pcm[:, f * 1536:(f + 1) * 1536])
           for f in range(4)]
    assert [b"".join(p[b] for p in per) for b in range(3)] == want
    for rows in (1, 2, 3, 12):                 # 1, 1, 1 and 4 frames a call
        monkeypatch.setattr(PE, "CORE_ROWS", rows)
        enc = BatchedEncoder(3, 48000, 192000, 2, device="cpu")
        assert enc.encode_frames(pcm) == want, rows
    with pytest.raises(ValueError):
        BatchedEncoder(3, 48000, 192000, 2, pack="host", device="cpu")


def test_encoder_chmap_and_chunk_boundary():
    """A 17-frame call crosses Encoder.CHUNK (16); with a channel map;
    equal to JAX's Encoder, and to lane 0 of a BatchedEncoder."""
    pcm = mixed_pcm(2, 17, 9)[0]
    jax_out = JE.Encoder(48000, 192000, 2, chmap=[1, 0]).encode(pcm)
    enc = PE.Encoder(48000, 192000, 2, chmap=[1, 0], device="cpu")
    assert enc.frame_bytes == 768
    got = enc.encode(pcm)
    assert got == jax_out and len(got) == 17 * 768
    lane = BatchedEncoder(1, 48000, 192000, 2, device="cpu").encode_frames(
        pcm[None, :, ::-1])
    assert lane[0] == got


def test_encoder_is_reentrant_and_rate_failure_raises():
    pcm_a = make_pcm(2, 2, seed=31)
    pcm_b = make_pcm(2, 2, seed=32)
    ea = PE.Encoder(48000, 192000, 2, device="cpu")
    eb = PE.Encoder(48000, 192000, 2, device="cpu")
    out_a = ea.encode(pcm_a[:1536])
    out_b = eb.encode(pcm_b[:1536])
    out_a += ea.encode(pcm_a[1536:])
    out_b += eb.encode(pcm_b[1536:])
    assert PE.Encoder(48000, 192000, 2, device="cpu").encode(pcm_a) == out_a
    assert PE.Encoder(48000, 192000, 2, device="cpu").encode(pcm_b) == out_b
    # 32 kbps stereo cannot fit: rate control fails, as in the JAX package
    with pytest.raises(RuntimeError):
        PE.Encoder(48000, 32000, 2, device="cpu").encode(make_pcm(2, 1, 8))
    with pytest.raises(RuntimeError):
        BatchedEncoder(2, 48000, 32000, 2, device="cpu").encode_frames(
            np.stack([make_pcm(2, 1, 8)] * 2))
    for bad in ((11000, 96000, 2), (48000, 33000, 2), (48000, 192000, 7)):
        with pytest.raises(ValueError):
            PE.make_config(*bad)


def test_pcm_stream_a52_and_state_match_jax(tmp_path):
    """PcmToAc3Stream with ragged feeds, AC3_encode_init/frame and the
    encode state (saved by one package, loaded by the other) equal the
    JAX package's bytes."""
    pcm = mixed_pcm(2, 20, 11)[0]
    fmt_j = JS.Ac3Format(2, 48000, 192)
    fmt_p = PS.Ac3Format(2, 48000, 192)
    sj, sp = JS.PcmToAc3Stream(fmt_j), PS.PcmToAc3Stream(fmt_p, device="cpu")
    # each feed yields 0, 1 or 16 frames (the JAX side compiles two shapes)
    cuts = [0, 1000, 3000, 3000 + 1536 * 16, 3100 + 1536 * 16,
            4708 + 1536 * 16]
    outs_j, outs_p = [], []
    for a, b in zip(cuts[:-1], cuts[1:]):
        outs_j.append(sj.convert(pcm[a:b]))
        outs_p.append(sp.convert(pcm[a:b]))
    assert outs_p == outs_j
    assert [len(o) // 768 for o in outs_p] == [0, 1, 16, 1, 1]
    assert b"".join(outs_p) == PE.Encoder(
        48000, 192000, 2, device="cpu").encode(pcm[:19 * 1536])
    assert len(sp.carry) == len(sj.carry) == 100

    ej = JA52.AC3_encode_init(48000, 192000, 2)
    ep = PA52.AC3_encode_init(48000, 192000, 2, device="cpu")
    for f in range(2):
        fr = pcm[f * 1536:(f + 1) * 1536].reshape(-1)
        assert PA52.AC3_encode_frame(ep, fr, chmap=[1, 0]) == \
            JA52.AC3_encode_frame(ej, fr, chmap=[1, 0])
    # JAX state -> port, and port state -> JAX, each continues identically
    nxt = pcm[2 * 1536:3 * 1536]
    JST.save_encode_state(str(tmp_path / "j.npz"), ej.last, ej.csnroffst)
    PST.save_encode_state(str(tmp_path / "p.npz"), ep.last, ep.csnroffst)
    for src in ("j.npz", "p.npz"):
        p2 = PE.Encoder(48000, 192000, 2, device="cpu")
        p2.last, p2.csnroffst = PST.load_encode_state(str(tmp_path / src),
                                                      device="cpu")
        assert p2.last.dtype == torch.int32 and p2.last.shape == (1, 2, 256)
        j2 = JE.Encoder(48000, 192000, 2)
        j2.last, j2.csnroffst = JST.load_encode_state(str(tmp_path / src))
        assert p2.encode(nxt[:, ::-1]) == j2.encode(nxt[:, ::-1]), src
    with np.load(str(tmp_path / "p.npz")) as z, \
            np.load(str(tmp_path / "j.npz")) as zj:
        assert set(z.files) == set(zj.files) == {"last", "csnr"}
        for k in z.files:
            assert z[k].dtype == zj[k].dtype and np.array_equal(z[k], zj[k])


def test_roundtrip_through_port_decoder():
    """encode -> the port's Decoder -> SNR against the original PCM above
    the JAX test's 12 dB."""
    from ac3acm_tpu_torch.models.decoder import Decoder
    pcm = make_pcm(2, 3, seed=21)
    es = PE.Encoder(48000, 192000, 2, device="cpu").encode(pcm)
    out, fmt = Decoder(device="cpu").decode_stream(
        es, JT.A52_STEREO | JT.A52_ADJUST_LEVEL, level=1.0, bias=0.0)
    assert fmt.nch_out == 2
    mine = np.moveaxis(np.asarray(out), 1, 2).reshape(-1, 2) * 32768.0
    mine = mine[256:]                        # the codec chain's latency
    orig = pcm[: mine.shape[0]].astype(np.float64)
    snr = 10 * np.log10((orig ** 2).mean() / ((mine - orig) ** 2).mean())
    assert snr > 12.0, snr
