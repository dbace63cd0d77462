"""Port: the encoder's quantizer (ops.quantize, kernel Q1) on the CPU,
bitwise against the JAX package.

  * quantize (the port's models/encoder.py:quantize, which delegates to
    ops.quantize: its plain version, quantize_ref, on CPU tensors) equals
    JAX's models/encoder.py:quantize on chip_smoke.py's crafted cases
    (q1_case, what it holds Q1 to on the card): every class 0-15 on every
    row, exponent differences from -21 to 33 (shift counts outside [0, 31]
    for the symmetric classes' << and the asymmetric ones' >>), int32's
    edges, saturating codes; the exponents as int8 (the frame core's form)
    and as int32 (JAX's).  Shift counts further out, both ways, are
    tests/test_torch_mdct.py:test_quantize_shift_extremes' cases.
  * models/encoder.py:quantize takes what JAX's takes (JAX's own frame
    core passes int32 classes): int32 or uint8 classes, int16 exponents,
    a row length that is not a multiple of 4, strided and unaligned
    tensors; on CPU tensors as they come, and brought to Q1's contract
    by _q1_layout (its CUDA route's step) through the kernel's wrapper.
  * frame_core's qmant equals JAX's frame core's on one config.
  * The 16-bit form (codes=torch.int16, what the device-pack path hands
    the packer) is the low 16 bits of JAX's codes: widened by & 0xFFFF
    (code_bits) it equals them, while a sign-extending cast misreads the
    class-15 codes from 32,768 up, which the crafted case reaches.  Only
    encode_pipeline_packed asks frame_core for it: every public function
    that returns qmant returns JAX's int32.
  * The wrapper refuses what the kernel does not take, and a CPU tensor
    never reaches the CUDA build.
"""
import jax
import numpy as np
import pytest
import torch

import chip_smoke as CS
from ac3acm_tpu.models import encoder as JE
from ac3acm_tpu_torch.models import encoder as PE
from ac3acm_tpu_torch.ops import _cuda
from ac3acm_tpu_torch.ops import quantize as QZ


def _case():
    return CS.q1_case(1700)


@pytest.mark.parametrize("exp_dtype", [np.int8, np.int32],
                         ids=["int8", "int32"])
def test_crafted_cases_match_jax(exp_dtype):
    coef, enc, gexp, bap = _case()
    want = np.asarray(jax.jit(JE.quantize)(coef, enc, gexp, bap))
    got = PE.quantize(torch.from_numpy(coef),
                      torch.from_numpy(enc.astype(exp_dtype)),
                      torch.from_numpy(gexp), torch.from_numpy(bap))
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), want)
    # the cases reach what they are for: every class, e at both ends,
    # saturated asymmetric codes
    e = enc - gexp[:, None]
    assert set(np.unique(bap).tolist()) == set(range(16))
    assert e.min() == -21 and e.max() == 33
    q = np.array([1] * 6 + [c - 1 for c in range(6, 14)] + [14, 16])[bap]
    assert ((bap >= 6) & (want == (1 << (q - 1)) - 1)).sum() > 0


@pytest.mark.parametrize("exp_dtype", [np.int8, np.int32],
                         ids=["int8", "int32"])
def test_int16_codes_are_the_low_bits_of_jax(exp_dtype):
    """Q1's plain version in the 16-bit form, widened by & 0xFFFF, equals
    JAX's codes (their low 16 bits where a symmetric class's garbage
    inputs give a negative one); class-15 codes from 32,768 up occur and
    read negative as int16."""
    coef, enc, gexp, bap = _case()
    want = np.asarray(jax.jit(JE.quantize)(coef, enc, gexp, bap))
    args = (torch.from_numpy(coef), torch.from_numpy(enc.astype(exp_dtype)),
            torch.from_numpy(gexp), torch.from_numpy(bap))
    got = QZ.quantize(*args, codes=torch.int16)
    assert got.dtype == torch.int16
    assert torch.equal(got, QZ.quantize_ref(*args, codes=torch.int16))
    wide = QZ.code_bits(got).numpy()
    assert np.array_equal(wide, want & 0xFFFF)
    assert np.array_equal(wide[want >= 0], want[want >= 0])
    high = (bap == 15) & (want >= 32768)
    assert high.sum() > 0 and (got.numpy()[high] < 0).all()
    # the hazard: a sign-extending cast reads them as negative
    assert not np.array_equal(got.to(torch.int32).numpy(), want)


def test_frame_layout_and_leading_axes():
    """The frame core's [N, 6, ch, 256] layout and [F, B, ...] leading
    axes give the same codes as the flat rows."""
    coef, enc, gexp, bap = (torch.from_numpy(a) for a in _case())
    flat = QZ.quantize(coef[:48], enc[:48].to(torch.int8), gexp[:48],
                       bap[:48])
    g = gexp[:48, None].expand(48, 4).reshape(16, 6, 2).contiguous()
    frame = QZ.quantize(coef[:48].reshape(16, 6, 2, 256),
                        enc[:48].to(torch.int8).reshape(16, 6, 2, 256), g,
                        bap[:48].reshape(16, 6, 2, 256))
    lead = QZ.quantize(coef[:48].reshape(2, 8, 6, 2, 256),
                       enc[:48].reshape(2, 8, 6, 2, 256), g.reshape(2, 8, 6,
                                                                   2),
                       bap[:48].reshape(2, 8, 6, 2, 256))
    assert torch.equal(frame.reshape(flat.shape), flat)
    assert torch.equal(lead.reshape(flat.shape), flat)


def test_frame_core_qmant_matches_jax():
    """qmant of the port's frame core (X1's and E1's plain versions, then
    quantize on int8 exponents) equals JAX's frame core's."""
    cfg_j = JE.make_config(48000, 192000, 2)
    cfg_p = PE.make_config(48000, 192000, 2)
    core = JE._frame_core(cfg_j)
    pcm = CS.mixed_pcm(2, 2, 77, 8)                  # [8, 3072, 2]
    blocks = pcm.reshape(8, 12, 256, 2).transpose(0, 1, 3, 2).astype(
        np.int32)
    cur = np.ascontiguousarray(blocks[:, 6:])
    prev = np.ascontiguousarray(blocks[:, 5:11])
    want = np.asarray(jax.jit(lambda c, p: core(c, p)["qmant"])(cur, prev))
    got = PE.frame_core(cfg_p, torch.from_numpy(cur), torch.from_numpy(prev))
    assert np.array_equal(got["qmant"].numpy(), want)
    assert (want != 0).any()


JAX_FORMS = {
    "int32 classes": lambda c, e, g, b: (c, e, g, b.astype(np.int32)),
    "uint8 classes, int16 exponents": lambda c, e, g, b: (
        c, e.astype(np.int16), g, b.astype(np.uint8)),
    "ragged row": lambda c, e, g, b: (c[:, :1021], e[:, :1021], g,
                                      b[:, :1021]),
    "row a multiple of 4, not of 16": lambda c, e, g, b: (
        c[:, :1012], e[:, :1012], g, b[:, :1012]),
}


@pytest.mark.parametrize("form", sorted(JAX_FORMS))
def test_public_quantize_takes_jax_inputs(form):
    """The public quantize equals JAX's on JAX's input forms, with coef
    unaligned and enc_exp strided: on the CPU as the tensors come, and
    after _q1_layout through ops.quantize (which checks Q1's contract)."""
    args = JAX_FORMS[form](*_case())
    want = np.asarray(jax.jit(JE.quantize)(*args))
    t = [torch.from_numpy(np.ascontiguousarray(a)) for a in args]
    t[0] = _offset_view(t[0]).copy_(t[0])
    t[1] = t[1].t().contiguous().t()
    assert not t[1].is_contiguous() and t[0].data_ptr() % 16
    assert np.array_equal(PE.quantize(*t).numpy(), want)
    laid = PE._q1_layout(*t)
    assert laid[0].shape[-1] % QZ.CHUNK == 0
    got = QZ.quantize(*laid)[..., :t[0].shape[-1]]
    assert np.array_equal(got.numpy(), want)


def _good():
    coef, enc, gexp, bap = (torch.from_numpy(a[:4]) for a in _case())
    return [coef.clone(), enc.to(torch.int8), gexp.clone(), bap.clone()]


def _offset_view(t, k=1):
    """t's values in a view k elements past a fresh buffer's start."""
    flat = torch.zeros(t.numel() + 16, dtype=t.dtype)
    return flat[k:k + t.numel()].view(t.shape).copy_(t)


BAD = {
    "coef int64": (0, lambda t: t.long(), TypeError),
    "enc_exp int16": (1, lambda t: t.to(torch.int16), TypeError),
    "enc_exp uint8": (1, lambda t: t.to(torch.uint8), TypeError),
    "global_exp int64": (2, lambda t: t.long(), TypeError),
    "bap int32": (3, lambda t: t.int(), TypeError),
    "coef strided": (0, lambda t: t.t().contiguous().t(), ValueError),
    "coef unaligned": (0, _offset_view, ValueError),
    "bap unaligned": (3, _offset_view, ValueError),
    "coef 1022 a row": (0, lambda t: t[:, :1022].contiguous(), ValueError),
    "coef 1012 a row": (0, lambda t: t[:, :1012].contiguous(), ValueError),
    "enc_exp 4 bytes off": (1, lambda t: _offset_view(t, 4), ValueError),
    "enc_exp short": (1, lambda t: t[:, :-4].contiguous(), ValueError),
    "global_exp short": (2, lambda t: t[:-1], ValueError),
    "bap on meta": (3, lambda t: t.to("meta"), ValueError),
}


@pytest.mark.parametrize("bad", sorted(BAD))
def test_wrapper_refuses(bad):
    """The wrapper's checks hold on the CPU as on the card, and no CPU
    call launches the kernel."""
    args = _good()
    i, make, err = BAD[bad]
    args[i] = make(args[i])
    before = QZ.launches_quantize
    with pytest.raises(err):
        QZ.quantize(*args)
    assert QZ.launches_quantize == before == 0


@pytest.mark.parametrize("codes", [torch.int64, torch.int8, torch.uint16,
                                   "int16"], ids=str)
def test_wrapper_refuses_codes(codes):
    """Codes come as int32 or int16 and in no other form."""
    with pytest.raises(TypeError):
        QZ.quantize(*_good(), codes=codes)
    assert QZ.launches_quantize == 0


def test_only_the_device_pack_path_asks_for_int16(monkeypatch):
    """frame_core gets codes=torch.int16 from encode_pipeline_packed and
    from no other route; the packer gets those codes; every route that
    hands a caller qmant gives int32 (encode_pipeline, its multi form,
    BatchedEncoder with the native packer, Encoder); both packers give the
    same bytes."""
    from ac3acm_tpu_torch.ops import pack_device as PD
    from ac3acm_tpu_torch.parallel.encode import BatchedEncoder
    seen, packed = [], []
    core, pack = PE.frame_core, PD.pack_frames_device

    def core_spy(*a, **k):
        out = core(*a, **k)
        seen.append(out["qmant"].dtype)
        return out

    def pack_spy(cfg, bap, qmant, *rest, **k):
        packed.append(qmant.dtype)
        return pack(cfg, bap, qmant, *rest, **k)

    monkeypatch.setattr(PE, "frame_core", core_spy)
    monkeypatch.setattr(PD, "pack_frames_device", pack_spy)
    cfg = PE.make_config(48000, 192000, 2)
    pcm = CS.mixed_pcm(2, 2, 31, 2)                       # [2, 3072, 2]
    x = torch.from_numpy(np.ascontiguousarray(
        pcm.reshape(2, 2, 1536, 2).transpose(1, 0, 2, 3)))
    last = torch.zeros((2, 2, 256), dtype=torch.int32)
    csnr = torch.full((2,), 40, dtype=torch.int32)
    one = PE.encode_pipeline(cfg)(x[0], last, csnr)
    _, multi = PE.encode_pipeline_multi(cfg)(x, last, csnr)
    assert one["qmant"].dtype == multi["qmant"].dtype == torch.int32
    assert torch.equal(multi["qmant"][0], one["qmant"])
    assert seen == [torch.int32] * 2 and not packed
    native = BatchedEncoder(2, 48000, 192000, 2, pack="native",
                            device="cpu").encode_frames(pcm)
    PE.Encoder(48000, 192000, 2, device="cpu").encode(pcm[0])
    assert seen == [torch.int32] * 4 and not packed
    device = BatchedEncoder(2, 48000, 192000, 2,
                            device="cpu").encode_frames(pcm)
    assert seen[4:] == [torch.int16] and packed == [torch.int16]
    assert device == native


def test_cpu_never_reaches_the_cuda_build(monkeypatch):
    """CPU tensors take the plain version: the CUDA build is never
    touched and the launch count never moves; no coefficients, no codes."""
    def refuse(*a, **k):
        raise AssertionError("a CPU call reached the CUDA route")

    monkeypatch.setattr(_cuda, "load", refuse)
    monkeypatch.setattr(_cuda, "build", refuse)
    args = _good()
    assert torch.equal(QZ.quantize(*args), QZ.quantize_ref(*args))
    for codes in (torch.int32, torch.int16):
        none = QZ.quantize(*(a[:0] for a in args), codes=codes)
        assert none.shape == (0, args[0].shape[1]) and none.dtype == codes
    assert QZ.launches_quantize == 0
