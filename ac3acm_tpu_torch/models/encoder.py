"""AC-3 encoder on tensors: bit-exact frames of the reference encoder.

Capability parity with the reference encoder (fccHandler/Bellard ac3enc,
ac3enc.cpp), batched over streams:

  * the six blocks x channels x streams window, normalize and MDCT in one
    call (ops.window_mdct: kernel M1 on the card; ops.mdct, the reference's
    int16 block-float arithmetic, is its plain version),
  * the raw exponents, exponent strategy, reuse folding and the
    delta-constraint encoding in one call (ops.exponents: kernel X1 on the
    card; the reference's iterative constraint loop, ac3enc.cpp:730-747,
    is replaced by its fixpoint: the largest 2-Lipschitz array below the
    group minima, one min-plus scan each way),
  * the masking curve of the coded exponents, the SNR-offset hill climb
    (ac3enc.cpp:918-975) replayed exactly by a binary search over the
    monotone bit cost, and the bap at the chosen offset, in one call
    (ops.snr_search: kernel E1 on the card),
  * quantization (ac3enc.cpp:1149-1190) elementwise, wrapping as the
    reference's int32 does (ops.quantize: kernel Q1 on the card); the
    codes are int32 (JAX's dtype) in every field a caller gets, and their
    16-bit form only between Q1 and the device packer inside
    encode_pipeline_packed.

Packing is host.pack (one frame in Python, or the threaded C++ packer) or
ops.pack_device (frames assembled on the device).  Encoder state per
stream is explicit, (last_samples, csnroffst), so the encoder is
reentrant and batchable.
"""
from __future__ import annotations

from dataclasses import dataclass
from functools import lru_cache

import numpy as np
import torch

from .. import tables as T
from ..ops import exponents as EX
from ..ops import quantize as QZ
from ..ops.exponents import EXP_NEW, exponents  # EXP_NEW: JAX's name here
from ..ops.snr_search import snr_search
from ..ops.window_mdct import window_mdct
from ..utils.device import resolve_device

FRAME_BITS_INC = (0, 0, 2, 2, 2, 4, 2, 4)
ACMOD_BY_NCH = (1, 2, 3, 6, 7, 7)      # ac3enc.cpp:1029-1036

# lane-frames per call of the frame core: a multi-frame encode of B lanes
# runs max(1, CORE_ROWS // B) frames a call (the core does not depend on
# the carry, so any grouping gives the same bytes).  Fewer, larger calls
# launch fewer small ops; peak memory grows with the rows (on an H100, 5.1
# at 16,384 rows: about 10 GB, set by the MDCT; chip_smoke.py's encode
# phase times the forms and gives each stage's peak)
CORE_ROWS = 16384


@dataclass(frozen=True)
class EncoderConfig:
    channels: int                      # 1..6 (6 => 5.1)
    fscod: int
    halfratecod: int
    frmsizecod: int
    frame_size: int                    # in 16-bit words
    bit_rate: int                      # kbit/s (full-rate table value)

    @property
    def acmod(self) -> int:
        return ACMOD_BY_NCH[self.channels - 1]

    @property
    def lfe(self) -> bool:
        return self.channels == 6

    @property
    def nfchans(self) -> int:
        return min(self.channels, 5)

    @property
    def nb_coefs(self):
        n = [223] * self.nfchans
        if self.lfe:
            n.append(7)
        return tuple(n)

    @property
    def sample_rate(self) -> int:
        return int(T.SAMPLE_RATES[self.fscod]) >> self.halfratecod


def make_config(freq: int, bitrate: int, channels: int) -> EncoderConfig:
    """AC3_encode_init parameter selection (ac3enc.cpp:1019-1110)."""
    if not 1 <= channels <= 6:
        raise ValueError("channels must be 1..6")
    fscod = halfratecod = None
    for hr in range(3):
        for j in range(3):
            if (int(T.SAMPLE_RATES[j]) >> hr) == freq:
                fscod, halfratecod = j, hr
                break
        if fscod is not None:
            break
    if fscod is None:
        raise ValueError(f"unsupported sample rate {freq}")
    kbps = bitrate // 1000
    idx = None
    for i in range(19):
        if (int(T.BIT_RATES[i]) >> halfratecod) == kbps:
            idx = i
            break
    if idx is None:
        raise ValueError(f"unsupported bitrate {bitrate}")
    frame_size = kbps * 1000 * T.FRAME_SAMPLES // (freq * 16)
    return EncoderConfig(channels=channels, fscod=fscod,
                         halfratecod=halfratecod, frmsizecod=idx << 1,
                         frame_size=frame_size, bit_rate=int(T.BIT_RATES[idx]))


# ---------------------------------------------------------------------------
# the exponent stage (ops.exponents, kernel X1) and the quantizer
# (ops.quantize, kernel Q1); the plain versions' steps keep their names here
# ---------------------------------------------------------------------------

_encode_exp_static = EX.encode_exp_static


def _strategy(cfg: EncoderConfig, exp):
    """exp [N, 6, ch, 256] -> (new [N, 6, ch] bool: the block starts a
    run, strat [N, 6, ch] int32), ac3enc.cpp:617-668."""
    return EX.strategy(exp, cfg.lfe)


def _encode_exponents(cfg: EncoderConfig, exp, new, strat):
    """Reuse folding + exponent coding: -> (enc_exp [N, 6, ch, 256] int32,
    exponent bits [N])."""
    return EX.encode_exponents(exp, new, strat, cfg.nb_coefs[0], cfg.lfe)


def quantize(coef, enc_exp, global_exp, bap):
    """Raw per-coefficient quantized codes (before group combining), every
    int32 step of the reference wrapped as it is there.  It takes what
    JAX's quantize takes: integer tensors of any width and layout, any
    row length; -> int32 codes.  CPU tensors run ops.quantize's plain
    version as they come; CUDA tensors are brought to kernel Q1's
    contract (_q1_layout) and launch it once."""
    if coef.device.type == "cpu":
        return QZ.quantize_ref(coef, enc_exp, global_exp, bap)
    k = coef.shape[-1]
    return QZ.quantize(*_q1_layout(coef, enc_exp, global_exp, bap))[..., :k]


def _q1_layout(coef, enc_exp, global_exp, bap):
    """coef, enc_exp, global_exp, bap as ops.quantize's kernel takes them:
    coef and global_exp int32, enc_exp int8 or else int32, bap int8
    (classes fit a byte), each contiguous and 16-byte aligned, the rows
    padded with bins of class 0 to a multiple of 16 (QZ.CHUNK)."""
    pad = -coef.shape[-1] % QZ.CHUNK
    if enc_exp.dtype != torch.int8:
        enc_exp = enc_exp.to(torch.int32)
    rows = []
    for t in (coef.to(torch.int32), enc_exp, bap.to(torch.int8)):
        if pad:
            t = torch.nn.functional.pad(t, (0, pad))
        t = t.contiguous()
        if t.data_ptr() % 16:
            t = t.clone()
        rows.append(t)
    return rows[0], rows[1], global_exp.to(torch.int32).contiguous(), rows[2]


# ---------------------------------------------------------------------------
# the frame core
# ---------------------------------------------------------------------------

def _frame_constants(cfg: EncoderConfig):
    """(fixed side-info bits, available bits) of a frame (ac3enc.cpp:
    881-916); the only dynamic side info is 8 bits per non-REUSE fbw
    (block, channel) for chbwcod+gainrng, plus the exponents."""
    nf, nch = cfg.nfchans, cfg.channels
    fixed = 65 + FRAME_BITS_INC[cfg.acmod]
    for _ in range(6):
        fixed += nf * 2 + 2
        if cfg.acmod == 2:
            fixed += 1
        fixed += 2 * nf
        if cfg.lfe:
            fixed += 1
        fixed += 1 + 1 + 2
    fixed += 1
    fixed += 2 * 4 + 3 + 6 + nch * (4 + 3)
    fixed += 2 + 16
    return fixed, 16 * cfg.frame_size


@lru_cache(maxsize=16)
def _mask_tables(cfg: EncoderConfig, device: torch.device):
    """(live bins of each channel [ch] int32, is_lfe [ch], hearing
    threshold [50] int32) on `device`."""
    nb = torch.as_tensor(cfg.nb_coefs, dtype=torch.int32, device=device)
    is_lfe = torch.zeros(cfg.channels, dtype=torch.bool, device=device)
    if cfg.lfe:
        is_lfe[cfg.nfchans] = True
    hth = torch.as_tensor(T.HTH[:, cfg.fscod].astype(np.int32),
                          device=device)
    return nb, is_lfe, hth


def frame_core(cfg: EncoderConfig, cur, prev, clock=None,
               codes=torch.int32):
    """(cur, prev) -> frame-fields dict over a flat leading batch.

    cur/prev [N, 6, ch, 256] int32: a frame's blocks and the overlapped
    blocks before them (prev[:, 0] is the frame before's last block).
    Returns every field but the csnroffst bookkeeping: "M" is the largest
    feasible coarse offset, which does not depend on the carried
    csnroffst (see _csnr_fixup).

    clock: an object with mark(name), called after each stage.
    codes: qmant's dtype, torch.int32 (JAX's) or torch.int16 (the low 16
    bits, which only the device packer reads: encode_pipeline_packed)."""
    mark = clock.mark if clock is not None else (lambda name: None)
    nf = cfg.nfchans
    # a view (encode_pipeline's transposed blocks) is copied; M1 takes
    # contiguous blocks
    coef, exp_samples = window_mdct(prev.contiguous(), cur.contiguous())
    mark("window + normalize + MDCT")                     # [N,6,ch,256]
    # coef's overrange values are zeroed in place
    enc_exp, strat, exp_bits = exponents(coef, exp_samples, cfg.nb_coefs[0],
                                         cfg.lfe)
    mark("exponents + strategy + coding")
    enc8 = enc_exp.view(torch.uint8)               # the bytes as & 0xFF
    fbw_new = (strat[:, :, :nf] != T.EXP_REUSE).sum(dim=(1, 2),
                                                    dtype=torch.int32)
    fixed, total = _frame_constants(cfg)
    avail = total - (fixed + exp_bits + 8 * fbw_new)
    M, fstar, bap = snr_search(enc8, avail, *_mask_tables(cfg, cur.device),
                               cfg.halfratecod)
    mark("masking curve + SNR search + bap")
    qmant = QZ.quantize(coef, enc_exp, exp_samples, bap, codes=codes)
    mark("quantize")
    return dict(bap=bap, qmant=qmant, enc_exp=enc8, strat=strat,
                M=M, fsnroffst=fstar, new_last=cur[:, 5])


def _csnr_fixup(res, csnroffst):
    """The carried-csnroffst bookkeeping of one frame: ok <=> the
    reference's down pass finds a fit from the carried start
    (M >= csnr & 3); cstar = M then.  On !ok every caller raises (the
    reference prints its error and aborts the frame), so the fields of
    such lanes are don't-cares."""
    M = res.pop("M")
    ok = M >= (csnroffst & 3)
    cstar = torch.where(ok, M, csnroffst)
    return dict(res, csnroffst=cstar, ok=ok, new_csnr=cstar)


def _blocks(samples, nch):
    """samples [..., 1536, nch] -> blocks [..., 6, nch, 256] int32."""
    lead = samples.shape[:-2]
    return samples.to(torch.int32).reshape(lead + (6, 256, nch)) \
        .transpose(-1, -2)


def encode_pipeline(cfg: EncoderConfig):
    """-> fn(samples [B, 1536, nch] int (any width), last [B, ch, 256]
    int32, csnroffst [B] int32) -> dict of frame fields + new carry."""
    def run(samples, last, csnroffst):
        cur = _blocks(samples, cfg.channels)
        prev = torch.cat([last[:, None], cur[:, :5]], dim=1)
        return _csnr_fixup(frame_core(cfg, cur, prev), csnroffst)
    return run


def _frame_groups(cfg: EncoderConfig, samples, last, clock=None,
                  codes=torch.int32):
    """samples [F, B, 1536, nch], last [B, ch, 256] -> yields the core
    result (leading [n, B]) of each group of n = max(1, CORE_ROWS // B)
    consecutive frames, in order (qmant as `codes`: see frame_core)."""
    F, B = samples.shape[:2]
    cur = _blocks(samples, cfg.channels)                  # [F,B,6,ch,256]
    step = max(1, CORE_ROWS // B)
    for f0 in range(0, F, step):
        n = min(step, F - f0)
        c = cur[f0:f0 + n]
        first = last[None] if f0 == 0 else cur[f0 - 1:f0, :, 5]
        before = torch.cat([first, c[:-1, :, 5]], dim=0)  # [n, B, ch, 256]
        p = torch.cat([before[:, :, None], c[:, :, :5]], dim=2)
        c = c.reshape((n * B,) + c.shape[2:])
        p = p.reshape((n * B,) + p.shape[2:])
        if clock is not None:
            clock.mark("block layout")
        res = frame_core(cfg, c, p, clock, codes)
        yield {k: v.reshape((n, B) + v.shape[1:]) for k, v in res.items()}


def _replay_csnr(res, csnr):
    """_csnr_fixup through a group's frames in order: -> (fields with
    csnroffst, ok and new_csnr per frame, the carry out)."""
    M = res.pop("M")
    steps = []
    for f in range(M.shape[0]):
        steps.append(_csnr_fixup({"M": M[f]}, csnr))
        csnr = steps[-1]["new_csnr"]
    return dict(res, **{k: torch.stack([r[k] for r in steps])
                        for k in steps[0]}), csnr


def encode_pipeline_multi(cfg: EncoderConfig):
    """-> fn(samples [F, B, 1536, nch], last, csnr) -> ((last', csnr'),
    fields with a leading [F] axis): the frames in groups of
    max(1, CORE_ROWS // B), the csnroffst carry replayed frame by frame;
    the same fields as F calls of encode_pipeline."""
    def multi(samples, last, csnr):
        outs = []
        for res in _frame_groups(cfg, samples, last):
            res, csnr = _replay_csnr(res, csnr)
            outs.append(res)
        outs = {k: torch.cat([o[k] for o in outs]) for k in outs[0]}
        return (outs["new_last"][-1], csnr), outs
    return multi


def encode_pipeline_packed(cfg: EncoderConfig, clock=None):
    """-> fn(samples [F, B, 1536, nch] int, last, csnr) -> ((last', csnr'),
    ok [F, B] bool, frames [F, B, frame_size*2] uint8), all on the
    samples' device: the dense fields never leave it, each frame group is
    packed as soon as it is encoded (ops.pack_device), its codes handed
    from Q1 to the packer in their 16-bit form.

    clock: an object with mark(name), called after the block layout,
    each frame_core stage, the csnr carry and each pack stage."""
    from ..ops.pack_device import pack_frames_device

    def full(samples, last, csnr):
        oks, frames = [], []
        for res in _frame_groups(cfg, samples, last, clock, torch.int16):
            res, csnr = _replay_csnr(res, csnr)
            if clock is not None:
                clock.mark("csnr carry")
            oks.append(res["ok"])
            frames.append(pack_frames_device(
                cfg, res["bap"], res["qmant"], res["enc_exp"], res["strat"],
                res["csnroffst"], res["fsnroffst"], clock))
            last = res["new_last"][-1]
        return (last, csnr), torch.cat(oks), torch.cat(frames)

    return full


def rate_failures(ok) -> list:
    """ok [..., B] bool tensor -> up to 8 failing (frame, stream) indices
    (empty when every frame fits)."""
    ok = ok.cpu()
    if bool(ok.all()):
        return []
    return torch.nonzero(~ok)[:8].tolist()


# ---------------------------------------------------------------------------
# public encoder
# ---------------------------------------------------------------------------

class Encoder:
    """AC3_encode_init / AC3_encode_frame parity, reentrant & batchable.

    >>> enc = Encoder(48000, 192000, 2)
    >>> frames = enc.encode(pcm_int16)     # pcm [n*1536, nch] interleaved

    device: None -> the CUDA card (raises without one); "cpu" runs the
    plain PyTorch path.  Frames are packed on the host by the native
    packer, as in the JAX package."""

    # frames per device call; longer encodes run in chunks of this many
    CHUNK = 16

    def __init__(self, freq: int, bitrate: int, channels: int,
                 chmap=None, device=None):
        self.device = resolve_device(device)
        self.cfg = make_config(freq, bitrate, channels)
        self.chmap = np.arange(channels) if chmap is None \
            else np.asarray(chmap)
        self.last = torch.zeros((1, channels, 256), dtype=torch.int32,
                                device=self.device)
        self.csnroffst = torch.full((1,), 40, dtype=torch.int32,
                                    device=self.device)
        self._fn = encode_pipeline_multi(self.cfg)

    @property
    def frame_bytes(self) -> int:
        return self.cfg.frame_size * 2

    def encode(self, pcm: np.ndarray) -> bytes:
        """pcm int16 [nsamples, nch] (interleaved rows); whole frames only."""
        from ..host import pack as PK
        pcm = np.asarray(pcm)
        nfr = pcm.shape[0] // T.FRAME_SAMPLES
        out = bytearray()
        for i in range(0, nfr, self.CHUNK):
            f = min(self.CHUNK, nfr - i)
            chunk = pcm[i * 1536:(i + f) * 1536][:, self.chmap] \
                .astype(np.int16).reshape(f, 1, 1536, -1)
            (last, csnr), res = self._fn(
                torch.from_numpy(chunk).to(self.device), self.last,
                self.csnroffst)
            if rate_failures(res["ok"]):
                raise RuntimeError("rate control failed (frame too small)")
            self.last, self.csnroffst = last, csnr
            out += b"".join(PK.pack_frames_native(
                self.cfg, {k: v.cpu().numpy() for k, v in res.items()}))
        return bytes(out)
