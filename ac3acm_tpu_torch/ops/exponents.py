"""The encoder's exponent stage, X1: raw exponents, strategy, coding.

``exponents(coef, exp_samples, nb, lfe)`` is what the encoder's frame core
computes between the MDCT and the masking curve (ac3enc.cpp:617-747,
1730-1749):

    coef        int32 [N, 6, ch, 256]  the MDCT's coefficients; overrange
                                       ones (raw exponent >= 24 with c != 0)
                                       are zeroed IN PLACE
    exp_samples int32 [N, 6, ch]       the block-float shifts minus 9, as
                                       mdct.window_norm_block gives them
                                       (in [-9, 5])
    nb          int                    live bins of a full-band channel:
                                       NB (223, every config's); the LFE
                                       has 7
    lfe         bool                   the last channel is the LFE
    ->          (enc_exp int8 [N, 6, ch, 256]: the coded exponents, every
                 one of the 256 bytes; strat int32 [N, 6, ch]: 0 reuse,
                 1 D15 (the LFE's EXP_NEW), 2 D25, 3 D45; exp_bits int32
                 [N]: the exponent bits of the frame)

The stage, per lane-frame row: a bin's raw exponent is 24 where c = 0 and
else min(23 - av_log2(|c|) + exp_samples, 24); a block starts a new
exponent run when the sum over all 256 bins of |raw - raw of the block
before| is above 1000 (block 0 always); a run of 1 block codes D45, of 2
or 3 D25, longer D15, and the LFE codes EXP_NEW (D15 on its 7 bins).  On
the live bins every block of a run takes the run's minimum (dead bins keep
their block's own raw exponent); a coded block takes, per group of 1, 2
or 4 bins, the group's minimum (bin 0 clamped at 15), relaxed to the
largest 2-Lipschitz sequence below them (a min-plus scan each way), fanned
back out to the group's bins, 0 past the last group; reused blocks copy
the block before's 256 coded bytes.

Why int8 holds enc_exp.  A raw exponent lies in [23 - 30 - 9, 24] =
[-16, 24] for |c| < 2^31 and exp_samples >= -9; the run minimum, the group
minimum and the 2-Lipschitz relaxation never go below the least raw value
of the (block, channel), and the copies copy.  So every coded exponent is
in [-16, 24]: one byte holds it, its ``.view(torch.uint8)`` is the
``& 0xFF`` form that E1 and P1 read, and the quantizer reads the same
bytes as signed.

On CUDA tensors it launches the hand-written kernel X1
(csrc/exponents.cu), once a call: persistent CTAs walk the rows, the next
row's coefficients on their way while a row is coded.  On CPU tensors it runs
``exponents_ref``, the plain version: ops.mdct.extract_exponents, then
``strategy``, ``encode_exponents`` (the run fold, three
``encode_exp_static`` calls and the LFE's, the reuse copy), as eager
whole-tensor passes.  There is no other path.  The JAX package computes the
same function as XLA (ac3acm_tpu/ops/mdct.py:181 extract_exponents and
ac3acm_tpu/models/encoder.py:316-384, with :116 _encode_exp_static), with
no pallas_call.

Bound on the card: bytes (a coefficient read as int32 and a coded exponent
written a byte a bin); the kernel's header says what its design does.
"""
from __future__ import annotations

import ctypes as C

import numpy as np
import torch

from .. import tables as T
from . import _cuda
from .mdct import extract_exponents

EXP_NEW = 1
LFE_BINS = 7         # the LFE's live bins (its nb_coefs)
NB = 223             # a full-band channel's live bins (EncoderConfig's)

# X1 launches since the last reset (only where the CUDA kernel is
# launched; the CPU path leaves it alone)
launches_exponents = 0


def encode_exp_static(exp, nb_coefs: int, gsize: int):
    """encode_exp for one static (nb_coefs, group size).

    exp [..., 256] int32 -> (encoded [..., 256], nbits int).

    The reference's iterative +-2 delta relaxation (ac3enc.cpp:730-747)
    converges to the largest 2-Lipschitz array below the group minima:
    c_i = min(v_i, c_{i-1} + 2), whose closed form
    f_i = 2i + cummin_{j<=i}(v_j - 2j), and the same backward."""
    dev = exp.device
    ngroups = ((nb_coefs + gsize * 3 - 4) // (3 * gsize)) * 3
    k = torch.as_tensor(1 + np.arange(ngroups)[:, None] * gsize
                        + np.arange(gsize)[None, :], device=dev)
    gmin = exp[..., k].amin(dim=-1)                       # [..., ngroups]
    dc = torch.clamp(exp[..., 0:1], max=15)
    v = torch.cat([dc, gmin], dim=-1)                     # [..., ngroups+1]
    j2 = torch.arange(0, 2 * (ngroups + 1), 2, dtype=exp.dtype, device=dev)
    f = torch.cummin(v - j2, dim=-1).values + j2
    g = torch.cummin((f + j2).flip(-1), dim=-1).values.flip(-1) - j2
    out = torch.zeros_like(exp)
    out[..., 0] = g[..., 0]
    out[..., 1:1 + ngroups * gsize] = torch.repeat_interleave(
        g[..., 1:], gsize, dim=-1)
    return out, 4 + (ngroups // 3) * 7


def strategy(exp, lfe: bool):
    """exp [N, 6, ch, 256] -> (new [N, 6, ch] bool: the block starts a
    run, strat [N, 6, ch] int32), ac3enc.cpp:617-668; the last channel is
    the LFE if lfe."""
    N, nch = exp.shape[0], exp.shape[2]
    nf = nch - int(lfe)
    dev = exp.device
    diff = (exp[:, 1:] - exp[:, :-1]).abs().sum(dim=-1)      # [N, 5, ch]
    new = torch.cat([torch.ones((N, 1, nch), dtype=torch.bool, device=dev),
                     diff > 1000], dim=1)                     # [N, 6, ch]
    # next_new[i] = min{j > i : new[j]} (6 if none)
    running = torch.full((N, nch), 6, dtype=torch.int32, device=dev)
    nxt = [None] * 6
    for i in range(5, -1, -1):
        nxt[i] = running
        running = torch.where(new[:, i], i, running)
    strat = []
    for i in range(6):
        runlen = nxt[i] - i
        code = torch.where(runlen == 1, T.EXP_D45,
                           torch.where(runlen <= 3, T.EXP_D25, T.EXP_D15))
        s_i = torch.where(new[:, i], code, T.EXP_REUSE)
        if lfe:
            s_i[:, nf] = torch.where(new[:, i, nf], EXP_NEW, T.EXP_REUSE)
        strat.append(s_i)
    return new, torch.stack(strat, dim=1).to(torch.int32)


def encode_exponents(exp, new, strat, nb: int, lfe: bool):
    """Reuse folding + exponent coding: -> (enc_exp [N, 6, ch, 256] int32,
    exponent bits [N]); full-band channels have nb live bins, the LFE (the
    last channel if lfe) LFE_BINS."""
    N, nch = exp.shape[0], exp.shape[2]
    nf = nch - int(lfe)
    nbs = (nb,) * nf + (LFE_BINS,) * int(lfe)
    dev = exp.device
    # run id + exponent_min fold over each run (ac3enc.cpp:1730-1749)
    rid = torch.zeros((N, nch), dtype=torch.int32, device=dev)
    run_id = []
    for i in range(6):
        rid = torch.where(new[:, i], i, rid)
        run_id.append(rid)
    run_id = torch.stack(run_id, dim=1)                       # [N, 6, ch]
    live = (torch.arange(256, device=dev)[None, :]
            < torch.as_tensor(nbs, device=dev)[:, None])      # [ch, 256]
    folded = exp.clone()
    for i in range(6):
        same = run_id == run_id[:, i:i + 1]
        fmin = torch.where(same[..., None], exp, 25).amin(dim=1)
        folded[:, i] = torch.where(live, fmin, exp[:, i])

    enc_exp = torch.zeros_like(exp)
    exp_bits = torch.zeros((N,), dtype=torch.int32, device=dev)
    fbw = folded[:, :, :nf]
    for g, scode in ((1, T.EXP_D15), (2, T.EXP_D25), (4, T.EXP_D45)):
        e_s, bits_s = encode_exp_static(fbw, nb, g)
        sel = strat[:, :, :nf] == scode                       # [N, 6, nf]
        enc_exp[:, :, :nf] = torch.where(sel[..., None], e_s,
                                         enc_exp[:, :, :nf])
        exp_bits += sel.sum(dim=(1, 2), dtype=torch.int32) * bits_s
    if lfe:                                           # D15 only, 7 bins
        e_s, bits_s = encode_exp_static(folded[:, :, nf], LFE_BINS, 1)
        sel = strat[:, :, nf] == EXP_NEW
        enc_exp[:, :, nf] = torch.where(sel[..., None], e_s,
                                        enc_exp[:, :, nf])
        exp_bits += sel.sum(dim=1, dtype=torch.int32) * bits_s
    # reuse blocks take the block before's encoded exponents
    for i in range(1, 6):
        reuse = strat[:, i] == T.EXP_REUSE
        enc_exp[:, i] = torch.where(reuse[..., None], enc_exp[:, i - 1],
                                    enc_exp[:, i])
    return enc_exp, exp_bits


def exponents_ref(coef, exp_samples, nb, lfe):
    """Plain version of exponents (any device): the eager chain, coef
    zeroed in place where it overranges."""
    exp, zeroed = extract_exponents(coef, exp_samples)
    coef.copy_(zeroed)
    new, strat = strategy(exp, lfe)
    enc_exp, exp_bits = encode_exponents(exp, new, strat, nb, lfe)
    return enc_exp.to(torch.int8), strat, exp_bits


def _bind(lib):
    p, i = C.c_void_p, C.c_int
    lib.exponents_launch.restype = i
    lib.exponents_launch.argtypes = [p, p, i, p, p, p, C.c_longlong, i, p]
    lib.exponents_resident.restype = i
    lib.exponents_resident.argtypes = [i]
    lib.exponents_error_string.restype = C.c_char_p
    lib.exponents_error_string.argtypes = [i]


def resident_ctas(nch: int) -> int:
    """The CTAs X1 keeps on one SM of the current card for nch channels
    (a launch takes that many an SM, or one a row for fewer rows; each
    walks its rows)."""
    lib = _cuda.load("exponents", _bind)
    n = lib.exponents_resident(nch)
    if n <= 0:
        raise RuntimeError("exponents_resident failed: "
                           + lib.exponents_error_string(-n).decode())
    return n


def _check(coef, exp_samples, nb, lfe):
    """The kernel's contract, on both devices: -> (N, ch)."""
    dev = coef.device
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"exponents runs on cuda or cpu, not {dev}")
    for name, t in (("coef", coef), ("exp_samples", exp_samples)):
        if t.dtype != torch.int32:
            raise TypeError(f"{name} is {t.dtype}, expected torch.int32")
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, coef on {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if coef.dim() != 4 or coef.shape[1] != 6 or coef.shape[3] != 256:
        raise ValueError(f"coef has shape {tuple(coef.shape)}, expected "
                         f"[N, 6, ch, 256]")
    N, ch = coef.shape[0], coef.shape[2]
    if not 1 <= ch <= 6:
        raise ValueError(f"coef has {ch} channels, expected 1..6")
    if tuple(exp_samples.shape) != (N, 6, ch):
        raise ValueError(f"exp_samples has shape {tuple(exp_samples.shape)}"
                         f", expected {(N, 6, ch)}")
    if coef.data_ptr() % 16:
        raise ValueError("coef must be 16-byte aligned")
    if isinstance(nb, bool) or not isinstance(nb, (int, np.integer)) \
            or nb != NB:
        raise ValueError(f"nb is {nb!r}, expected the int {NB} (the "
                         f"kernel's live bins)")
    if not isinstance(lfe, (bool, np.bool_)):
        raise TypeError(f"lfe is {lfe!r}, expected a bool")
    return N, ch


def exponents(coef, exp_samples, nb, lfe):
    """The exponent stage (see the module docstring): coef and exp_samples
    int32, contiguous, on one device, coef 16-byte aligned; CUDA tensors
    launch X1 once, CPU ones run exponents_ref.  coef's overrange values
    are zeroed in place."""
    global launches_exponents
    N, ch = _check(coef, exp_samples, nb, lfe)
    dev = coef.device
    if dev.type == "cpu":
        return exponents_ref(coef, exp_samples, int(nb), bool(lfe))
    enc_exp = torch.empty((N, 6, ch, 256), dtype=torch.int8, device=dev)
    strat = torch.empty((N, 6, ch), dtype=torch.int32, device=dev)
    exp_bits = torch.empty((N,), dtype=torch.int32, device=dev)
    if N == 0:
        return enc_exp, strat, exp_bits
    lib = _cuda.load("exponents", _bind)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.exponents_launch(
            coef.data_ptr(), exp_samples.data_ptr(), int(lfe),
            enc_exp.data_ptr(), strat.data_ptr(), exp_bits.data_ptr(), N, ch,
            stream)
    if rc != 0:
        raise RuntimeError("exponents (X1) kernel launch failed: "
                           + lib.exponents_error_string(rc).decode())
    launches_exponents += 1
    return enc_exp, strat, exp_bits
