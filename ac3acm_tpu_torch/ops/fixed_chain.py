"""The fixed-point decode's block chain of one stream, B1QS.

``fixed_chain(fmt, carry, blocks)`` is exactly what
models.decoder.fixed_block_pipeline(fmt) computes: the LIBA52_FIXED
(int32 Q30) a52_block math of every block in order, carry in and out.

    carry   (delay int32 [6, 128], downmixed bool [])
    blocks  freq int32 [n, 6, 256], blksw bool [n, 5], coeff float32 0/1
            [n, 5], remat bool [n, 256], bias int32 [n]
    ->      ((delay, downmixed), pcm int32 [n, nch_out, 256], LFE first)

On a CUDA tensor it launches the hand-written kernel B1QS
(csrc/imdct_exact.cu:fixed_chain_kernel), once a call: the splits, the
Q30 overlap-adds, the delay fixups and the mixes of every block in one
cluster of CTAs, a block's rows split a CTA each and walked in the first
with the carry in registers.  On a CPU tensor it runs
``fixed_chain_ref``, the plain version: models.decoder._block_step block
after block with the plain Q30 filterbank.  There is no other path.  The
JAX package runs the same chain as one XLA program (a lax.scan of
_block_step under jit, ac3acm_tpu/models/decoder.py:526), with no
pallas_call.

The kernel takes the format's mixers as affine maps (``affine_mixers``).
"""
from __future__ import annotations

import ctypes as C
from functools import lru_cache

import numpy as np
import torch

from .. import tables as T
from . import _cuda
from . import imdct_exact as IE
from .downmix import downmix, upmix

# B1QS launches since the last reset (only where the CUDA kernel is
# launched; the CPU path leaves it alone)
launches_fixed_chain = 0


class _Mix(C.Structure):
    """csrc/imdct_exact.cu:FixedMix, passed to the launch by value."""
    _fields_ = [("down", C.c_int8 * 25), ("up", C.c_int8 * 25),
                ("cbias", C.c_int32 * 5), ("nf", C.c_int32),
                ("nf_out", C.c_int32), ("lfe_out", C.c_int32),
                ("remat", C.c_int32), ("chanbias", C.c_int32)]


@lru_cache(maxsize=None)
def affine_mixers(acmod: int, output: int, slev_zero: bool):
    """(D, c, U) of one format: downmix(planes, bias) == D @ planes +
    c * bias and upmix(planes) == U @ planes, each mod 2^32, for int32
    planes [5, ...] (D, U int64 [5, 5] with entries in {-1, 0, 1}, c int64
    [5]).

    Derived by running the port's own downmix and upmix on int32 identity
    planes (bias 0) and on zero planes with bias 1, so every plane those
    mixers leave as it was, zero or copy comes out of the mixers
    themselves.  Exact for int32 only: int32 adds and subtracts wrap mod
    2^32, so they associate and commute and any order of a mixer's terms
    gives the same sum; each mixer is a sum of +-planes and the bias, so it
    IS the affine map.  Never use these for float planes, whose results
    depend on the reference's order of adds."""
    eye = torch.eye(5, dtype=torch.int32)
    zero = torch.zeros((), dtype=torch.int32)
    D = downmix(eye, acmod, output, zero, slev_zero=slev_zero)
    c = downmix(torch.zeros((5, 1), dtype=torch.int32), acmod, output,
                torch.ones((), dtype=torch.int32), slev_zero=slev_zero)[:, 0]
    U = upmix(eye, acmod, output)
    return tuple(np.asarray(m, np.int64) for m in (D, c, U))


@lru_cache(maxsize=None)
def _mix_arg(fmt) -> _Mix:
    D, c, U = affine_mixers(fmt.acmod, fmt.output, fmt.slev_zero)
    assert np.abs(D).max() <= 1 and np.abs(U).max() <= 1, (D, U)
    return _Mix((C.c_int8 * 25)(*D.ravel().tolist()),
                (C.c_int8 * 25)(*U.ravel().tolist()),
                (C.c_int32 * 5)(*c.tolist()), fmt.nfchans, fmt.nf_out,
                int(fmt.lfe_out), int(fmt.acmod == T.A52_STEREO),
                fmt.chanbias)


def _filterbank_plain(coeffs, delay, blksw, bias):
    """filterbank_fixed on the split's plain version: no kernel on any
    device."""
    return IE._filterbank(IE.split_fb_fixed_ref, IE._ola_fixed, coeffs, delay,
                          blksw, torch.as_tensor(bias)[..., None])


def fixed_chain_ref(fmt, carry, blocks):
    """Plain version of fixed_chain (any device): the eager _block_step
    loop with the plain Q30 filterbank."""
    from ..models.decoder import _block_step
    n = blocks["freq"].shape[0]
    if n == 0:
        return ((carry[0].clone(), carry[1].clone()),
                carry[0].new_zeros((0, fmt.nch_out, 256)))
    outs = []
    for i in range(n):
        carry, pcm = _block_step(fmt, carry, {k: v[i] for k, v in
                                              blocks.items()},
                                 filterbank=_filterbank_plain)
        outs.append(pcm)
    return carry, torch.stack(outs)


_BLOCK_SPEC = (("freq", torch.int32, (6, 256)), ("blksw", torch.bool, (5,)),
               ("coeff", torch.float32, (5,)),
               ("remat", torch.bool, (256,)), ("bias", torch.int32, ()))


def _check(carry, blocks):
    delay, downmixed = carry
    if delay.dtype != torch.int32 or downmixed.dtype != torch.bool:
        raise TypeError(f"carry is ({delay.dtype}, {downmixed.dtype}), "
                        f"expected (torch.int32, torch.bool)")
    if delay.shape != (6, 128) or downmixed.shape != ():
        raise ValueError(f"carry has shapes ({tuple(delay.shape)}, "
                         f"{tuple(downmixed.shape)}), expected ((6, 128), ())")
    missing = {k for k, _, _ in _BLOCK_SPEC} - set(blocks)
    if missing:
        raise ValueError(f"blocks lack {sorted(missing)}")
    if blocks["freq"].dim() == 0:
        raise ValueError("blocks['freq'] must be [n, 6, 256]")
    n = blocks["freq"].shape[0]
    tensors = {"delay": delay, "downmixed": downmixed}
    for key, dtype, shape in _BLOCK_SPEC:
        t = blocks[key]
        if t.dtype != dtype:
            raise TypeError(f"blocks[{key!r}] is {t.dtype}, expected {dtype}")
        if tuple(t.shape) != (n,) + shape:
            raise ValueError(f"blocks[{key!r}] has shape {tuple(t.shape)}, "
                             f"expected {(n,) + shape}")
        tensors[key] = t
    dev = delay.device
    for key, t in tensors.items():
        if t.device != dev:
            raise ValueError(f"{key} is on {t.device}, the carry on {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{key} must be contiguous")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"fixed_chain runs on cuda or cpu, not {dev}")
    for key in ("freq", "delay"):
        if tensors[key].data_ptr() % 16:
            raise ValueError(f"{key} must be 16-byte aligned")
    return n


def _lib():
    """csrc/imdct_exact.cu's library (ops.imdct_exact binds every entry),
    its FixedMix checked against _Mix."""
    lib = _cuda.load("imdct_exact", IE._bind)
    if lib.fixed_chain_mix_size() != C.sizeof(_Mix):
        raise RuntimeError(f"FixedMix is {lib.fixed_chain_mix_size()} bytes "
                           f"in the kernel but {C.sizeof(_Mix)} in _Mix")
    return lib


def fixed_chain(fmt, carry, blocks):
    """The fixed block chain of one stream (see the module docstring):
    every tensor contiguous and on one device, freq and the delay 16-byte
    aligned; a CUDA carry launches B1QS once, a CPU one runs
    fixed_chain_ref.  The kernel writes fresh output tensors; the inputs
    are left as they were."""
    global launches_fixed_chain
    n = _check(carry, blocks)
    delay, downmixed = carry
    dev = delay.device
    if dev.type == "cpu":
        return fixed_chain_ref(fmt, carry, blocks)
    pcm = torch.empty((n, fmt.nch_out, 256), dtype=torch.int32, device=dev)
    delay_out = torch.empty((6, 128), dtype=torch.int32, device=dev)
    dmx_out = torch.empty((), dtype=torch.bool, device=dev)
    tw = IE._tw_on(dev, "fixed")
    lib = _lib()
    mix = _mix_arg(fmt)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.fixed_chain_launch(
            blocks["freq"].data_ptr(), blocks["blksw"].data_ptr(),
            blocks["coeff"].data_ptr(), blocks["remat"].data_ptr(),
            blocks["bias"].data_ptr(), delay.data_ptr(),
            downmixed.data_ptr(), tw["packed"].data_ptr(),
            tw["order32"].data_ptr(), tw["window"].data_ptr(),
            pcm.data_ptr(), delay_out.data_ptr(), dmx_out.data_ptr(), n,
            C.byref(mix), stream)
    if rc != 0:
        raise RuntimeError("fixed_chain (B1QS) kernel launch failed: "
                           + lib.imdct_exact_error_string(rc).decode())
    launches_fixed_chain += 1
    return (delay_out, dmx_out), pcm
