"""Fused order-exact steady tail: IMDCT, OLA chain and int16 in one kernel.

The reference-mode counterpart of ops.fused_steady.  The scan-free steady
pipeline with premixed planes reduces each (lane b, output plane p) chain
of n blocks to

    (z_i, d_i) = split_fb_exact(freq[b, i, p], blksw[b, i, p])
    dprev_i    = d0[b, p] if i == 0 else d_{i-1}
    out_i      = ((z_i * win) + (fold(dprev_i) * win_r)) + bias[b, i]
    pcm        = convert_to_int16(out) (or out as float32)
    dlast      = d_{n-1}                      fold(d) = d ++ d.flip(-1)

every operation rounded on its own, which is bit for bit what
models.decoder._pipeline_steady(exact=True) followed by convert_to_int16
computes, and so the reference float decoder's output.

``fused_steady_exact`` launches the hand-written CUDA kernel B1F
(csrc/imdct_exact.cu:fused_steady_exact_kernel, which shares B1's
transform code) on CUDA tensors: z, d and the OLA stay on chip, and only
the PCM and the carry-out are written.  For tensors on the CPU it runs
``fused_steady_exact_ref``, the plain PyTorch version.  There is no other
path: a CUDA tensor launches the kernel or raises.  The JAX package
computes the same function as XLA (ac3acm_tpu/ops/imdct_exact.py:437,466
and the steady body's OLA), with no pallas_call.
"""
from __future__ import annotations

import torch

from . import _cuda
from .filterbank import mats_on
from .fused_steady import _check, steady_epilogue
from .imdct_exact import _bind, _tw_on, split_fb_exact_ref

# kernel launches since the last reset (incremented only where the CUDA
# kernel is launched; the CPU path leaves it alone)
launches = 0

_OUT_DTYPES = (torch.int16, torch.float32)


def fused_steady_exact_ref(freq, blksw, d0, bias, out_dtype=torch.int16):
    """Plain PyTorch version of fused_steady_exact (any device): the exact
    split, then the delay chain, the eager OLA and convert_to_int16 of
    ops.fused_steady.steady_epilogue."""
    zd = torch.cat(split_fb_exact_ref(freq, blksw), dim=-1)
    return steady_epilogue(zd, d0, bias, out_dtype)


def fused_steady_exact(freq, blksw, d0, bias, out_dtype=torch.int16):
    """freq [B, n, P, 256] f32 premixed planes (block-major, the
    pipeline's layout), 16-byte aligned; blksw [B, n, P] bool (True = short
    block; a plane's flag may differ from its neighbour's) or None (every
    row long); d0 [B, P, 128] f32 carry; bias [B, n] f32.

    -> (pcm [B, n, P, 256] of out_dtype (torch.int16 or torch.float32),
        dlast [B, P, 128] f32)

    Every input must be contiguous and on one device; n >= 1."""
    global launches
    if freq.dim() != 4 or freq.shape[-1] != 256:
        raise ValueError(f"freq must be [B, n, P, 256], got "
                         f"{tuple(freq.shape)}")
    if out_dtype not in _OUT_DTYPES:
        raise TypeError(f"out_dtype is {out_dtype}, expected torch.int16 "
                        f"or torch.float32")
    B, n, P, _ = freq.shape
    dev = freq.device
    _check("freq", freq, torch.float32, (B, n, P, 256), dev)
    if blksw is not None:
        _check("blksw", blksw, torch.bool, (B, n, P), dev)
    _check("d0", d0, torch.float32, (B, P, 128), dev)
    _check("bias", bias, torch.float32, (B, n), dev)
    if n < 1:
        raise ValueError("fused_steady_exact needs at least one block")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"fused_steady_exact runs on cuda or cpu, not {dev}")
    if freq.data_ptr() % 16:
        raise ValueError("freq must be 16-byte aligned")
    if dev.type == "cpu":
        return fused_steady_exact_ref(freq, blksw, d0, bias, out_dtype)
    pcm = torch.empty((B, n, P, 256), dtype=out_dtype, device=dev)
    dlast = torch.empty((B, P, 128), dtype=torch.float32, device=dev)
    if B * P == 0:
        return pcm, dlast
    tw = _tw_on(dev)
    win = mats_on(dev)[2]
    lib = _cuda.load("imdct_exact", _bind)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.fused_steady_exact_launch(
            freq.data_ptr(), None if blksw is None else blksw.data_ptr(),
            d0.data_ptr(), bias.data_ptr(), tw["packed"].data_ptr(),
            tw["order32"].data_ptr(), win.data_ptr(), pcm.data_ptr(),
            dlast.data_ptr(), B, n, P, int(out_dtype == torch.int16), stream)
    if rc != 0:
        raise RuntimeError("fused_steady_exact kernel launch failed: "
                           + lib.imdct_exact_error_string(rc).decode())
    launches += 1
    return pcm, dlast
