"""Fused steady decode: matmul + OLA chain + int16 in one kernel.

The scan-free steady pipeline with host premix reduces each
(lane, output plane) to

    zd   = freq[n, 256] @ w_long[256, 384]      (long-only chunks)
    out  = zd[:, :256] * win + fold(shift(zd[:, 256:], d0)) * win_r + bias
    i16  = convert_to_int16(out)

``fused_steady`` launches the hand-written CUDA kernel
(csrc/fused_steady.cu, the Hopper counterpart of the TPU kernel
ac3acm_tpu/ops/pallas_steady.py:_kernel) on CUDA tensors; it keeps zd
on chip and writes only the int16 PCM and the 128-float carry-out.  For
tensors on the CPU it runs ``fused_steady_ref``, the plain PyTorch
version of the same function.  There is no other path: a CUDA tensor
launches the kernel or raises.

The source note in csrc/fused_steady.cu states the kernel's bound on the
card (FP32 operations, not bytes) and what the design does about it.
"""
from __future__ import annotations

import ctypes as C

import torch

from . import _cuda
from .filterbank import convert_to_int16, mats_on

# THE fused-path accuracy contract, the same two bounds as the JAX
# package's (ops/pallas_steady.py): against the plain steady pipeline,
#
#   * PCM:   max |fused - plain| <= PCM_LSB_TOL int16 LSB
#   * carry: max |fused - plain| <= CARRY_ATOL in float units
#
# The kernel computes in full FP32 like the plain version
# (torch.backends.cuda.matmul.allow_tf32 = False, ops.filterbank); the
# two differ only in the GEMM's summation order, a few FP32 ulps of the
# partial sums, so an output may round to the neighbouring int16 at a
# half-LSB boundary and the carry drifts far below one float LSB.
PCM_LSB_TOL = 1
CARRY_ATOL = 1.0 / 32768

# kernel launches since the last reset (incremented only where the CUDA
# kernel is launched; the CPU path leaves it alone)
launches = 0


def fused_steady_ref(freq, d0, bias):
    """Plain PyTorch version: freq [B, n, P, 256], d0 [B, P, 128],
    bias [B, n] -> (pcm int16 [B, n, P, 256], dlast [B, P, 128])."""
    w_long, _, win, win_r = mats_on(freq.device)
    zd = torch.matmul(freq, w_long)                       # [B, n, P, 384]
    z, d = zd[..., :256], zd[..., 256:]
    dchain = torch.cat([d0[:, None], d[:, :-1]], dim=1)
    dfold = torch.cat([dchain, dchain.flip(-1)], dim=-1)
    out = z * win + dfold * win_r + bias[:, :, None, None]
    return convert_to_int16(out), d[:, -1]


def _bind(lib):
    p = C.c_void_p
    lib.fused_steady_launch.restype = C.c_int
    lib.fused_steady_launch.argtypes = [p, p, p, p, p, p, p,
                                        C.c_int, C.c_int, C.c_int, p]
    lib.fused_steady_error_string.restype = C.c_char_p
    lib.fused_steady_error_string.argtypes = [C.c_int]


def _check(name, t, dtype, shape, device):
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} is {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, "
                         f"expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def fused_steady(freq, d0, bias):
    """freq [B, n, P, 256] f32 premixed long-only planes (block-major, the
    pipeline's layout); d0 [B, P, 128] f32 carry; bias [B, n] f32 (the
    per-block state bias, 384.0 normally).

    -> (pcm int16 [B, n, P, 256], d_last [B, P, 128])

    P = output planes in the caller's order (LFE last when present; every
    plane has the same long-block chain)."""
    global launches
    if freq.device.type == "cpu":
        return fused_steady_ref(freq, d0, bias)
    if freq.device.type != "cuda":
        raise ValueError(f"fused_steady runs on cuda or cpu, not {freq.device}")
    if freq.dim() != 4 or freq.shape[-1] != 256:
        raise ValueError(f"freq must be [B, n, P, 256], got {tuple(freq.shape)}")
    B, n, P, _ = freq.shape
    dev = freq.device
    _check("freq", freq, torch.float32, (B, n, P, 256), dev)
    _check("d0", d0, torch.float32, (B, P, 128), dev)
    _check("bias", bias, torch.float32, (B, n), dev)
    if n < 1:
        raise ValueError("fused_steady needs at least one block")
    w_long, _, win, _ = mats_on(dev)
    pcm = torch.empty((B, n, P, 256), dtype=torch.int16, device=dev)
    dlast = torch.empty((B, P, 128), dtype=torch.float32, device=dev)
    lib = _cuda.load("fused_steady", _bind)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.fused_steady_launch(
            freq.data_ptr(), d0.data_ptr(), bias.data_ptr(),
            w_long.data_ptr(), win.data_ptr(), pcm.data_ptr(),
            dlast.data_ptr(), B, n, P, stream)
    if rc != 0:
        raise RuntimeError("fused_steady kernel launch failed: "
                           + lib.fused_steady_error_string(rc).decode())
    launches += 1
    return pcm, dlast
