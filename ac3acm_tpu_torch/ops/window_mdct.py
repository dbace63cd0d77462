"""The encoder's window, block-float normalize and MDCT, M1.

``window_mdct(prev, cur)`` is what the encoder's frame core computes before
the exponent stage (ac3enc.cpp:441-603, the framing before it):

    prev, cur    int32 [N, 6, ch, 256]  int16-valued: a frame's blocks and
                                        the overlapped blocks before them
                                        (contiguous, 16-byte aligned; ch
                                        1..6)
    ->           (coef int32 [N, 6, ch, 256]: mdct512 of the windowed,
                  normalized block; exp_samples int32 [N, 6, ch]: the
                  normalize's left shift minus 9, in [-9, 5])

which is ``ops.mdct.window_norm_block(prev, cur)`` and then ``mdct512`` of
its first output, bit for bit.  On CUDA tensors it launches the
hand-written kernel M1 (csrc/window_mdct.cu) once a call.  On CPU tensors
it runs ``window_mdct_ref``, the plain version: those two functions as
they are, eager whole-tensor passes.  There is no other path.  The JAX
package computes the same function as XLA (ac3acm_tpu/ops/mdct.py:162
window_norm_block, :129 mdct512, :64 _fft128), with no pallas_call.

The kernel reads the window and the twiddles from the wrapper (``tables``:
``tables.enc_window_int16()`` and ``mdct._twiddles()``, the plain version's
own numpy values, in the order of LAYOUT), so no float arithmetic is done
on the card.

Bound on the card: bytes (the two blocks in as int16, a coefficient out as
int32, the shift a byte) and integer issue of one order; the kernel's
header says what its design does.
"""
from __future__ import annotations

import ctypes as C
from functools import lru_cache

import numpy as np
import torch

from .. import tables as T
from . import _cuda
from .mdct import _twiddles, mdct512, window_norm_block

# the kernel's table: (name, first int32, length), in order (the TAB_*
# constants of csrc/window_mdct.cu)
LAYOUT = (("window", 0, 256), ("xcos1", 256, 128), ("xsin1", 384, 128),
          ("costab", 512, 64), ("sintab", 576, 64))
TABLE_INTS = 640

# M1 launches since the last reset (only where the CUDA kernel is
# launched; the CPU path leaves it alone)
launches_window_mdct = 0


def window_mdct_ref(prev, cur):
    """Plain version of window_mdct (any device): window_norm_block, then
    mdct512, unchanged."""
    windowed, _, exp_samples = window_norm_block(prev, cur)
    return mdct512(windowed), exp_samples


def table_numpy() -> np.ndarray:
    """The kernel's int32 table, laid out as LAYOUT says."""
    costab, sintab, xcos1, xsin1, _ = _twiddles()
    parts = dict(window=T.enc_window_int16(), xcos1=xcos1, xsin1=xsin1,
                 costab=costab, sintab=sintab)
    out = np.zeros(TABLE_INTS, np.int32)
    for name, at, n in LAYOUT:
        out[at:at + n] = parts[name]
    return out


@lru_cache(maxsize=8)
def _table_on(device: torch.device):
    return torch.from_numpy(table_numpy()).to(device)


def _bind(lib):
    p, i = C.c_void_p, C.c_int
    lib.window_mdct_launch.restype = i
    lib.window_mdct_launch.argtypes = [p, p, p, p, p, C.c_longlong, p]
    lib.window_mdct_error_string.restype = C.c_char_p
    lib.window_mdct_error_string.argtypes = [i]
    lib.window_mdct_layout.restype = i
    lib.window_mdct_layout.argtypes = [i]
    got = [lib.window_mdct_layout(k) for k in range(len(LAYOUT) + 1)]
    want = [at for _, at, _ in LAYOUT] + [TABLE_INTS]
    if got != want:
        raise RuntimeError(f"csrc/window_mdct.cu's table layout {got} is not "
                           f"ops/window_mdct.py's {want}")


def _check(prev, cur):
    """The kernel's contract, on both devices: -> the transforms."""
    dev = cur.device
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"window_mdct runs on cuda or cpu, not {dev}")
    for name, t in (("prev", prev), ("cur", cur)):
        if t.dtype != torch.int32:
            raise TypeError(f"{name} is {t.dtype}, expected torch.int32")
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, cur on {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")
    if cur.dim() != 4 or cur.shape[1] != 6 or cur.shape[3] != 256:
        raise ValueError(f"cur has shape {tuple(cur.shape)}, expected "
                         f"[N, 6, ch, 256]")
    if prev.shape != cur.shape:
        raise ValueError(f"prev has shape {tuple(prev.shape)}, cur "
                         f"{tuple(cur.shape)}")
    if not 1 <= cur.shape[2] <= 6:
        raise ValueError(f"cur has {cur.shape[2]} channels, expected 1..6")
    return cur.shape[0] * 6 * cur.shape[2]


def window_mdct(prev, cur):
    """Window, normalize and MDCT (see the module docstring): prev and cur
    int32 [N, 6, ch, 256], contiguous, 16-byte aligned, on one device; CUDA
    tensors launch M1 once, CPU ones run window_mdct_ref."""
    global launches_window_mdct
    count = _check(prev, cur)
    dev = cur.device
    if dev.type == "cpu":
        return window_mdct_ref(prev, cur)
    coef = torch.empty(cur.shape, dtype=torch.int32, device=dev)
    exp_samples = torch.empty(cur.shape[:3], dtype=torch.int32, device=dev)
    if count == 0:
        return coef, exp_samples
    lib = _cuda.load("window_mdct", _bind)
    table = _table_on(dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.window_mdct_launch(prev.data_ptr(), cur.data_ptr(),
                                    table.data_ptr(), coef.data_ptr(),
                                    exp_samples.data_ptr(), count, stream)
    if rc != 0:
        raise RuntimeError("window_mdct (M1) kernel launch failed: "
                           + lib.window_mdct_error_string(rc).decode())
    launches_window_mdct += 1
    return coef, exp_samples
