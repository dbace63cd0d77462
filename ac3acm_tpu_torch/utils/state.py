"""Checkpoint / resume of per-lane decode state.

The decoder's carried state is the OLA delay planes + downmixed flag per
lane: (delay [B, 6, 128] f32, downmixed [B] bool).  ``load_decode_state``
reads the very ``.npz`` the JAX package's ``save_decode_state`` writes
(its "delay" and "downmixed" arrays), so a stream decoded up to a chunk
boundary there resumes here.  Parser state is not part of the port.
"""
from __future__ import annotations

import numpy as np
import torch

from .device import resolve_device


def carry_from_numpy(delay, downmixed, device=None):
    """numpy (delay, downmixed) -> carry tensors on `device` (None: the
    CUDA card)."""
    device = resolve_device(device)
    return (torch.from_numpy(np.ascontiguousarray(delay, np.float32))
            .to(device),
            torch.from_numpy(np.ascontiguousarray(downmixed, bool))
            .to(device))


def carry_to_numpy(carry):
    """carry tensors -> numpy (delay f32, downmixed bool)."""
    delay, downmixed = carry
    return delay.cpu().numpy(), downmixed.cpu().numpy()


def save_decode_state(path: str, carry):
    """Write the carry in the JAX package's .npz layout."""
    delay, downmixed = carry_to_numpy(carry)
    np.savez(path, delay=delay, downmixed=downmixed)


def load_decode_state(path: str, device=None):
    """-> carry (delay, downmixed) on `device`."""
    with np.load(path, allow_pickle=False) as z:
        return carry_from_numpy(z["delay"], z["downmixed"], device)
