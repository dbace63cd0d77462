"""Device resolution for the port's entry points."""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """None -> the CUDA card.  Raises when no card is present: an entry
    point never carries on quietly on the CPU; pass device="cpu" to ask
    for it."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' "
                           "to run the plain PyTorch path on the CPU")
    return device
