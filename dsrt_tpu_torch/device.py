"""The device the port's entry points put their tensors on: the card,
unless the caller asks for another (the CPU tests pass device="cpu")."""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """`device` as a torch.device, CUDA when it is None; raise when CUDA
    is asked for and no CUDA device is available."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {dev}: no CUDA device is available "
                           "(pass device='cpu' for the plain versions)")
    return dev
