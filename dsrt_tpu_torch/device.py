"""The device the port's entry points put their tensors on: the card,
unless the caller asks for another (the CPU tests pass device="cpu"),
and how small host values get there."""

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


def to_device(a, device) -> torch.Tensor:
    """`a`, a host array or CPU tensor, on `device` with the same bits.
    On the card it goes through a fresh buffer of PyTorch's pinned
    caching allocator in one non-blocking copy: a copy from pageable
    memory waits for all the work queued on the stream, this one queues
    behind it, and the allocator reuses the buffer only once the copy is
    done.  Elsewhere `torch.as_tensor`."""
    device = torch.device(device)
    if device.type != "cuda":
        return torch.as_tensor(a, device=device)
    return torch.as_tensor(a).pin_memory().to(device, non_blocking=True)
