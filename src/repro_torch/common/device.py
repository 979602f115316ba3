"""Device selection for the port's entry points."""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``None`` means ``"cuda"``.

    Raises when CUDA is asked for and absent — the port never falls back to
    the CPU on its own; callers that want the CPU (the tests) say so. On
    the card, float32 convolutions and matrix products are pinned to full
    float32 (no TF32), so the CNN keeps float32's digits.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("CUDA is not available; pass device='cpu' to "
                               "run on the CPU")
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
    return dev


def to_device(t: torch.Tensor, device) -> torch.Tensor:
    """Copy a host tensor to ``device``; to the card through pinned memory
    without blocking the host (a pageable copy would stall the host until
    the stream reaches it)."""
    device = torch.device(device)
    if device.type == "cuda" and t.device.type == "cpu":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)
