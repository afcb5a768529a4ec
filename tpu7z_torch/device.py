"""Where the port runs: the card, unless the caller asks for the CPU."""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """`None` means the CUDA card, and raises if there is none; the CPU is
    used only when the caller names it."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "tpu7z_torch runs on a CUDA device and none is available; "
            "pass device='cpu' to run the plain PyTorch path")
    return dev
