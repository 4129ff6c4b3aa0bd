"""The device an entry point of the port runs on."""
from __future__ import annotations

import torch


def resolve_device(device) -> torch.device:
    """The device a torch entry point runs on: CUDA unless the caller asks
    for the CPU.  Asking for CUDA where there is none raises."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device='cuda' was requested but torch.cuda.is_available() is "
            "False; pass device='cpu' (--device cpu) to run on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unknown device {device!r}; use 'cuda' or 'cpu'")
    return dev
