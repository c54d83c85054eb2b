"""Device resolution for the port's entry points."""
from __future__ import annotations

import torch


def resolve(device) -> torch.device:
    """The torch device an entry point runs on. A CUDA device that is not
    present is an error, never a silent move to the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the plain "
            "PyTorch versions of the kernels"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev
