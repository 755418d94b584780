"""The one place a ``device=`` argument is turned into a ``torch.device``.

Entry points default to ``"cuda"``. A CUDA device that is not there is an
error, never a quiet fall-back to the CPU: a caller who wants the CPU says
``device="cpu"`` (the CPU tests do).
"""
from __future__ import annotations

import torch


def as_device(device: "str | torch.device" = "cuda") -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} requested but no CUDA device is available; "
            "pass device='cpu' to run the plain PyTorch versions on the host"
        )
    return dev
