"""The one place a ``device=`` argument is turned into a ``torch.device``.

Entry points default to ``"cuda"``. A CUDA device that is not there is an
error, never a quiet fall-back to the CPU: a caller who wants the CPU says
``device="cpu"`` (the CPU tests do).

:func:`ieee_f32` pins float32 products to full precision inside the exact
entry points, whatever TF32 setting the caller chose.
"""
from __future__ import annotations

import contextlib

import torch


def as_device(device: "str | torch.device" = "cuda") -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} requested but no CUDA device is available; "
            "pass device='cpu' to run the plain PyTorch versions on the host"
        )
    return dev


def _precision_switches() -> list:
    """The objects whose ``fp32_precision`` sets what a float32 product may
    round to (cuBLAS matmuls, cuDNN convolutions and RNNs), where this
    PyTorch has that API; else an empty list."""
    b = torch.backends
    if not hasattr(b.cuda.matmul, "fp32_precision"):
        return []
    return [b.cuda.matmul, b.cudnn.conv, b.cudnn.rnn]


@contextlib.contextmanager
def ieee_f32():
    """Run the body with TF32 off for float32 matrix products and cuDNN, and
    give the caller's settings back afterwards (also after an exception).

    The exact entry points hold their f32 results within ~1e-5 of the
    reference, which a TF32 product (about three decimal digits) does not
    keep; a caller's ``torch.set_float32_matmul_precision("high")`` or
    ``"medium"`` must not reach them. Where PyTorch has the per-backend
    ``fp32_precision`` switches they are saved, set to ``"ieee"`` and put
    back as they were (the legacy ``allow_tf32`` flags would turn a caller's
    ``"medium"`` into ``"high"``); else the legacy matmul precision and
    ``cudnn.allow_tf32`` are. Usable as a decorator too."""
    switches = _precision_switches()
    if switches:
        saved = [s.fp32_precision for s in switches]
        for s in switches:
            s.fp32_precision = "ieee"
        try:
            yield
        finally:
            for s, value in zip(switches, saved):
                s.fp32_precision = value
        return
    cudnn = torch.backends.cudnn
    saved = torch.get_float32_matmul_precision(), cudnn.allow_tf32
    torch.set_float32_matmul_precision("highest")
    cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.set_float32_matmul_precision(saved[0])
        cudnn.allow_tf32 = saved[1]
