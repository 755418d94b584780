"""Kernel lowering selection for the port.

Every kernel op picks between lowerings of the same function:

* ``"cuda"``  — the hand-written Hopper kernel (``kernels/csrc``). Needs
  tensors on a CUDA device; anything else raises.
* ``"torch"`` — the kernel's plain PyTorch version (same arithmetic, runs on
  any device; what the CPU tests compare with the reference package).
* ``"ref"``   — the flat oracle from ``kernels.ref``.

``"auto"`` follows **the device of the tensors it is handed**: a CUDA tensor
resolves to ``"cuda"``, a CPU tensor to ``"torch"``. It never probes
``torch.cuda.is_available()`` to pick the CPU quietly — a caller on the CPU
got there by creating CPU tensors. ``REPRO_TORCH_KERNEL_LOWERING`` overrides
what ``"auto"`` resolves to (e.g. ``=torch`` to run the plain versions on
the card). An unknown string raises with the valid set.
"""
from __future__ import annotations

import functools
import os

import torch

KERNEL_LOWERINGS = ("auto", "cuda", "torch", "ref")
#: the resolved (executable) subset — what a resolver may return
RESOLVED_LOWERINGS = ("cuda", "torch", "ref")

ENV_VAR = "REPRO_TORCH_KERNEL_LOWERING"


@functools.lru_cache(maxsize=None)
def _env_override() -> str | None:
    """The one-time env probe: ``REPRO_TORCH_KERNEL_LOWERING`` names a
    resolved lowering that ``"auto"`` maps to."""
    env = os.environ.get(ENV_VAR, "").strip().lower()
    if not env:
        return None
    if env not in RESOLVED_LOWERINGS:
        raise ValueError(
            f"{ENV_VAR}={env!r} is not a resolved lowering; "
            f"valid: {', '.join(RESOLVED_LOWERINGS)}"
        )
    return env


def validate_lowering(lowering: str) -> str:
    if lowering not in KERNEL_LOWERINGS:
        raise ValueError(
            f"unknown kernel lowering {lowering!r}; valid: "
            f"{', '.join(KERNEL_LOWERINGS)}"
        )
    return lowering


def resolve_lowering(lowering: str, *tensors: torch.Tensor) -> str:
    """Resolve ``lowering`` for an op about to run on ``tensors``.

    Already-resolved strings pass through; ``"auto"`` takes the env override
    or else the device of ``tensors`` (which must agree)."""
    validate_lowering(lowering)
    if lowering != "auto":
        return lowering
    env = _env_override()
    if env is not None:
        return env
    kinds = {t.device.type for t in tensors}
    if len(kinds) != 1:
        raise ValueError(
            "lowering 'auto' follows the device of its tensors and needs "
            f"them all on one device type; got {sorted(kinds) or 'none'}"
        )
    kind = kinds.pop()
    if kind == "cuda":
        return "cuda"
    if kind == "cpu":
        return "torch"
    raise RuntimeError(f"no kernel lowering for device type {kind!r}")


def require_cuda(lowering: str, tensor: torch.Tensor) -> None:
    """The resolved ``"cuda"`` lowering launches a kernel or raises: it never
    takes the plain version because a tensor happens to lie on the CPU."""
    if lowering == "cuda" and not tensor.is_cuda:
        raise ValueError(
            "lowering 'cuda' needs its tensors on a CUDA device; they lie on "
            f"{tensor.device} (use 'torch' or 'auto' for CPU tensors)")
