"""Public float-in/float-out ops around the kernels.

Each op resolves its lowering through ``repro_torch.backends.lowering``
(``"auto"`` follows the device of the tensors it is handed) and dispatches
through an explicit per-op table: the hand-written CUDA kernel (``"cuda"``),
its plain PyTorch version (``"torch"``), the oracle from ``ref.py``
(``"ref"``). A resolved string with no table entry raises ``RuntimeError``
naming the op.

Ported: :func:`psram_matmul_op`, :func:`fused_stream_mttkrp_op`. The dense
MTTKRP pair, the blocked segment sum and attention ops come with their
kernels.
"""
from __future__ import annotations

import weakref

import torch

from repro_torch.backends.lowering import require_cuda, resolve_lowering
from repro_torch.core.quantization import quantize_symmetric

from . import ref
from .psram_matmul import psram_matmul, psram_matmul_torch


def _dispatch(op: str, table: dict, lowering: str):
    """Pick a lowering implementation, loudly: ``lowering`` must already be
    resolved, and anything without a table entry is a ``RuntimeError``
    naming the op."""
    try:
        return table[lowering]
    except KeyError:
        raise RuntimeError(
            f"kernel op {op!r} has no dispatch entry for resolved lowering "
            f"{lowering!r}; implemented: {', '.join(table)}"
        ) from None


# ------------------------------------------------- store-then-drive cache
#
# The pSRAM array *stores* one operand (weights / factors) and *drives* the
# other per cycle (§III): storing implies quantizing once, so the stored
# operand's int8 conversion is cached on tensor identity and only the driven
# operand is quantized per call. Weakref-guarded against id reuse. Identity
# keying means a stored tensor must not be updated in place.

_STORE_CACHE: dict = {}
_STORE_CACHE_MAX = 64


def _stored(arrs: tuple, tag: str, build):
    key = (tag,) + tuple(id(a) for a in arrs)
    hit = _STORE_CACHE.get(key)
    if hit is not None and all(r() is a for r, a in zip(hit[0], arrs)):
        return hit[1]
    val = build(*arrs)
    if len(_STORE_CACHE) >= _STORE_CACHE_MAX:
        _STORE_CACHE.clear()
    _STORE_CACHE[key] = (tuple(weakref.ref(a) for a in arrs), val)
    return val


def _quant_drive_rows(x):
    """Per-row int8 quantization of the driven operand."""
    q, s = quantize_symmetric(x, axis=-1)
    return q, s.to(torch.float32)


def _store_matmul_weights(w):
    qw, sw = quantize_symmetric(w, axis=0)
    return qw.contiguous(), sw.to(torch.float32)


def psram_matmul_op(
    x: torch.Tensor, w: torch.Tensor, adc_bits: int = 16, lowering: str = "auto"
) -> torch.Tensor:
    """Float-in/float-out pSRAM matmul ``x (M,K) @ w (K,N)``: store-quantize
    the weights per column (cached on identity), drive-quantize the input
    per row, run the array kernel, dequant."""
    low = resolve_lowering(lowering, x, w)
    require_cuda(low, x)
    qw, sw = _stored((w,), "matmul_w", _store_matmul_weights)
    qx, sx = _quant_drive_rows(x.contiguous())
    fn = _dispatch("psram_matmul", {
        "cuda": psram_matmul,
        "torch": psram_matmul_torch,
        "ref": ref.psram_matmul_ref,
    }, low)
    return fn(qx, qw, sx, sw, adc_bits=adc_bits)


def fused_stream_mttkrp_op(
    csf, factors, config=None, adc_bits: int = 16, lowering: str = "auto",
    exec_blocks: int | None = None, autotune: bool = False,
) -> torch.Tensor:
    """Sparse streaming MTTKRP through the fused kernel family (chain +
    per-segment sums + ADC epilogue + cross-block accumulation); see
    kernels/stream_mttkrp.py."""
    from repro_torch.backends.base import resolve_config
    from .autotune import stream_params
    from .stream_mttkrp import fused_stream_mttkrp

    cfg = resolve_config(config)
    factors = tuple(factors)
    low = resolve_lowering(lowering, csf.values, *factors)
    if exec_blocks is None:
        exec_blocks = stream_params(csf, factors, cfg, tune=autotune)["exec_blocks"]
    return fused_stream_mttkrp(
        csf, factors, cfg, adc_bits=adc_bits, lowering=low,
        exec_blocks=exec_blocks,
    )
