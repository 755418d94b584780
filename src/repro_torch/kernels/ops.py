"""Public float-in/float-out ops around the kernels.

Each op resolves its lowering through ``repro_torch.backends.lowering``
(``"auto"`` follows the device of the tensors it is handed) and dispatches
through an explicit per-op table: the hand-written CUDA kernel (``"cuda"``),
its plain PyTorch version (``"torch"``), the oracle from ``ref.py``
(``"ref"``). A resolved string with no table entry raises ``RuntimeError``
naming the op.

Ported: :func:`psram_matmul_op`, :func:`mttkrp_op`, :func:`mttkrp_psram_op`,
:func:`fused_stream_mttkrp_op`, :func:`blocked_segment_sum_op`,
:func:`flash_attention_op` — every op of the reference's ``kernels/ops.py``
that reaches a Pallas kernel — and :func:`blocked_chain_segment_sum_op`, the
blocked segment sum with the exact chain formed in its kernel.
:func:`fused_stream_mttkrp_op` takes ``autotune=True``: the chunk size from
``kernels.autotune``'s winner cache, swept on a miss.
"""
from __future__ import annotations

import weakref

import torch

from repro_torch._device import ieee_f32
from repro_torch.backends.lowering import require_cuda, resolve_lowering
from repro_torch.core.quantization import quantize_symmetric

from . import ref
from .mttkrp import (
    _layout_of,
    mttkrp_fused,
    mttkrp_fused_torch,
    mttkrp_psram_fused,
    mttkrp_psram_strided,
    mttkrp_psram_torch,
)
from .flash_attention import flash_attention, flash_attention_torch
from .psram_matmul import psram_matmul, psram_matmul_torch
from .segment_sum import (
    blocked_chain_segment_sum,
    blocked_chain_segment_sum_torch,
    blocked_segment_sum,
    blocked_segment_sum_torch,
    padded_chain,
)


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


def clear_store_cache() -> None:
    """Forget every stored operand's cached int8 conversion."""
    _STORE_CACHE.clear()


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


def _unfold0(x):
    """The mode-0 unfolding ``(I, J*K)`` of a 3-mode tensor, contiguous (a
    view where ``x`` already is; one copy of a permuted tensor)."""
    if x.ndim != 3:
        raise ValueError(f"x must be a 3-mode tensor (I, J, K), got {tuple(x.shape)}")
    i, j, k = x.shape
    return x.reshape(i, j * k).contiguous()


@ieee_f32()
def mttkrp_op(
    x: torch.Tensor, b: torch.Tensor, c: torch.Tensor, lowering: str = "auto",
    bi: int = 128, bk: int = 128,
) -> torch.Tensor:
    """Dense mode-0 MTTKRP (exact arithmetic, IEEE f32 whatever TF32 setting
    the caller chose); x is the 3-mode tensor (I, J, K)."""
    low = resolve_lowering(lowering, x, b, c)
    require_cuda(low, x)
    x0 = _unfold0(x)
    b, c = b.contiguous(), c.contiguous()
    fn = _dispatch("mttkrp", {
        "cuda": lambda: mttkrp_fused(x0, b, c, bi=bi, bk=bk),
        "torch": lambda: mttkrp_fused_torch(x0, b, c, bi=bi, bk=bk),
        "ref": lambda: ref.mttkrp_ref(x0, b, c),
    }, low)
    return fn()


def _store_mttkrp_factors(b, c):
    qb, sb = quantize_symmetric(b, axis=-1)
    qc, sc = quantize_symmetric(c, axis=-1)
    return qb.contiguous(), sb.to(torch.float32), qc.contiguous(), sc.to(torch.float32)


def mttkrp_psram_op(
    x: torch.Tensor, b: torch.Tensor, c: torch.Tensor, lowering: str = "auto",
    bi: int = 128, bk: int = 128, adc_bits: int = 16,
) -> torch.Tensor:
    """Dense mode-0 MTTKRP through the array numerics — the fused
    matricized-KR variant: int8 operands, KR tiles from quantized factor
    rows, ADC transfer epilogue per output tile. x is (I, J, K). The KR
    factors are the stored operand (quantization cached on identity), the
    unfolding is drive-quantized per call: on the card, where ``x`` is an
    unfolding TMA reads in place (every mode of a contiguous tensor, as
    ``HopperBackend`` permutes it), by the kernel as it stages each tile
    (``mttkrp_psram_strided``, the same codes and scales); elsewhere
    eagerly, before the kernel."""
    low = resolve_lowering(lowering, x, b, c)
    require_cuda(low, x)
    qb, sb, qc, sc = _stored((b, c), "mttkrp_bc", _store_mttkrp_factors)
    if low == "cuda" and _layout_of(x) is not None:
        return mttkrp_psram_strided(x, qb, sb, qc, sc, bi=bi, bk=bk, adc_bits=adc_bits)
    qx, sx = _quant_drive_rows(_unfold0(x))
    ops = (qx, sx, qb, sb, qc, sc)
    fn = _dispatch("mttkrp_psram", {
        "cuda": lambda: mttkrp_psram_fused(*ops, bi=bi, bk=bk, adc_bits=adc_bits),
        "torch": lambda: mttkrp_psram_torch(*ops, bi=bi, adc_bits=adc_bits),
        "ref": lambda: ref.mttkrp_psram_ref(*ops, bi=bi, adc_bits=adc_bits),
    }, low)
    return fn()


def blocked_segment_sum_op(
    data: torch.Tensor, seg_ids: torch.Tensor, n_seg: int, lowering: str = "auto"
) -> torch.Tensor:
    """Per-block segment sums for the CSF streaming path: (B, n_seg, R).

    ``data`` (B, bn, R) holds blocks of CP2 chain rows, ``seg_ids`` (B, bn)
    their block-local output-row segment; see kernels/segment_sum.py.
    """
    low = resolve_lowering(lowering, data, seg_ids)
    require_cuda(low, data)
    fn = _dispatch("blocked_segment_sum", {
        "cuda": blocked_segment_sum,
        "torch": blocked_segment_sum_torch,
        "ref": ref.blocked_segment_sum_ref,
    }, low)
    return fn(data, seg_ids, n_seg)


def blocked_chain_segment_sum_op(
    coords: torch.Tensor, values: torch.Tensor, seg_ids: torch.Tensor, factors, mode: int,
    n_seg: int, lowering: str = "auto", psram: bool = False, adc_bits: int = 16,
) -> torch.Tensor:
    """Per-block segment sums of a sparse stream's chain: (B, n_seg, R).

    ``coords (nnz, nmodes - 1)`` are the stream's non-target coordinates
    (``kernels.ordered_fold.chain_coords``), ``values (nnz,)`` its values,
    ``seg_ids (B, bn)`` the block-local output-row segment of each position
    (``nnz <= B·bn``; positions past ``nnz`` add nothing); the chain is
    ``cp_chain_exact``'s, or with ``psram`` the quantized chain of
    ``cp_chain_psram`` at ``adc_bits``. On the card one launch forms and sums
    it (kernels/segment_sum.py's chain route); ``"torch"`` and ``"ref"`` form
    the padded chain and sum it with the plain version or the one-hot
    oracle.
    """
    factors = tuple(factors)
    low = resolve_lowering(lowering, coords, values, seg_ids, *factors)
    require_cuda(low, values)
    fn = _dispatch("blocked_chain_segment_sum", {
        "cuda": lambda: blocked_chain_segment_sum(coords, values, seg_ids, factors, mode, n_seg,
                                                  psram=psram, adc_bits=adc_bits),
        "torch": lambda: blocked_chain_segment_sum_torch(coords, values, seg_ids, factors, mode,
                                                         n_seg, psram, adc_bits),
        "ref": lambda: ref.blocked_segment_sum_ref(
            padded_chain(coords, values, seg_ids, factors, mode, psram, adc_bits), seg_ids,
            n_seg),
    }, low)
    return fn()


def fused_stream_mttkrp_op(
    csf, factors, config=None, adc_bits: int = 16, lowering: str = "auto",
    exec_blocks: int | None = None, autotune: bool = False,
) -> torch.Tensor:
    """Sparse streaming MTTKRP through the fused kernel family (chain +
    per-segment sums + ADC epilogue + cross-block accumulation); see
    kernels/stream_mttkrp.py. ``exec_blocks=None`` asks ``kernels.autotune``
    for the chunk size: its heuristic, or with ``autotune=True`` the cached
    winner of a sweep over the real operands (run here on a miss). The
    chunk size is numerics: a tuned call is bit-equal to an untuned call
    given the winner's ``exec_blocks``."""
    from repro_torch.backends.base import resolve_config
    from .autotune import stream_params
    from .stream_mttkrp import fused_stream_mttkrp

    cfg = resolve_config(config)
    factors = tuple(factors)
    low = resolve_lowering(lowering, csf.values, *factors)
    if exec_blocks is None:
        exec_blocks = stream_params(csf, factors, cfg, tune=autotune, adc_bits=adc_bits,
                                    lowering=low)["exec_blocks"]
    return fused_stream_mttkrp(
        csf, factors, cfg, adc_bits=adc_bits, lowering=low,
        exec_blocks=exec_blocks,
    )


def flash_attention_op(
    q, k, v, causal: bool = True, softcap: float = 0.0, scale: float | None = None,
    lowering: str = "auto", bq: int = 128, bkv: int = 128,
) -> torch.Tensor:
    """Attention ``(B, H, Sq, D)`` from q ``(B, H, Sq, D)`` and k/v
    ``(B, Hkv, Skv, D)``: GQA, causal (top-left), logit softcap; see
    kernels/flash_attention.py. A lowering name outside the table (the
    reference's ``"xla"``, ``"pallas"``, ...) raises ``RuntimeError`` naming
    the op."""
    low = resolve_lowering(lowering, q, k, v) if lowering == "auto" else lowering
    require_cuda(low, q)
    fn = _dispatch("flash_attention", {
        "cuda": lambda: flash_attention(q, k, v, causal=causal, softcap=softcap,
                                        scale=scale, bq=bq, bkv=bkv),
        "torch": lambda: flash_attention_torch(q, k, v, causal=causal, softcap=softcap,
                                               scale=scale, bq=bq, bkv=bkv),
        "ref": lambda: ref.attention_ref(q, k, v, causal=causal, softcap=softcap,
                                         scale=scale),
    }, low)
    return fn()
