"""Quantization numerics of the photonic SRAM compute engine (PyTorch).

The paper's array (§III) encodes *inputs* as 8-bit intensity levels on the
word-lines and stores *weights* as binary bit-planes inside 8-bit pSRAM words.
Per-bit analog products are scaled by bit significance at the output encoder
and accumulated as photocurrent, then digitized by an on-chip ADC.

Arithmetically the array computes (per column, per wavelength channel)

    y = ADC( sum_rows  x_row * sum_b 2^b * w_{row,b} )  =  ADC( x . w )

i.e. an exact integer dot product followed by ADC requantization. Signed
values ride the differential rail: symmetric int8, the sign selects the rail.

Rounding is half-to-even everywhere (``torch.round``), and every division is
a true division (``x / scale``, ``acc / lsb``) — never a reciprocal multiply,
which lands on a different code at ties. PyTorch's CUDA division by a Python
scalar IS a reciprocal multiply, so scalar divisors are made 0-d tensors on
the operand's device first (:func:`_scalar`).
"""
from __future__ import annotations

import dataclasses

import torch

# 8-bit word width of the pSRAM array (§V: 8 bits collected per word).
WORD_BITS = 8
QMAX = 2 ** (WORD_BITS - 1) - 1  # 127 — symmetric signed range


@dataclasses.dataclass(frozen=True)
class ADCConfig:
    """On-chip ADC model (§III-C).

    bits:     ADC resolution. The analog accumulated photocurrent is mapped
              onto 2**bits levels across the observed dynamic range.
    saturate: clip instead of wrap when the accumulation exceeds full scale.
    """

    bits: int = 16
    saturate: bool = True

    @property
    def levels(self) -> int:
        return 2 ** self.bits


def _scalar(value: float, like: torch.Tensor) -> torch.Tensor:
    """``value`` as a 0-d f32 tensor on ``like``'s device (a true-division
    divisor on every device)."""
    return torch.full((), value, dtype=torch.float32, device=like.device)


def quantize_symmetric(x: torch.Tensor, axis=None) -> tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-axis int8 quantization: x ~= q * scale, q in [-127,127].

    ``axis`` None = one per-tensor scale (0-d), otherwise the reduction axes
    (int or tuple) that share one scale; the scale keeps those dims as 1.
    """
    if axis is None:
        amax = x.abs().max()
    else:
        amax = x.abs().amax(dim=axis, keepdim=True)
    scale = amax.clamp_min(1e-12) / _scalar(QMAX, x)
    q = torch.round(x / scale).clamp(-QMAX, QMAX).to(torch.int8)
    return q, scale


def dequantize(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale


def _shifts(device) -> torch.Tensor:
    return torch.arange(WORD_BITS, dtype=torch.int32, device=device)


def to_bitplanes(q: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Decompose signed int8 into (sign, bit-planes).

    Returns ``(sign, planes)`` with ``planes[..., b]`` the b-th magnitude bit
    (uint8 in {0,1}), so that ``q = sign * sum_b planes[...,b] << b`` — one
    pSRAM bitcell per plane bit, the sign carried on the differential rail.
    """
    q = q.to(torch.int32)
    sign = torch.sign(q).to(torch.int8)
    mag = q.abs()
    planes = ((mag[..., None] >> _shifts(q.device)) & 1).to(torch.uint8)
    return sign, planes


def from_bitplanes(sign: torch.Tensor, planes: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`to_bitplanes`."""
    mag = (planes.to(torch.int32) << _shifts(planes.device)).sum(dim=-1)
    return (sign.to(torch.int32) * mag).to(torch.int8)


def adc_transfer(acc: torch.Tensor, levels: int, full_scale, saturate: bool = True) -> torch.Tensor:
    """The ADC transfer curve (§III-C).

    Mid-rise uniform quantization onto ``levels`` codes across
    [-full_scale, +full_scale], optionally clipped at the rails.
    ``full_scale`` is a Python float (the LSB is then formed in double and
    rounded once to f32, as a weakly-typed scalar is in the reference) or an
    f32 tensor broadcastable against ``acc``. The CUDA kernels' epilogues
    repeat exactly this arithmetic (``rintf`` of a true division).
    """
    acc = acc.to(torch.float32)
    if isinstance(full_scale, torch.Tensor):
        lsb = (2.0 * full_scale) / _scalar(levels, full_scale)
    else:
        lsb = _scalar(2.0 * full_scale / levels, acc)
    code = torch.round(acc / lsb)
    if saturate:
        half = levels // 2
        code = code.clamp(-(half - 1), half - 1)
    return code * lsb


def adc_requantize(acc: torch.Tensor, adc: ADCConfig, full_scale) -> torch.Tensor:
    """Digitize an integer/analog accumulation through the ADC transfer curve
    of ``adc`` (see :func:`adc_transfer`)."""
    return adc_transfer(acc, adc.levels, full_scale, adc.saturate)


class _FakeQuantSTE(torch.autograd.Function):
    """Quantize-dequantize forward, identity backward."""

    @staticmethod
    def forward(ctx, x, axis):
        q, scale = quantize_symmetric(x, axis=axis)
        y = dequantize(q, scale)
        # the reference evaluates x + (y - x); keep its rounding
        return x + (y - x)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def fake_quant(x: torch.Tensor, axis=None) -> torch.Tensor:
    """Quantize-dequantize round trip (straight-through in the backward pass)."""
    return _FakeQuantSTE.apply(x, axis)


def exact_int_matmul(qa: torch.Tensor, qb: torch.Tensor) -> torch.Tensor:
    """``qa @ qb`` of integer-valued operands, exact on every device.

    CUDA has no integer ``torch.matmul``; float64 holds every partial sum of
    int8 products exactly (``127^2 * K < 2^53``). The result is float64 with
    integer values: converting it to f32 rounds to nearest-even exactly as an
    int32 accumulator would.
    """
    return qa.to(torch.float64) @ qb.to(torch.float64)


def psram_quantized_matmul(
    x: torch.Tensor,
    w: torch.Tensor,
    adc_bits: int = 16,
    saturate: bool = True,
) -> torch.Tensor:
    """Reference pSRAM matmul numerics: y ~= x @ w through the array.

    x: (..., K) float — intensity-encoded (per-tensor scale).
    w: (K, N) float — stored in the array (per-column scale: each array
       column holds one output word-column, so a per-column scale is free).
    Returns float32 (..., N) after ADC requantization and dequant.
    """
    adc = ADCConfig(bits=adc_bits, saturate=saturate)
    qx, sx = quantize_symmetric(x)                      # per-tensor
    qw, sw = quantize_symmetric(w, axis=0)              # per-column, shape (1, N)
    acc = exact_int_matmul(qx, qw)
    # analog full scale: every row at max intensity hitting a full word
    full_scale = float(QMAX) * float(QMAX) * w.shape[0]
    acc = adc_requantize(acc, adc, full_scale)
    return acc * (sx * sw)
