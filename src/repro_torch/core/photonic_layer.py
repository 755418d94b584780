"""PsramLinear — photonic-offload projection layer for the LM model zoo.

Simulates offloading a dense projection (attention q/k/v/o, MLP, expert)
onto the pSRAM engine: weights are held as 8-bit words with per-output-column scales,
activations are intensity-encoded to 8-bit per row on the fly, and the
accumulation passes the ADC model.

Numerically this is the transfer function of ``kernels/psram_matmul.py``
(``ADC(qx @ qw) * (sx * sw)``), with the weight quantization done once at
"programming" time (weights are stationary in the array; only inputs
stream). :func:`psram_linear` calls that kernel's wrapper on every
projection: on a CUDA tensor it launches the hand-written kernel, on a CPU
tensor its plain version. Where autograd records, the wrapper carries the
reference's gradient (``psram_matmul_trained``): through the scales only,
so it reaches ``x`` and the weight through each row's and each column's
``max|.|`` (split evenly at ties, as ``jnp.max`` splits it), never through
the int8 codes.

:func:`psram_einsum` is the MoE experts' batched form. The reference
computes it outside any Pallas kernel (a ``jnp.einsum`` of int32 codes), so
here it is plain PyTorch on the tensors' device: the integer contraction
runs as an exact float product, as ``core.schedule``'s executor runs its
own; on the card ``chip_smoke.py`` holds it bit-equal to kernel 2 run on
each expert's slice.
"""
from __future__ import annotations

import torch

from repro_torch._device import ieee_f32
from repro_torch.kernels.psram_matmul import psram_matmul, psram_matmul_trained

from .quantization import ADCConfig, QMAX, adc_requantize, exact_int_matmul, quantize_symmetric


def program_weights(w: torch.Tensor) -> dict:
    """Quantize a (K, N) weight once, as the array programming step."""
    q, scale = quantize_symmetric(w, axis=0)  # per-output-column scale (1, N)
    return {"q": q, "scale": scale.to(torch.float32)}


def psram_linear(
    x: torch.Tensor,
    programmed: dict,
    adc_bits: int = 16,
    saturate: bool = True,
) -> torch.Tensor:
    """y = ADC(quant(x) @ q_w) * scales as f32, for x of shape (..., K).

    ``x`` is quantized per row in its own dtype (a bf16 activation gets a
    bf16 scale and a bf16 division, as in the reference); the scale product
    ``sx * scale`` is f32. The kernel's epilogue always saturates at the
    ADC rails, so ``saturate=False`` raises on a CUDA tensor; on the CPU it
    takes the plain arithmetic with a wrapping curve.
    """
    qw, sw = programmed["q"], programmed["scale"]
    k = qw.shape[0]
    if x.shape[-1] != k:
        raise ValueError(f"x (..., {x.shape[-1]}) does not match weights ({k}, N)")
    lead = x.shape[:-1]
    qx, sx = quantize_symmetric(x.reshape(-1, k), axis=-1)
    sx = sx.to(torch.float32)
    sw = sw.reshape(1, -1)
    if saturate:
        recording = torch.is_grad_enabled() and (sx.requires_grad or sw.requires_grad)
        y = (psram_matmul_trained if recording else psram_matmul)(
            qx, qw.contiguous(), sx, sw.contiguous(), adc_bits=adc_bits)
    elif x.is_cuda:
        raise ValueError(
            "psram_linear(saturate=False): the psram_matmul kernel's ADC epilogue "
            "clips at the rails and has no wrapping form")
    else:
        acc = exact_int_matmul(qx, qw)
        adc = ADCConfig(bits=adc_bits, saturate=False)
        y = adc_requantize(acc, adc, float(QMAX) * float(QMAX) * k) * (sx * sw)
    return y.reshape(*lead, y.shape[-1])


def maybe_psram_matmul(x: torch.Tensor, w: torch.Tensor, enabled: bool,
                       adc_bits: int = 16) -> torch.Tensor:
    """Drop-in for ``x @ w`` in model code; exact matmul when disabled."""
    if not enabled:
        return x @ w
    return psram_linear(x, program_weights(w), adc_bits=adc_bits).to(x.dtype)


def psram_einsum(spec: str, x: torch.Tensor, w: dict, adc_bits: int = 16) -> torch.Tensor:
    """Batched expert einsum through stored-int8 array words, f32.

    ``spec`` contracts x's last dim against ``w["q"]``'s middle dim (e.g.
    ``"ecd,edf->ecf"``); ``w["scale"]`` broadcasts over the output. ``x`` is
    quantized per row in its own dtype, as :func:`psram_linear` quantizes
    it. Every partial sum of the contraction is an integer bounded by
    ``QMAX^2 * K``: while that fits float32's 2^24 integer range (K <=
    1040) the product runs in float32 with TF32 off, else in float64 — the
    reference's int32 integers either way. The ADC then digitizes at full
    scale ``QMAX^2 * K`` and the codes dequantize by ``sx * scale``.
    """
    qx, sx = quantize_symmetric(x, axis=-1)
    k = x.shape[-1]
    full_scale = float(QMAX) * float(QMAX) * k
    ctype = torch.float32 if full_scale < 2 ** 24 else torch.float64
    with ieee_f32():
        acc = torch.einsum(spec, qx.to(ctype), w["q"].to(ctype))
    acc = adc_requantize(acc, ADCConfig(bits=adc_bits), full_scale)
    return acc * (sx.to(torch.float32) * w["scale"].to(torch.float32))
