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

On a model mesh (DTensor operands, ``dist.placement``) a projection runs
kernel 2 on each card's blocks. Column-parallel (N on ``"model"``: q, k,
v, gate, up) needs nothing more: each row's scale and each column's see the
whole K. Row-parallel (K on ``"model"``: o, down) takes each row's
``max|x|`` over the whole K (a MAX all-reduce) before it quantizes, runs
kernel 2's int32-out route on its K slice (decode rows: the slice that
quantizes its own rows, one launch), all-reduces the int32 sums (exact, so
in any order) and runs the ADC + dequant as a launch of its own with the
full scale of the whole K, in the projection's dtype where autograd does
not record. Either is bit-equal to kernel 2 on one
card with the whole operands. Both carry the reference's scales-only
gradient (a row's or a column's maximum split over every rank's ties).

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
from repro_torch.kernels.psram_matmul import (ACT_DTYPES, M_DECODE, psram_adc_epilogue,
                                              psram_matmul, psram_matmul_int32,
                                              psram_matmul_int32_rows, psram_matmul_trained)

from .quantization import ADCConfig, QMAX, adc_requantize, quantize_symmetric, symmetric_scale


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
    ``sx * scale`` is f32. ``saturate=False`` leaves the ADC's codes
    unclipped, as the reference does (no wrap: a full-scale accumulation
    reads one code past the rail), through the same kernel launch on a CUDA
    tensor, a placed weight included.
    """
    if type(x) is not torch.Tensor or type(programmed["q"]) is not torch.Tensor:
        from repro_torch.dist.placement import is_dtensor
        if is_dtensor(programmed["q"]):
            return _psram_linear_placed(x, programmed, adc_bits, saturate)
    qw, sw = programmed["q"], programmed["scale"]
    k = qw.shape[0]
    if x.shape[-1] != k:
        raise ValueError(f"x (..., {x.shape[-1]}) does not match weights ({k}, N)")
    lead = x.shape[:-1]
    qx, sx = quantize_symmetric(x.reshape(-1, k), axis=-1)
    sx = sx.to(torch.float32)
    sw = sw.reshape(1, -1)
    recording = torch.is_grad_enabled() and (sx.requires_grad or sw.requires_grad)
    y = (psram_matmul_trained if recording else psram_matmul)(
        qx, qw.contiguous(), sx, sw.contiguous(), adc_bits=adc_bits, saturate=saturate)
    return y.reshape(*lead, y.shape[-1])


def _model_split(w) -> str:
    """How a placed weight ``(K, N)`` lies on the ``"model"`` axis:
    ``"k"`` (row-parallel), ``"n"`` (column-parallel) or ``"none"``."""
    from repro_torch.dist.placement import Shard, axis_placement
    p = axis_placement(w, "model")
    if not isinstance(p, Shard):
        return "none"
    return "k" if p.dim % w.ndim == w.ndim - 2 else "n"


class _GlobalAbsMax(torch.autograd.Function):
    """``max|t|`` over ``dim`` (kept) and over the ranks of ``group``, whose
    blocks of ``dim`` together make the whole: the gradient goes to the
    elements at the maximum, split evenly over every rank's ties, as
    ``amax`` splits it on one card."""

    @staticmethod
    def forward(ctx, t, dim, group):
        import torch.distributed as dist

        from repro_torch.dist.placement import all_reduce_
        m = t.abs().amax(dim=dim, keepdim=True)
        m = all_reduce_(m.to(torch.float32), group, dist.ReduceOp.MAX).to(t.dtype)
        ctx.save_for_backward(t, m)
        ctx.dim, ctx.group = dim, group
        return m

    @staticmethod
    def backward(ctx, g):
        from repro_torch.dist.placement import all_reduce_
        t, m = ctx.saved_tensors
        at_max = t.abs() == m
        ties = all_reduce_(at_max.sum(dim=ctx.dim, keepdim=True, dtype=torch.float32), ctx.group)
        return g * torch.sign(t) * at_max / ties.to(g.dtype), None, None


def _split_sums(x, sx, qw, group):
    """The int32 sums over the whole K of rows ``x`` (this rank's K slice)
    scaled by ``sx`` (x's dtype), all-reduced over ``group``: decode rows
    through :func:`psram_matmul_int32_rows` (one launch that quantizes its
    own rows), other rows quantized by ``quantize_symmetric``'s ops then
    :func:`psram_matmul_int32`. Both give the same bits."""
    from repro_torch.dist.placement import all_reduce_
    if x.shape[0] <= M_DECODE and x.dtype in ACT_DTYPES:
        acc = psram_matmul_int32_rows(x, sx, qw)
    else:
        acc = psram_matmul_int32(torch.round(x / sx).clamp(-QMAX, QMAX).to(torch.int8), qw)
    return all_reduce_(acc, group)


class _SplitScalesGrad(torch.autograd.Function):
    """Kernel 2 over a K split across ``group``: each rank's int32 sums
    (:func:`_split_sums`) all-reduced, then the epilogue launch with the
    whole K's full scale, written in ``out_dtype`` (f32 where autograd
    records). The gradient is :class:`_ScalesGrad`'s, through the scales
    only, from the saved sums; ``x`` gets none (its codes come from
    ``round``), ``sx`` its own dtype's."""

    @staticmethod
    def forward(ctx, x, sx, qw, sw, k, adc_bits, group, out_dtype, saturate):
        acc = _split_sums(x, sx, qw, group)
        sx32 = sx.to(torch.float32)
        ctx.save_for_backward(acc, sx32, sw)
        ctx.k, ctx.adc_bits, ctx.sx_dtype, ctx.saturate = k, adc_bits, sx.dtype, saturate
        return psram_adc_epilogue(acc, sx32, sw, k, adc_bits=adc_bits, out_dtype=out_dtype,
                                  saturate=saturate)

    @staticmethod
    def backward(ctx, g):
        acc, sx, sw = ctx.saved_tensors
        a = psram_adc_epilogue(acc, torch.ones_like(sx), torch.ones_like(sw), ctx.k,
                               adc_bits=ctx.adc_bits, saturate=ctx.saturate)
        ga = g * a
        grad_sx = ((ga * sw).sum(dim=1, keepdim=True).to(ctx.sx_dtype)
                   if ctx.needs_input_grad[1] else None)
        grad_sw = (ga * sx).sum(dim=0, keepdim=True) if ctx.needs_input_grad[3] else None
        return None, grad_sx, None, grad_sw, None, None, None, None, None


def _psram_linear_placed(x, programmed=None, adc_bits: int = 16, saturate: bool = True,
                         w=None, out_dtype: torch.dtype = torch.float32):
    """:func:`psram_linear` on a model mesh (see the module note): the
    stored words ``programmed``, or a weight ``w`` programmed here (each
    column's scale over the whole K). A row-parallel product that autograd
    does not record is written in ``out_dtype`` (f32 or bf16) by its
    epilogue launch; the others are f32."""
    from repro_torch.dist.placement import (DTensor, Replicate, Shard, axis_group, gathered,
                                            settled, to_local_partial)
    ref = gathered(w) if w is not None else settled(gathered(programmed["q"]))
    mesh = ref.device_mesh
    names = mesh.mesh_dim_names
    split = _model_split(ref)
    if not isinstance(x, DTensor):
        x = DTensor.from_local(x, mesh, [Replicate()] * mesh.ndim)
    want = list(x.placements)
    if "model" in names:
        want[names.index("model")] = Shard(x.ndim - 1) if split == "k" else Replicate()
    if tuple(want) != tuple(x.placements):
        x = x.redistribute(mesh, want)
    x_l = to_local_partial(x)
    if w is not None:
        w_l = to_local_partial(ref)
    else:
        qw_l = to_local_partial(ref)
        sw_l = to_local_partial(settled(gathered(programmed["scale"]))).reshape(1, -1)
    out = list(x.placements)
    if split != "k":
        y = psram_linear(x_l, program_weights(w_l) if w is not None
                         else {"q": qw_l, "scale": sw_l}, adc_bits=adc_bits, saturate=saturate)
        if "model" in names:
            out[names.index("model")] = Shard(y.ndim - 1) if split == "n" else Replicate()
        return DTensor.from_local(y, mesh, out)
    group = axis_group(ref, "model")
    k = ref.shape[-2]
    lead = x_l.shape[:-1]
    xr = x_l.reshape(-1, x_l.shape[-1])
    # each row's max|x| and each column's max|w| over the whole K, then
    # quantize_symmetric's own ops on them
    sx = symmetric_scale(_GlobalAbsMax.apply(xr, -1, group))
    if w is not None:
        scale = symmetric_scale(_GlobalAbsMax.apply(w_l, 0, group))
        qw_l = torch.round(w_l / scale).clamp(-QMAX, QMAX).to(torch.int8)
        sw_l = scale.to(torch.float32).reshape(1, -1)
    recorded = torch.is_grad_enabled() and (sx.requires_grad or sw_l.requires_grad)
    y = _SplitScalesGrad.apply(xr, sx, qw_l.contiguous(), sw_l.contiguous(), k, adc_bits, group,
                               out_dtype if out_dtype in ACT_DTYPES and not recorded
                               else torch.float32, saturate)
    out[names.index("model")] = Replicate()
    return DTensor.from_local(y.reshape(*lead, y.shape[-1]), mesh, out)


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
