"""The pSRAM array's quantized matmul: ``ADC(qx @ qw) * (sx * sw)``.

The hand-written Hopper kernel lives in ``csrc/psram_matmul.cu`` (CUDA C++,
``sm_90a``); it replaces the TPU kernel
``src/repro/kernels/psram_matmul.py:_kernel`` (launched by ``psram_matmul``).
The TPU kernel's K grid dimension becomes a loop inside the CTA, the int32
accumulator stays in registers, and the ADC + dequant epilogue runs on it
before the one f32 store. What bounds it on the card is operations (the int8
tensor-core rate at projection shapes): the product runs on the tensor cores
through warp-level ``mma.sync`` in a plain two-barrier loop — see the source
note in the ``.cu`` file.

:func:`psram_matmul` is the wrapper: for CUDA tensors it launches the kernel
(or raises); for CPU tensors — and only because they lie on the CPU — it
uses :func:`psram_matmul_torch`, the plain PyTorch version of the same
function. The two are bit-equal: integer accumulation is exact under any
tiling, and the epilogue is the same f32 arithmetic (``lsb`` formed in
double on the host, true division, round-half-even, no FMA contraction).
The int32→f32 conversion rounds to nearest-even once ``127²·K`` passes 2²⁴
(K ≥ 1041) in both.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core.quantization import QMAX, adc_transfer, exact_int_matmul

from . import _build


def _check_operands(qx, qw, sx, sw):
    if qx.ndim != 2 or qw.ndim != 2:
        raise ValueError(f"qx/qw must be 2-D, got {tuple(qx.shape)} / {tuple(qw.shape)}")
    m, k = qx.shape
    k2, n = qw.shape
    if k != k2:
        raise ValueError(f"inner dims differ: qx {tuple(qx.shape)} vs qw {tuple(qw.shape)}")
    if tuple(sx.shape) != (m, 1) or tuple(sw.shape) != (1, n):
        raise ValueError(
            f"scales must be sx (M,1) and sw (1,N); got {tuple(sx.shape)} / {tuple(sw.shape)}")
    if qx.dtype != torch.int8 or qw.dtype != torch.int8:
        raise TypeError(f"qx/qw must be int8, got {qx.dtype} / {qw.dtype}")
    if sx.dtype != torch.float32 or sw.dtype != torch.float32:
        raise TypeError(f"sx/sw must be float32, got {sx.dtype} / {sw.dtype}")
    if len({t.device for t in (qx, qw, sx, sw)}) != 1:
        raise ValueError("qx, qw, sx, sw must live on one device")
    return m, k, n


def psram_matmul_torch(
    qx: torch.Tensor,   # (M, K) int8
    qw: torch.Tensor,   # (K, N) int8
    sx: torch.Tensor,   # (M, 1) f32
    sw: torch.Tensor,   # (1, N) f32
    adc_bits: int = 16,
) -> torch.Tensor:
    """Plain PyTorch version of the kernel, exact on every device: the
    accumulator is formed in float64 (every partial sum of int8 products is
    an exact integer there), converted once to f32, then the shared ADC
    epilogue."""
    _check_operands(qx, qw, sx, sw)
    acc = exact_int_matmul(qx, qw)
    full_scale = float(QMAX) * float(QMAX) * qx.shape[-1]
    analog = adc_transfer(acc, 2 ** adc_bits, full_scale)
    return analog * (sx * sw)


def _entry():
    lib = _build.load("psram_matmul")
    fn = lib.psram_matmul_launch
    if not fn.argtypes:
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3 \
            + [ctypes.c_float] * 2 + [ctypes.c_void_p]
    return lib, fn


def psram_matmul(
    qx: torch.Tensor,   # (M, K) int8
    qw: torch.Tensor,   # (K, N) int8
    sx: torch.Tensor,   # (M, 1) f32
    sw: torch.Tensor,   # (1, N) f32
    adc_bits: int = 16,
) -> torch.Tensor:
    """``ADC(qx @ qw) * (sx * sw)`` as ``(M, N)`` f32. Any ``M, K, N`` (the
    kernel masks ragged edges itself). CUDA tensors go through the kernel on
    the current stream, without synchronizing; CPU tensors through
    :func:`psram_matmul_torch`."""
    m, k, n = _check_operands(qx, qw, sx, sw)
    if not qx.is_cuda:
        return psram_matmul_torch(qx, qw, sx, sw, adc_bits=adc_bits)
    if not 1 <= adc_bits <= 24:
        raise ValueError(f"adc_bits must be in 1..24 for the kernel, got {adc_bits}")
    for name, t in (("qx", qx), ("qw", qw), ("sx", sx), ("sw", sw)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    levels = 2 ** adc_bits
    # exactly the plain version's LSB: formed in double, rounded once to f32
    lsb = 2.0 * (float(QMAX) * float(QMAX) * k) / levels
    out = torch.empty((m, n), dtype=torch.float32, device=qx.device)
    lib, fn = _entry()
    with torch.cuda.device(qx.device):
        err = fn(qx.data_ptr(), qw.data_ptr(), sx.data_ptr(), sw.data_ptr(),
                 out.data_ptr(), m, k, n, lsb, float(levels // 2 - 1),
                 torch.cuda.current_stream().cuda_stream)
    _build.check_launch(err, lib, "psram_matmul")
    psram_matmul.launches += 1
    return out


#: kernel launches made by :func:`psram_matmul` (CUDA path only)
psram_matmul.launches = 0
