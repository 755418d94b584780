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

Two routes, one contract. Rows above :data:`M_DECODE` take the tile kernel
(``psram_matmul_kernel``: 128 x 128 CTA tiles on ``mma.sync``); decode rows
(``M <= M_DECODE``) take ``psram_matmul_decode_kernel``, a weight-streaming
pass with the roles of the operands swapped and K split across the warps of
a CTA and a thread-block cluster (its size chosen by the library,
``psram_matmul_decode_cluster``), reduced in int32 through distributed
shared memory in one launch. Integer sums are exact under any split, so
both routes are bit-equal to the plain version. The int32 sums need
``128²·K < 2³¹`` (K ≤ :data:`MAX_K`): the CUDA wrapper raises above it, on
either route. ``psram_matmul.launches`` counts every launch;
``psram_matmul.routes`` counts them by route.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core.quantization import QMAX, adc_transfer, exact_int_matmul

from . import _build

#: rows up to which the decode route is taken (timed crossover; PERF.md)
M_DECODE = 16
#: the largest K whose int32 sums are exact for any int8 codes: 128² · K < 2³¹
MAX_K = (2 ** 31 - 1) // (128 * 128)


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


def _decode_cluster(k: int, n: int, sms: int) -> int:
    """CTAs a cluster of the decode kernel has at ``K x N`` on ``sms`` SMs,
    as the built library chooses them."""
    fn = _build.load("psram_matmul").psram_matmul_decode_cluster
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_int] * 3
    return fn(k, n, sms)


def _entry(route: str):
    lib = _build.load("psram_matmul")
    fn = lib.psram_matmul_decode_launch if route == "decode" else lib.psram_matmul_launch
    if not fn.argtypes:
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3 + [ctypes.c_float] * 2 \
            + ([ctypes.c_int] if route == "decode" else []) + [ctypes.c_void_p]
    return lib, fn


def psram_matmul(
    qx: torch.Tensor,   # (M, K) int8
    qw: torch.Tensor,   # (K, N) int8
    sx: torch.Tensor,   # (M, 1) f32
    sw: torch.Tensor,   # (1, N) f32
    adc_bits: int = 16,
) -> torch.Tensor:
    """``ADC(qx @ qw) * (sx * sw)`` as ``(M, N)`` f32. Any ``M, K, N`` (the
    kernels mask ragged edges themselves). CUDA tensors go through one
    kernel launch on the current stream, without synchronizing: the decode
    kernel for ``M <= M_DECODE``, else the tile kernel. CPU tensors go
    through :func:`psram_matmul_torch`."""
    if not qx.is_cuda:
        return psram_matmul_torch(qx, qw, sx, sw, adc_bits=adc_bits)
    return _launch(qx, qw, sx, sw, adc_bits)


def _launch(qx, qw, sx, sw, adc_bits: int = 16, route: str | None = None,
            cluster: int = 0) -> torch.Tensor:
    """One launch of kernel 2 on CUDA tensors. ``route`` None takes the
    route :func:`psram_matmul` takes; the checks name ``"tile"`` or
    ``"decode"`` to hold one route against the other, and ``cluster`` a
    decode cluster size (1..8; 0 is the library's choice). Either only
    chooses how the same result is computed."""
    if route not in (None, "tile", "decode"):
        raise ValueError(f"route must be 'tile' or 'decode', got {route!r}")
    m, k, n = _check_operands(qx, qw, sx, sw)
    if not qx.is_cuda:
        raise ValueError("kernel 2 launches on CUDA tensors only")
    if not 1 <= adc_bits <= 24:
        raise ValueError(f"adc_bits must be in 1..24 for the kernel, got {adc_bits}")
    if k > MAX_K:
        raise ValueError(f"K={k} exceeds {MAX_K}: the kernels' int32 sums would overflow")
    for name, t in (("qx", qx), ("qw", qw), ("sx", sx), ("sw", sw)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if route is None:
        route = "decode" if m <= M_DECODE else "tile"
    if route == "decode" and m > 16:
        raise ValueError(f"the decode route takes up to 16 rows, got {m}")
    levels = 2 ** adc_bits
    # exactly the plain version's LSB: formed in double, rounded once to f32
    lsb = 2.0 * (float(QMAX) * float(QMAX) * k) / levels
    extra = (int(cluster),) if route == "decode" else ()
    out = torch.empty((m, n), dtype=torch.float32, device=qx.device)
    lib, fn = _entry(route)
    with torch.cuda.device(qx.device):
        err = fn(qx.data_ptr(), qw.data_ptr(), sx.data_ptr(), sw.data_ptr(),
                 out.data_ptr(), m, k, n, lsb, float(levels // 2 - 1), *extra,
                 torch.cuda.current_stream().cuda_stream)
    _build.check_launch(err, lib, "psram_matmul")
    psram_matmul.launches += 1
    psram_matmul.routes[route] += 1
    return out


#: kernel launches made by :func:`psram_matmul` (CUDA path only), all routes
psram_matmul.launches = 0
#: the same launches by route
psram_matmul.routes = {"tile": 0, "decode": 0}
