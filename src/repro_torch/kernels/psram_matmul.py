"""The pSRAM array's quantized matmul: ``ADC(qx @ qw) * (sx * sw)``.

The hand-written Hopper kernels live in ``csrc/psram_matmul.cu`` (CUDA C++,
``sm_90a``); they replace the TPU kernel
``src/repro/kernels/psram_matmul.py:_kernel`` (launched by ``psram_matmul``).
The TPU kernel's K grid dimension becomes a loop inside the CTA, the int32
accumulator stays in registers, and the ADC + dequant epilogue runs on it
before the one f32 store. What bounds it on the card at projection shapes is
operations (the int8 tensor-core rate) — see the source note in the ``.cu``
file.

:func:`psram_matmul` is the wrapper: for CUDA tensors it launches the kernel
(or raises); for CPU tensors — and only because they lie on the CPU — it
uses :func:`psram_matmul_torch`, the plain PyTorch version of the same
function. The two are bit-equal: integer accumulation is exact under any
tiling, and the epilogue is the same f32 arithmetic (``lsb`` formed in
double on the host, true division, round-half-even, no FMA contraction).
The int32→f32 conversion rounds to nearest-even once ``127²·K`` passes 2²⁴
(K ≥ 1041) in both.

Three routes, one contract, chosen by shape and alignment alone
(:func:`_route`):

* ``"wgmma"`` — rows above :data:`M_DECODE` whose operands TMA can take
  (``qx`` and ``qw`` start on 16 bytes, K and N multiples of 16):
  ``psram_matmul_wgmma_kernel``, warpgroup MMAs (``wgmma`` s8) fed by TMA
  through a shared-memory ring, the roles of the operands swapped so that
  ``qx`` is the K-major shared-memory operand and ``qw`` is transposed into
  register fragments on its way from shared memory — no copy of the weights
  is made;
* ``"tile"`` — the other rows above :data:`M_DECODE` (an unaligned base, a
  K or N not a multiple of 16): ``psram_matmul_kernel``, 128 x 128 CTA
  tiles on ``mma.sync`` fed by a ``cp.async`` ring, each tile's K loop
  split over a thread-block cluster where the tiles alone would leave most
  SMs idle (:func:`_tile_split`), the int32 partials reduced through
  distributed shared memory in one launch;
* ``"decode"`` — ``M <= M_DECODE``: ``psram_matmul_decode_kernel``, a
  weight-streaming pass with the roles swapped and K split across the warps
  of a CTA and a thread-block cluster (its size chosen by the library,
  ``psram_matmul_decode_cluster``), reduced in int32 through distributed
  shared memory in one launch.

Integer sums are exact under any split, so every route is bit-equal to the
plain version.

``saturate`` (default True) is the ADC's rail clip. With ``saturate=False``
the code is left unclipped, ``round(acc / lsb)``, as the reference's ADC
leaves it (``src/repro/core/quantization.py:adc_transfer``): since ``|acc|
<= QMAX² · K``, the full scale, the code reaches at most ``±levels / 2``,
one past the clip, on a full-scale accumulation only. Every epilogue clamps
to ``±code_max``, a launch argument, so the launches take ``code_max =
+inf`` for it: ``fminf`` / ``fmaxf`` against infinities pass the code
through unchanged. No other kernel is needed.

K split across cards (a row-parallel projection on a model mesh): the ADC
is nonlinear, so partial sums cannot pass through it card by card.
:func:`psram_matmul_int32` is each route with its epilogue compiled out (a
template flag): the ``(M, N)`` int32 sums of one K slice, counted in
``psram_matmul_int32.launches`` / ``.routes``; the slices' sums are
all-reduced (exact integers, so in any order), and
:func:`psram_adc_epilogue` runs the ADC + dequant on them as a launch of
its own, with the LSB of the whole K (``psram_adc_epilogue.launches``),
writing f32 or, for a bf16 projection, bf16 directly. Decode rows (M <=
:data:`M_DECODE`) take :func:`psram_matmul_int32_rows` instead of the
quantization ops and the int32 decode route: one launch that reads the f32
or bf16 rows and their scales and forms the int8 codes in registers
(``psram_matmul_int32_rows.launches``). Each has a plain version on CPU
tensors; together they are bit-equal to :func:`psram_matmul` on the whole
K. The int32 sums need ``128²·K < 2³¹`` (K ≤ :data:`MAX_K`): the
CUDA wrapper raises above it, on every route. A route that fails to build or
to launch raises; nothing gives way to another route or to the plain
version. ``psram_matmul.launches`` counts every launch;
``psram_matmul.routes`` counts them by route.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core.quantization import QMAX, adc_transfer, exact_int_matmul, symmetric_scale

from . import _build

#: rows up to which the decode route is taken (timed crossover; PERF.md)
M_DECODE = 16
#: the largest K whose int32 sums are exact for any int8 codes: 128² · K < 2³¹
MAX_K = (2 ** 31 - 1) // (128 * 128)
#: the routes of kernel 2, as ``psram_matmul.routes`` counts them
ROUTES = ("wgmma", "tile", "decode")
#: the activation dtypes the K split's launches take: the rows
#: :func:`psram_matmul_int32_rows` quantizes, the output
#: :func:`psram_adc_epilogue` writes
ACT_DTYPES = (torch.float32, torch.bfloat16)


def _code_max(adc_bits: int, saturate: bool) -> float:
    """The largest code magnitude the epilogue keeps: the rails'
    ``levels / 2 - 1``, or ``+inf`` (no clip) with ``saturate=False``."""
    return float(2 ** adc_bits // 2 - 1) if saturate else float("inf")


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
    saturate: bool = True,
) -> torch.Tensor:
    """Plain PyTorch version of the kernel, exact on every device: the
    accumulator is formed in float64 (every partial sum of int8 products is
    an exact integer there), converted once to f32, then the shared ADC
    epilogue (clipped at the rails unless ``saturate`` is False)."""
    _check_operands(qx, qw, sx, sw)
    acc = exact_int_matmul(qx, qw)
    full_scale = float(QMAX) * float(QMAX) * qx.shape[-1]
    analog = adc_transfer(acc, 2 ** adc_bits, full_scale, saturate)
    return analog * (sx * sw)


#: output rows and columns of a tile-route CTA, and the most CTAs of its cluster
TILE = 128
MAX_TILE_SPLIT = 8
#: the fewest 64-deep k stages a CTA of a split tile walks
MIN_TILE_STAGES = 4


def _tile_split(m: int, k: int, n: int, sms: int) -> int:
    """CTAs of a cluster that share one tile's K loop on the tile route (1,
    2, 4 or 8): doubled while the doubled grid still has at most one CTA an
    SM and each CTA keeps at least :data:`MIN_TILE_STAGES` stages. So a grid
    of tiles that already fills the card (M = 8192 at the served
    projections) is not split, and 512 x 4096 x 1000 (32 tiles) is split 4
    ways on 132 SMs."""
    tiles = -(-m // TILE) * -(-n // TILE)
    stages = -(-k // 64)
    split = 1
    while (split < MAX_TILE_SPLIT and 2 * split * tiles <= sms
           and 2 * split * MIN_TILE_STAGES <= stages):
        split *= 2
    return split


def _decode_cluster(k: int, n: int, sms: int) -> int:
    """CTAs a cluster of the decode kernel has at ``K x N`` on ``sms`` SMs,
    as the built library chooses them."""
    fn = _build.load("psram_matmul").psram_matmul_decode_cluster
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_int] * 3
    return fn(k, n, sms)


def _rows_layout(k: int, n: int, sms: int) -> int:
    """The rows slice's layout word (:func:`rows_layout`) at ``K x N`` on
    ``sms`` SMs, as the built library chooses it."""
    fn = _build.load("psram_matmul").psram_matmul_rows_layout
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_int] * 3
    return fn(k, n, sms)


def _tma_takes(k: int, n: int, aligned: bool) -> bool:
    """Whether TMA can copy the operands: ``aligned`` (both bases on 16
    bytes) and row strides of ``k`` and ``n`` bytes that are multiples of 16
    (``k > 0``)."""
    return aligned and k > 0 and k % 16 == 0 and n % 16 == 0


def _aligned(*tensors: torch.Tensor) -> bool:
    """Whether every tensor's data starts on 16 bytes (TMA's base rule)."""
    return all(t.data_ptr() % 16 == 0 for t in tensors)


def _route(m: int, k: int, n: int, aligned: bool) -> str:
    """The route of an ``(m, k) @ (k, n)`` call: ``"decode"`` for
    ``m <= M_DECODE``; else ``"wgmma"`` where TMA can take the operands
    (:func:`_tma_takes`) and ``"tile"`` where it cannot."""
    if m <= M_DECODE:
        return "decode"
    return "wgmma" if _tma_takes(k, n, aligned) else "tile"


#: the launch entry of each route and of the split's two launches, and the
#: ctypes argument types of each
_ENTRIES = {"decode": "psram_matmul_decode_launch", "wgmma": "psram_matmul_wgmma_launch",
            "tile": "psram_matmul_launch", "epilogue": "psram_adc_epilogue_launch",
            "rows": "psram_matmul_rows_launch"}
_PTR, _INT, _F32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_ARGTYPES = {
    # qx, qw, sx, sw, out, M, K, N, lsb, code_max, [cluster / split,] raw, stream
    "decode": [_PTR] * 5 + [_INT] * 3 + [_F32] * 2 + [_INT, _INT, _PTR],
    "tile": [_PTR] * 5 + [_INT] * 3 + [_F32] * 2 + [_INT, _INT, _PTR],
    "wgmma": [_PTR] * 5 + [_INT] * 3 + [_F32] * 2 + [_INT, _PTR],
    # acc, sx, sw, out, M, N, lsb, code_max, bf16, stream
    "epilogue": [_PTR] * 4 + [_INT] * 2 + [_F32] * 2 + [_INT, _PTR],
    # x, sx, qw, out, M, K, N, bf16, layout, stream
    "rows": [_PTR] * 4 + [_INT] * 5 + [_PTR],
}
_BOUND: dict = {}


def _entry(route: str):
    """``(library, launch function)`` of ``route``, bound once a process."""
    got = _BOUND.get(route)
    if got is None:
        lib = _build.load("psram_matmul")
        fn = getattr(lib, _ENTRIES[route])
        fn.restype = ctypes.c_int
        fn.argtypes = _ARGTYPES[route]
        got = _BOUND[route] = (lib, fn)
    return got


def _call(fn, t: torch.Tensor, *args) -> int:
    """``fn(*args, stream)`` on ``t``'s card and its current stream (the raw
    handle), making the card current only where it is not already: a device
    switch and a ``Stream`` object cost host time on every launch."""
    idx = t.device.index
    if idx == torch.cuda.current_device():
        return fn(*args, torch._C._cuda_getCurrentRawStream(idx))
    with torch.cuda.device(idx):
        return fn(*args, torch._C._cuda_getCurrentRawStream(idx))


def _lsb(k: int, adc_bits: int) -> float:
    """The ADC's LSB at full scale ``QMAX² · k``: the plain version's, formed
    in double and rounded once to f32 by the launch."""
    return 2.0 * (float(QMAX) * float(QMAX) * k) / (2 ** adc_bits)


def psram_matmul_int32(qx: torch.Tensor, qw: torch.Tensor, route: str | None = None,
                       cluster: int = 0) -> torch.Tensor:
    """``qx @ qw`` as ``(M, N)`` int32 (one K slice's exact sums): kernel 2
    with its epilogue compiled out on CUDA tensors, on the route
    :func:`_route` names (``route`` / ``cluster`` force one, as in
    :func:`_launch`); on CPU tensors the plain integer product."""
    if qx.ndim != 2 or qw.ndim != 2 or qx.shape[1] != qw.shape[0]:
        raise ValueError(f"qx (M, K) and qw (K, N) differ: {tuple(qx.shape)} / {tuple(qw.shape)}")
    if not qx.is_cuda:
        if qx.dtype != torch.int8 or qw.dtype != torch.int8:
            raise TypeError(f"qx/qw must be int8, got {qx.dtype} / {qw.dtype}")
        return exact_int_matmul(qx, qw).to(torch.int32)
    m, n = qx.shape[0], qw.shape[1]
    unit_x = torch.empty((m, 1), dtype=torch.float32, device=qx.device)
    unit_w = torch.empty((1, n), dtype=torch.float32, device=qx.device)
    return _launch(qx, qw, unit_x, unit_w, route=route, cluster=cluster, raw=True)


def psram_adc_epilogue(acc: torch.Tensor, sx: torch.Tensor, sw: torch.Tensor, k: int,
                       adc_bits: int = 16, out_dtype: torch.dtype = torch.float32,
                       saturate: bool = True) -> torch.Tensor:
    """``ADC(acc) * (sx * sw)`` as ``(M, N)`` ``out_dtype`` (f32 or bf16)
    from int32 sums ``acc`` over a K of ``k`` (the full scale ``QMAX² ·
    k``): one launch of ``psram_adc_epilogue_kernel`` on CUDA tensors, the
    plain version's arithmetic on CPU tensors; bit-equal to
    :func:`psram_matmul`'s own epilogue, and in bf16 to that f32 result
    rounded once to bf16 (``.to(torch.bfloat16)``), which the kernel's
    store does. ``saturate=False`` leaves the codes unclipped."""
    if acc.ndim != 2 or acc.dtype != torch.int32:
        raise TypeError(f"acc must be a 2-D int32 tensor, got {acc.dtype} {tuple(acc.shape)}")
    m, n = acc.shape
    if tuple(sx.shape) != (m, 1) or tuple(sw.shape) != (1, n):
        raise ValueError(f"scales must be sx ({m}, 1) and sw (1, {n}); got "
                         f"{tuple(sx.shape)} / {tuple(sw.shape)}")
    if sx.dtype != torch.float32 or sw.dtype != torch.float32:
        raise TypeError(f"sx/sw must be float32, got {sx.dtype} / {sw.dtype}")
    if out_dtype not in ACT_DTYPES:
        raise TypeError(f"out_dtype must be one of {ACT_DTYPES}, got {out_dtype}")
    if not acc.is_cuda:
        full_scale = float(QMAX) * float(QMAX) * k
        return (adc_transfer(acc, 2 ** adc_bits, full_scale, saturate)
                * (sx * sw)).to(out_dtype)
    if not 1 <= adc_bits <= 24:
        raise ValueError(f"adc_bits must be in 1..24 for the kernel, got {adc_bits}")
    acc, sx, sw = acc.contiguous(), sx.contiguous(), sw.contiguous()
    out = torch.empty((m, n), dtype=out_dtype, device=acc.device)
    lib, fn = _entry("epilogue")
    err = _call(fn, acc, acc.data_ptr(), sx.data_ptr(), sw.data_ptr(), out.data_ptr(), m, n,
                _lsb(k, adc_bits), _code_max(adc_bits, saturate),
                int(out_dtype == torch.bfloat16))
    _build.check_launch(err, lib, "psram_adc_epilogue")
    psram_adc_epilogue.launches += 1
    return out


def psram_matmul_int32_rows_torch(x: torch.Tensor, sx: torch.Tensor,
                                  qw: torch.Tensor) -> torch.Tensor:
    """Plain version of :func:`psram_matmul_int32_rows`: the rows quantized
    by the ops of ``quantize_symmetric`` on the given scales, then
    :func:`psram_matmul_int32` on the codes (the parent's composition)."""
    qx = torch.round(x / sx).clamp(-QMAX, QMAX).to(torch.int8)
    return psram_matmul_int32(qx, qw)


def rows_layout(nb: int, warps: int, cluster: int) -> int:
    """The launch's layout word: ``nb`` 64-column blocks a warp (1 or 2),
    ``warps`` a CTA (4 or 8), ``cluster`` CTAs splitting K (1..8)."""
    if nb not in (1, 2) or warps not in (4, 8) or not 1 <= cluster <= MAX_TILE_SPLIT:
        raise ValueError(f"a rows layout takes nb 1 or 2, warps 4 or 8 and cluster "
                         f"1..{MAX_TILE_SPLIT}; got {nb} / {warps} / {cluster}")
    return (nb << 16) | (warps << 8) | cluster


def psram_matmul_int32_rows(x: torch.Tensor, sx: torch.Tensor, qw: torch.Tensor,
                            layout: int = 0) -> torch.Tensor:
    """One K slice's ``(M, N)`` int32 sums from the rows themselves:
    ``x`` ``(M <= M_DECODE, K)`` f32 or bf16, ``sx`` ``(M, 1)`` its rows'
    scales in ``x``'s dtype (``symmetric_scale`` of their whole-K maxima),
    ``qw`` ``(K, N)`` int8. Bit-equal to
    :func:`psram_matmul_int32_rows_torch`. On CUDA tensors one launch of
    ``psram_matmul_rows_kernel``, which forms the int8 codes in registers
    (no ``qx`` tensor, no quantization launches); ``layout``
    (:func:`rows_layout`) forces how the same sums are computed, 0 is the
    library's (``psram_matmul_rows_layout``). On CPU tensors the plain
    version."""
    if x.ndim != 2 or qw.ndim != 2 or x.shape[1] != qw.shape[0]:
        raise ValueError(f"x (M, K) and qw (K, N) differ: {tuple(x.shape)} / {tuple(qw.shape)}")
    m, k = x.shape
    n = qw.shape[1]
    if m > M_DECODE:
        raise ValueError(f"the rows slice takes up to {M_DECODE} rows, got {m}")
    if x.dtype not in ACT_DTYPES or sx.dtype != x.dtype or qw.dtype != torch.int8:
        raise TypeError(f"x must be one of {ACT_DTYPES}, sx x's dtype and qw int8; got "
                        f"{x.dtype} / {sx.dtype} / {qw.dtype}")
    if tuple(sx.shape) != (m, 1):
        raise ValueError(f"sx must be ({m}, 1), got {tuple(sx.shape)}")
    if len({x.device, sx.device, qw.device}) != 1:
        raise ValueError("x, sx, qw must live on one device")
    if not x.is_cuda:
        return psram_matmul_int32_rows_torch(x, sx, qw)
    if k > MAX_K:
        raise ValueError(f"K={k} exceeds {MAX_K}: the kernel's int32 sums would overflow")
    x, sx, qw = x.contiguous(), sx.contiguous(), qw.contiguous()
    out = torch.empty((m, n), dtype=torch.int32, device=x.device)
    lib, fn = _entry("rows")
    err = _call(fn, x, x.data_ptr(), sx.data_ptr(), qw.data_ptr(), out.data_ptr(), m, k, n,
                int(x.dtype == torch.bfloat16), layout)
    _build.check_launch(err, lib, "psram_matmul")
    psram_matmul_int32_rows.launches += 1
    return out


def _rows_division_probe() -> tuple[int, int, int]:
    """The bf16 rows' quotient in ``psram_matmul_rows_kernel`` (from the
    scale's reciprocal, ``hopper::psram_div``) against ``__fdiv_rn`` on the
    card, exhaustively: every finite bf16 value at every bf16 scale from
    the least ``symmetric_scale`` gives (``1e-12 / 127`` in bf16) to the
    largest finite, where ``|v| <= 256 s``; each pair's int8 code. Returns
    ``(pairs that differ, the least such (s bits << 16 | v bits), pairs
    checked)``."""
    s_lo = int(symmetric_scale(torch.zeros((1,), dtype=torch.bfloat16)).view(torch.int16)[0])
    s_hi = 0x7F7F                             # the largest finite bf16
    lib = _build.load("psram_matmul")
    fn = lib.psram_rows_division_probe_launch
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_uint, ctypes.c_uint, ctypes.c_void_p, ctypes.c_void_p]
    bad = torch.tensor([0, 2 ** 63 - 1, 0], dtype=torch.int64, device="cuda")
    err = _call(fn, bad, s_lo, s_hi - s_lo + 1, bad.data_ptr())
    _build.check_launch(err, lib, "psram_matmul")
    count, first, checked = bad.tolist()
    return count, first, checked


def psram_matmul(
    qx: torch.Tensor,   # (M, K) int8
    qw: torch.Tensor,   # (K, N) int8
    sx: torch.Tensor,   # (M, 1) f32
    sw: torch.Tensor,   # (1, N) f32
    adc_bits: int = 16,
    saturate: bool = True,
) -> torch.Tensor:
    """``ADC(qx @ qw) * (sx * sw)`` as ``(M, N)`` f32. Any ``M, K, N`` (the
    kernels mask ragged edges themselves). CUDA tensors go through one
    kernel launch on the current stream, without synchronizing, on the
    route :func:`_route` names. CPU tensors go through
    :func:`psram_matmul_torch`. ``saturate=False`` leaves the ADC's codes
    unclipped (see the module note)."""
    if not qx.is_cuda:
        return psram_matmul_torch(qx, qw, sx, sw, adc_bits=adc_bits, saturate=saturate)
    return _launch(qx, qw, sx, sw, adc_bits, saturate=saturate)


class _ScalesGrad(torch.autograd.Function):
    """Kernel 2 with the reference's training gradient: its forward is
    :func:`psram_matmul`, unchanged; its backward reaches only the scales,
    as ``jax.grad`` of ``ADC(qx @ qw) * (sx * sw)`` does (the int8 codes
    come from ``round`` and carry no gradient). With ``a`` the ADC code
    matrix and ``g`` the output's gradient, ``grad_sx = Σ_n g·a·sw`` and
    ``grad_sw = Σ_m g·a·sx``, formed as autograd forms them through the
    plain version (``g·a``, then each scale's product summed to its shape),
    so on one device the two give the same bits.

    ``a`` is recomputed by kernel 2 with unit scales (``a · (1 · 1)`` is
    ``a`` exactly), not saved: the recompute is one more launch at the
    forward's shape, where saving ``a`` would hold an f32 ``M x N`` tensor a
    projection from the forward to the backward (with a separate launch to
    form it, since the kernel's one output is the scaled product); the
    codes ``qx``, ``qw`` it needs are saved anyway (1 byte an element)."""

    @staticmethod
    def forward(ctx, qx, qw, sx, sw, adc_bits, saturate):
        ctx.save_for_backward(qx, qw, sx, sw)
        ctx.adc_bits, ctx.saturate = adc_bits, saturate
        return psram_matmul(qx, qw, sx, sw, adc_bits=adc_bits, saturate=saturate)

    @staticmethod
    def backward(ctx, g):
        qx, qw, sx, sw = ctx.saved_tensors
        need_sx, need_sw = ctx.needs_input_grad[2], ctx.needs_input_grad[3]
        if not (need_sx or need_sw):
            return None, None, None, None, None, None
        a = psram_matmul(qx, qw, torch.ones_like(sx), torch.ones_like(sw),
                         adc_bits=ctx.adc_bits, saturate=ctx.saturate)
        ga = g * a
        grad_sx = (ga * sw).sum(dim=1, keepdim=True) if need_sx else None
        grad_sw = (ga * sx).sum(dim=0, keepdim=True) if need_sw else None
        return None, None, grad_sx, grad_sw, None, None


def psram_matmul_trained(qx, qw, sx, sw, adc_bits: int = 16,
                         saturate: bool = True) -> torch.Tensor:
    """:func:`psram_matmul` for autograd: the same forward (the kernel on
    CUDA tensors, the plain version on the CPU), with the reference's
    scales-only gradient (:class:`_ScalesGrad`) through the same codes,
    unclipped where ``saturate`` is False; the int8 codes get none."""
    return _ScalesGrad.apply(qx, qw, sx, sw, adc_bits, saturate)


def _launch(qx, qw, sx, sw, adc_bits: int = 16, route: str | None = None,
            cluster: int = 0, raw: bool = False, saturate: bool = True) -> torch.Tensor:
    """One launch of kernel 2 on CUDA tensors. ``route`` None takes the
    route :func:`psram_matmul` takes; the checks name ``"wgmma"``,
    ``"tile"`` or ``"decode"`` to hold one route against another, and
    ``cluster`` a decode cluster size or the tile route's K split (1..8; 0
    is the library's decode cluster, or :func:`_tile_split`). Either only
    chooses how the same result is computed; a route that cannot take the
    operands raises. ``raw`` writes the int32 sums instead
    (:func:`psram_matmul_int32`); ``saturate=False`` launches the epilogue
    with no clip (``code_max = +inf``)."""
    if route not in (None, *ROUTES):
        raise ValueError(f"route must be one of {ROUTES}, got {route!r}")
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
    aligned = _aligned(qx, qw)
    if route is None:
        route = _route(m, k, n, aligned)
    if route == "decode" and m > 16:
        raise ValueError(f"the decode route takes up to 16 rows, got {m}")
    if route == "wgmma" and not _tma_takes(k, n, aligned):
        raise ValueError(f"the wgmma route needs 16-byte aligned operands and K, N multiples "
                         f"of 16; got K={k}, N={n}, aligned={aligned}")
    # exactly the plain version's LSB: formed in double, rounded once to f32
    lsb = _lsb(k, adc_bits)
    if not 0 <= cluster <= MAX_TILE_SPLIT:
        raise ValueError(f"cluster must be in 0..{MAX_TILE_SPLIT}, got {cluster}")
    if route == "tile" and cluster == 0:
        cluster = _tile_split(m, k, n, torch.cuda.get_device_properties(qx.device)
                              .multi_processor_count)
    extra = () if route == "wgmma" else (int(cluster),)
    out = torch.empty((m, n), dtype=torch.int32 if raw else torch.float32, device=qx.device)
    lib, fn = _entry(route)
    err = _call(fn, qx, qx.data_ptr(), qw.data_ptr(), sx.data_ptr(), sw.data_ptr(),
                out.data_ptr(), m, k, n, lsb, _code_max(adc_bits, saturate), *extra, int(raw))
    _build.check_launch(err, lib, "psram_matmul")
    counter = psram_matmul_int32 if raw else psram_matmul
    counter.launches += 1
    counter.routes[route] += 1
    return out


#: kernel launches made by :func:`psram_matmul` (CUDA path only), all routes
psram_matmul.launches = 0
#: the same launches by route
psram_matmul.routes = {route: 0 for route in ROUTES}
#: launches of the int32-out routes (the K split across cards), all routes and by route
psram_matmul_int32.launches = 0
psram_matmul_int32.routes = {route: 0 for route in ROUTES}
#: launches of the epilogue alone
psram_adc_epilogue.launches = 0
#: launches of the K slice that quantizes its own rows
psram_matmul_int32_rows.launches = 0
