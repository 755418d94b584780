"""Dense mode-0 MTTKRP with the Khatri-Rao product formed on the fly — exact
and through the pSRAM array's numerics.

    A = X_(0) @ (B ⊙ C),    (B ⊙ C)[j*K + k, r] = B[j, r] * C[k, r]

``x0`` is the mode-0 unfolding ``(I, J*K)``, row-major over ``(j, k)``.
Materialising ``B ⊙ C`` costs ``J*K*R`` floats; the kernels form each KR tile
from a row of ``B`` and a tile of ``C`` where it is used and read ``X_(0)``
once.

The hand-written Hopper kernels live in ``csrc/mttkrp.cu`` (CUDA C++,
``sm_90a``); they replace the TPU kernels of ``src/repro/kernels/mttkrp.py``:

* :func:`mttkrp_fused` (TPU: ``mttkrp_fused`` / ``_kernel``) — exact f32.
* :func:`mttkrp_psram_fused` (TPU: ``mttkrp_psram_fused`` /
  ``_psram_kernel``) — int8 operands with per-row scales, f32 accumulation,
  then the ADC transfer of every ``bi``-row output tile over that tile's own
  ``max|acc|``: ``bi`` is numerics, not a tiling knob.

The TPU grid walks a row block's whole contraction in order, carrying the
accumulator in VMEM; on the card the contraction is split across CTAs into
``(splits, I, R)`` partials that a second pass adds in a fixed order (and, for
the psram variant, digitises per ``bi`` tile only then). The exact kernel
streams ``X_(0)`` through a TMA ring in shared memory where its rows are
16-byte aligned. Bound on the card: bytes for the exact kernel (``X_(0)``
read once), f32 operations for the int8 one. Design notes are in the ``.cu``
file.

Each wrapper launches its kernel for CUDA tensors (or raises) and uses its
plain PyTorch version for CPU tensors — only because they lie on the CPU:

* :func:`mttkrp_fused_torch` — the TPU kernel's walk with ``bk = K``: one
  KR slab ``b[j] * c`` per ``j``, rounded to f32, then its product with the
  matching columns of ``x0``;
* :func:`mttkrp_psram_torch` — the twin of the reference's
  ``mttkrp_psram_xla``: one flat product, then the per-tile ADC.

Float adds are reassociated between the kernels and their plain versions, so
they agree within f32 rounding (exact), not bit for bit. The psram pair
agrees within **1.043 ADC codes** of the tile's full scale, as measured on the
card (NVIDIA H100, ``chip_smoke.py``: 2,255 of 127,552 elements a code
apart): the kernel's tile maximum, summed in another order, differs from the
plain version's by up to ~2e-6 relative, which moves every code's LSB by
that much (0.043 of a code at codes near 2^15), and an element at a rounding
boundary lands one code over. Checks allow two codes plus rtol 2e-4, the
reference's own tolerance for its kernel against its XLA twin.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core.quantization import adc_transfer, quantize_symmetric

from . import _build

TK = 32          # contraction columns per stage of csrc/mttkrp.cu
TI, TR = 128, 32  # rows and rank columns of one CTA's tile


def quantize_mttkrp_operands(x0, b, c):
    """Per-row int8 quantization of the unfolding and both factors — the
    operand treatment both lowerings of the psram variant share:
    ``(qx0, sx, qb, sb, qc, sc)`` with f32 ``(n, 1)`` scales."""
    qx, sx = quantize_symmetric(x0, axis=-1)
    qb, sb = quantize_symmetric(b, axis=-1)
    qc, sc = quantize_symmetric(c, axis=-1)
    return (qx, sx.to(torch.float32), qb, sb.to(torch.float32),
            qc, sc.to(torch.float32))


def _tiles(i, k, bi, bk):
    """The reference's preconditions: ``bi = min(bi, I)``, ``bk = min(bk, K)``,
    ``I % bi == 0``, ``K % bk == 0``."""
    bi, bk = min(bi, i), min(bk, k)
    if bi < 1 or bk < 1 or i % bi or k % bk:
        raise ValueError(
            f"need I % bi == 0 and K % bk == 0 (bi = min(bi, I), bk = min(bk, K)); "
            f"got I={i}, K={k}, bi={bi}, bk={bk}")
    return bi, bk


def _check_dims(x0, b, c):
    if x0.ndim != 2 or b.ndim != 2 or c.ndim != 2:
        raise ValueError(f"x0, b, c must be 2-D; got {x0.ndim}, {b.ndim}, {c.ndim}")
    i, jk = x0.shape
    j, r = b.shape
    k = c.shape[0]
    if jk != j * k or c.shape[1] != r:
        raise ValueError(f"x0 {tuple(x0.shape)} is not the unfolding against "
                         f"b {tuple(b.shape)} and c {tuple(c.shape)}")
    return i, j, k, r


def _check_exact(x0, b, c, bi, bk):
    i, j, k, r = _check_dims(x0, b, c)
    for name, t in (("x0", x0), ("b", b), ("c", c)):
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
    if len({t.device for t in (x0, b, c)}) != 1:
        raise ValueError("x0, b, c must live on one device")
    _tiles(i, k, bi, bk)
    return i, j, k, r


def _check_psram(qx0, sx, qb, sb, qc, sc):
    i, j, k, r = _check_dims(qx0, qb, qc)
    if tuple(sx.shape) != (i, 1) or tuple(sb.shape) != (j, 1) or tuple(sc.shape) != (k, 1):
        raise ValueError(f"scales must be sx (I,1), sb (J,1), sc (K,1); got "
                         f"{tuple(sx.shape)}, {tuple(sb.shape)}, {tuple(sc.shape)}")
    for name, t, dt in (("qx0", qx0, torch.int8), ("qb", qb, torch.int8),
                        ("qc", qc, torch.int8), ("sx", sx, torch.float32),
                        ("sb", sb, torch.float32), ("sc", sc, torch.float32)):
        if t.dtype != dt:
            raise TypeError(f"{name} must be {dt}, got {t.dtype}")
    if len({t.device for t in (qx0, sx, qb, sb, qc, sc)}) != 1:
        raise ValueError("qx0, sx, qb, sb, qc, sc must live on one device")
    return i, j, k, r


# ------------------------------------------------------------ plain versions


def mttkrp_fused_torch(x0, b, c, bi: int = 128, bk: int = 128) -> torch.Tensor:
    """Plain PyTorch version of :func:`mttkrp_fused`: for each ``j`` the KR
    slab ``b[j] * c`` (``(K, R)``, rounded to f32) times the ``K`` columns of
    ``x0`` that belong to ``j``, added in ``j`` order."""
    i, j, k, r = _check_exact(x0, b, c, bi, bk)
    acc = torch.zeros((i, r), dtype=torch.float32, device=x0.device)
    for jj in range(j):
        acc.addmm_(x0[:, jj * k:(jj + 1) * k], b[jj] * c)
    return acc


def mttkrp_psram_torch(qx0, sx, qb, sb, qc, sc, bi: int = 128,
                       adc_bits: int = 16) -> torch.Tensor:
    """Plain PyTorch version of :func:`mttkrp_psram_fused` (the reference's
    ``mttkrp_psram_xla``): ``kr = (qb·qc)·(sb·sc)`` and ``x = qx0·sx`` in
    f32, one flat product, then the per-``bi``-tile ADC."""
    i, j, k, r = _check_psram(qx0, sx, qb, sb, qc, sc)
    bi = min(bi, i)
    if i % bi:
        raise ValueError(f"need I % bi == 0 (bi = min(bi, I)); got I={i}, bi={bi}")
    kr = (qb.to(torch.float32)[:, None, :] * qc.to(torch.float32)[None]
          ) * (sb[:, None, :] * sc[None])                  # (J, K, R)
    out = (qx0.to(torch.float32) * sx) @ kr.reshape(j * k, r)
    tiles = out.reshape(i // bi, bi, r)       # each tile over its own max|acc|
    full_scale = tiles.abs().amax(dim=(1, 2), keepdim=True).clamp_min(1e-30)
    return adc_transfer(tiles, 2 ** adc_bits, full_scale).reshape(i, r)


# ------------------------------------------------------------- CUDA kernels


def _entry(name: str, n_ptrs: int, tail):
    lib = _build.load("mttkrp")
    fn = getattr(lib, name)
    if not fn.argtypes:
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * n_ptrs + tail + [ctypes.c_void_p]
    return lib, fn


def split_plan(sms: int, i: int, jk: int, r: int, ti: int = TI,
               ctas_per_sm: int = 8) -> tuple[int, int]:
    """``(splits, stages per split)`` of the contraction on a card with
    ``sms`` SMs and CTA tiles of ``ti`` rows: about ``ctas_per_sm`` CTAs per
    SM and no more, every split non-empty. Depends on the SM count and the
    shapes only, so a launch is deterministic on one kind of card."""
    n_chunks = -(-jk // TK)
    ctas = -(-i // ti) * -(-r // TR)
    want = max(1, min(n_chunks, 65535, ctas_per_sm * sms // ctas))
    per = -(-n_chunks // want)
    return -(-n_chunks // per), per


def _ring_shape() -> tuple[int, int]:
    """``(rows of a CTA tile, CTAs a SM)`` of the exact kernel's TMA ring, as
    the built library states them."""
    lib = _build.load("mttkrp")
    rows, per_sm = ctypes.c_int(), ctypes.c_int()
    lib.mttkrp_ring_shape(ctypes.byref(rows), ctypes.byref(per_sm))
    return rows.value, per_sm.value


def _sms(device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def _require_contiguous(**tensors):
    for name, t in tensors.items():
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def mttkrp_fused(x0, b, c, bi: int = 128, bk: int = 128) -> torch.Tensor:
    """Exact dense mode-0 MTTKRP ``x0 @ (b ⊙ c)`` as ``(I, R)`` f32. CUDA
    tensors go through the kernel on the current stream, without
    synchronizing; CPU tensors through :func:`mttkrp_fused_torch`.
    ``bi``/``bk`` only carry the reference's preconditions: the kernel's own
    tiling is fixed and any ``I, J, K, R`` would do."""
    i, j, k, r = _check_exact(x0, b, c, bi, bk)
    if not x0.is_cuda:
        return mttkrp_fused_torch(x0, b, c, bi=bi, bk=bk)
    _require_contiguous(x0=x0, b=b, c=c)
    # 16-byte aligned rows go through the TMA ring, one wave of CTAs
    vec = int((j * k) % 4 == 0 and j * k < 2 ** 31 and x0.data_ptr() % 16 == 0)
    splits, per = (split_plan(_sms(x0.device), i, j * k, r, *_ring_shape()) if vec
                   else split_plan(_sms(x0.device), i, j * k, r))
    with torch.cuda.device(x0.device):
        partials = torch.empty((splits, i, r), dtype=torch.float32, device=x0.device)
        out = torch.empty((i, r), dtype=torch.float32, device=x0.device)
        lib, fn = _entry("mttkrp_fused_launch", 5, [ctypes.c_int] * 7)
        err = fn(x0.data_ptr(), b.data_ptr(), c.data_ptr(), partials.data_ptr(),
                 out.data_ptr(), i, j, k, r, splits, per, vec,
                 torch.cuda.current_stream().cuda_stream)
    _build.check_launch(err, lib, "mttkrp")
    mttkrp_fused.launches += 1
    return out


#: kernel launches made by :func:`mttkrp_fused` (CUDA path only)
mttkrp_fused.launches = 0


def mttkrp_psram_fused(qx0, sx, qb, sb, qc, sc, bi: int = 128, bk: int = 128,
                       adc_bits: int = 16) -> torch.Tensor:
    """Dense mode-0 MTTKRP through the array numerics: int8 operands, KR
    tiles from quantized factor rows, f32 accumulation, ADC over each
    ``bi``-row output tile's observed range. ``(I, R)`` f32. CUDA tensors go
    through the kernel on the current stream, without synchronizing; CPU
    tensors through :func:`mttkrp_psram_torch`."""
    i, j, k, r = _check_psram(qx0, sx, qb, sb, qc, sc)
    bi_eff, _ = _tiles(i, k, bi, bk)
    if not qx0.is_cuda:
        return mttkrp_psram_torch(qx0, sx, qb, sb, qc, sc, bi=bi, adc_bits=adc_bits)
    if not 1 <= adc_bits <= 24:
        raise ValueError(f"adc_bits must be in 1..24 for the kernel, got {adc_bits}")
    _require_contiguous(qx0=qx0, sx=sx, qb=qb, sb=sb, qc=qc, sc=sc)
    splits, per = split_plan(_sms(qx0.device), i, j * k, r)
    vec = int((j * k) % 16 == 0 and qx0.data_ptr() % 16 == 0)
    levels = 2 ** adc_bits
    with torch.cuda.device(qx0.device):
        partials = torch.empty((splits, i, r), dtype=torch.float32, device=qx0.device)
        out = torch.empty((i, r), dtype=torch.float32, device=qx0.device)
        lib, fn = _entry("mttkrp_psram_launch", 8,
                         [ctypes.c_int] * 8 + [ctypes.c_float] * 2)
        err = fn(qx0.data_ptr(), sx.data_ptr(), qb.data_ptr(), sb.data_ptr(),
                 qc.data_ptr(), sc.data_ptr(), partials.data_ptr(), out.data_ptr(),
                 i, j, k, r, splits, per, vec, bi_eff, float(levels),
                 float(levels // 2 - 1), torch.cuda.current_stream().cuda_stream)
    _build.check_launch(err, lib, "mttkrp")
    mttkrp_psram_fused.launches += 1
    return out


#: kernel launches made by :func:`mttkrp_psram_fused` (CUDA path only)
mttkrp_psram_fused.launches = 0
