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
* :func:`mttkrp_psram_strided` — the same function of the f32 tensor
  itself: it takes the permuted 3-mode view ``x`` (rows first) and reads
  the unfolding where it lies, drive-quantizing each tile as it stages it
  (the codes and scales of :func:`quantize_symmetric` on the unfolding), so
  neither the unfolding nor its codes are written to device memory. What
  the dense ``hopper`` call runs on the card.

The psram variant's ring kernel has three stagings, chosen from shape and
alignment alone. The strided entry's two read the f32 tensor in place:
``"rows"`` where the unfolding's rows are runs of ``B > 1`` values and
``"cols"`` where ``B == 1`` (mode 2: the rows are contiguous);
:func:`_unfold_layout` finds ``(A, Rw, B)`` or says TMA cannot take the
view. The codes entry's ``"ring"`` stages the int8 unfolding where its rows
are 16-byte aligned; ``"partials"`` (the kernel before the ring) takes the
codes TMA cannot. ``.routes`` on each entry counts them.

The TPU grid walks a row block's whole contraction in order, carrying the
accumulator in VMEM; on the card the contraction is split across CTAs into
``(splits, I, R)`` partials that a second pass adds in a fixed order (and, for
the psram variant, digitises per ``bi`` tile only then). Both variants
stream their operand through a TMA ring in shared memory where its rows are
16-byte aligned. Bound on the card: bytes for the exact kernel and the
strided entry (the tensor read once), f32 operations for the int8 codes.
Design notes are in the ``.cu`` file.

Each wrapper launches its kernel for CUDA tensors (or raises) and uses its
plain PyTorch version for CPU tensors — only because they lie on the CPU:

* :func:`mttkrp_fused_torch` — the TPU kernel's walk with ``bk = K``: one
  KR slab ``b[j] * c`` per ``j``, rounded to f32, then its product with the
  matching columns of ``x0``;
* :func:`mttkrp_psram_torch` — the twin of the reference's
  ``mttkrp_psram_xla``: one flat product, then the per-tile ADC;
* :func:`mttkrp_psram_strided_torch` — :func:`quantize_symmetric` on the
  unfolding, then :func:`mttkrp_psram_torch`.

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

from repro_torch.core.quantization import adc_transfer, quantize_symmetric, symmetric_scale

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


def mttkrp_psram_strided_torch(x, qb, sb, qc, sc, bi: int = 128,
                               adc_bits: int = 16) -> torch.Tensor:
    """Plain PyTorch version of :func:`mttkrp_psram_strided`: the unfolding
    of the view ``x`` (rows first) quantized by :func:`quantize_symmetric`,
    then :func:`mttkrp_psram_torch`."""
    qx, sx = quantize_symmetric(x.reshape(x.shape[0], -1), axis=-1)
    return mttkrp_psram_torch(qx, sx.to(torch.float32), qb, sb, qc, sc, bi=bi,
                              adc_bits=adc_bits)


# ------------------------------------------------------------- CUDA kernels

_TMA_STRIDE_MAX = 2 ** 40        # bytes a tensor map's stride may reach


def _unfold_layout(shape, strides, data_ptr: int, elem_bytes: int = 4):
    """``(A, Rw, B)`` where the view ``(shape, strides)`` (elements) is the
    unfolding of a contiguous 3-mode tensor that TMA can read in place: row
    ``r`` and contraction column ``(a, b)`` (``b`` fastest) at
    ``data_ptr + ((a * Rw + r) * B + b) * elem_bytes``. Mode 0 of ``(I, J,
    K)`` gives ``(1, I, J*K)``, mode 1 ``(I, J, K)``, mode 2 ``(I*J, K, 1)``.
    ``None`` for any other view (e.g. the permutation ``(0, 2, 1)``), an
    unaligned base, a row stride (``B > 1``) or column stride (``B == 1``)
    that is not whole 16 bytes, or a size a tensor map or the kernel's
    32-bit stage count cannot take. A pure function of shape, strides and
    address."""
    if len(shape) != 3 or len(strides) != 3:
        return None
    n0, n1, n2 = shape
    s0, s1, s2 = strides

    def has(n, stride, want):          # a dim of size 1 may carry any stride
        return n == 1 or stride == want

    if has(n2, s2, 1) and has(n1, s1, n2) and has(n0, s0, n1 * n2):
        a, rw, b = 1, n0, n1 * n2
    elif has(n2, s2, 1) and has(n0, s0, n2) and has(n1, s1, n0 * n2):
        a, rw, b = n1, n0, n2
    elif has(n0, s0, 1) and has(n2, s2, n0) and has(n1, s1, n0 * n2):
        a, rw, b = n1 * n2, n0, 1
    else:
        return None
    if min(a, rw, b) < 1 or data_ptr % 16 or ((b if b > 1 else rw) * elem_bytes) % 16:
        return None
    if a * b >= 2 ** 31 or rw >= 2 ** 31 or rw * b * elem_bytes >= _TMA_STRIDE_MAX:
        return None
    return a, rw, b


def _layout_of(x):
    """:func:`_unfold_layout` of an f32 tensor ``x`` (``None`` otherwise)."""
    if x.ndim != 3 or x.dtype != torch.float32:
        return None
    return _unfold_layout(tuple(x.shape), x.stride(), x.data_ptr())


def _n_stages(a: int, b: int, front: str) -> int:
    """32-column stages of the ring's walk: a stage never straddles ``a``
    where ``"rows"`` stage the view; otherwise the columns run on."""
    return a * -(-b // TK) if front == "rows" else -(-(a * b) // TK)


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
    """``(rows of a CTA tile, CTAs a SM)`` of the TMA rings (the exact
    kernel's and the psram ring's), as the built library states them."""
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


#: the codes entry's routes (:func:`_codes_route`) and the strided entry's
#: stagings (:func:`_unfold_layout`), as ``.routes`` counts them
CODES_ROUTES = ("ring", "partials")
STRIDED_ROUTES = ("rows", "cols")
_FRONTS = {"rows": 0, "cols": 1, "codes": 2}


def _codes_route(jk: int, data_ptr: int) -> str:
    """The codes entry's route from shape and alignment alone: ``"ring"``
    where every row of the int8 unfolding starts on a 16-byte boundary (and
    the walk's stage count fits 32 bits), else ``"partials"``."""
    return "ring" if jk % 16 == 0 and data_ptr % 16 == 0 and jk < 2 ** 31 else "partials"


def _ring(front: str, x, sx, qb, sb, qc, sc, a: int, rw: int, b: int, bi: int,
          adc_bits: int) -> torch.Tensor:
    """One launch of the psram ring (pass 1 and the ADC pass) on the card:
    ``x`` the f32 ``(A, Rw, B)`` view read in place (``"rows"``,
    ``"cols"``) or the int8 unfolding ``(Rw, B)`` (``"codes"``, ``a ==
    1``), ``sx`` its row scales; the split plan is the stages'."""
    r = qb.shape[1]
    splits, per = split_plan(_sms(x.device), rw, _n_stages(a, b, front) * TK, r,
                             *_ring_shape())
    levels = 2 ** adc_bits
    with torch.cuda.device(x.device):
        partials = torch.empty((splits, rw, r), dtype=torch.float32, device=x.device)
        out = torch.empty((rw, r), dtype=torch.float32, device=x.device)
        lib, fn = _entry("mttkrp_psram_ring_launch", 8,
                         [ctypes.c_int, ctypes.c_longlong, ctypes.c_int, ctypes.c_longlong]
                         + [ctypes.c_int] * 5 + [ctypes.c_float] * 2)
        err = fn(x.data_ptr(), sx.data_ptr(), qb.data_ptr(), sb.data_ptr(), qc.data_ptr(),
                 sc.data_ptr(), partials.data_ptr(), out.data_ptr(), _FRONTS[front],
                 a, rw, b, qc.shape[0], r, splits, per, bi, float(levels),
                 float(levels // 2 - 1), torch.cuda.current_stream().cuda_stream)
    _build.check_launch(err, lib, "mttkrp")
    return out


def _launch_codes(qx0, sx, qb, sb, qc, sc, bi: int, adc_bits: int,
                  route: str | None = None) -> torch.Tensor:
    """The codes entry on the card, on ``route`` (default: the one
    :func:`_codes_route` names; a forced ``"ring"`` the codes cannot take
    raises)."""
    i, jk = qx0.shape
    r = qb.shape[1]
    own = _codes_route(jk, qx0.data_ptr())
    route = route or own
    if route not in CODES_ROUTES:
        raise ValueError(f"unknown route {route!r}; have {CODES_ROUTES}")
    if route == "ring" and own != "ring":
        raise ValueError("the ring route needs 16-byte aligned rows of codes "
                         f"(J*K % 16 == 0 and an aligned base); got J*K = {jk}")
    if route == "ring":
        out = _ring("codes", qx0, sx, qb, sb, qc, sc, 1, i, jk, bi, adc_bits)
    else:
        splits, per = split_plan(_sms(qx0.device), i, jk, r)
        vec = int(jk % 16 == 0 and qx0.data_ptr() % 16 == 0)
        levels = 2 ** adc_bits
        with torch.cuda.device(qx0.device):
            partials = torch.empty((splits, i, r), dtype=torch.float32, device=qx0.device)
            out = torch.empty((i, r), dtype=torch.float32, device=qx0.device)
            lib, fn = _entry("mttkrp_psram_launch", 8,
                             [ctypes.c_int] * 8 + [ctypes.c_float] * 2)
            err = fn(qx0.data_ptr(), sx.data_ptr(), qb.data_ptr(), sb.data_ptr(),
                     qc.data_ptr(), sc.data_ptr(), partials.data_ptr(), out.data_ptr(),
                     i, jk // qc.shape[0], qc.shape[0], r, splits, per, vec, bi,
                     float(levels), float(levels // 2 - 1),
                     torch.cuda.current_stream().cuda_stream)
        _build.check_launch(err, lib, "mttkrp")
    mttkrp_psram_fused.launches += 1
    mttkrp_psram_fused.routes[route] += 1
    return out


def mttkrp_psram_fused(qx0, sx, qb, sb, qc, sc, bi: int = 128, bk: int = 128,
                       adc_bits: int = 16) -> torch.Tensor:
    """Dense mode-0 MTTKRP through the array numerics: int8 operands, KR
    tiles from quantized factor rows, f32 accumulation, ADC over each
    ``bi``-row output tile's observed range. ``(I, R)`` f32. CUDA tensors go
    through the kernel on the current stream, without synchronizing (the
    ring where the codes' rows are 16-byte aligned, else the partials
    kernel); CPU tensors through :func:`mttkrp_psram_torch`."""
    i, j, k, r = _check_psram(qx0, sx, qb, sb, qc, sc)
    bi_eff, _ = _tiles(i, k, bi, bk)
    if not qx0.is_cuda:
        return mttkrp_psram_torch(qx0, sx, qb, sb, qc, sc, bi=bi, adc_bits=adc_bits)
    _check_adc_bits(adc_bits)
    _require_contiguous(qx0=qx0, sx=sx, qb=qb, sb=sb, qc=qc, sc=sc)
    return _launch_codes(qx0, sx, qb, sb, qc, sc, bi_eff, adc_bits)


#: kernel launches made by :func:`mttkrp_psram_fused` (CUDA path only)
mttkrp_psram_fused.launches = 0
#: the same launches by route
mttkrp_psram_fused.routes = {route: 0 for route in CODES_ROUTES}


def _check_adc_bits(adc_bits: int):
    if not 1 <= adc_bits <= 24:
        raise ValueError(f"adc_bits must be in 1..24 for the kernel, got {adc_bits}")


def _check_strided(x, qb, sb, qc, sc):
    if x.ndim != 3:
        raise ValueError(f"x must be a 3-mode view (Rw, J, K), got {tuple(x.shape)}")
    if x.dtype != torch.float32:
        raise TypeError(f"x must be float32, got {x.dtype}")
    i, j, k = x.shape
    if qb.ndim != 2 or qc.ndim != 2 or qb.shape[0] != j or qc.shape[0] != k \
            or qb.shape[1] != qc.shape[1]:
        raise ValueError(f"x {tuple(x.shape)} is not a view against qb {tuple(qb.shape)} "
                         f"and qc {tuple(qc.shape)}")
    if tuple(sb.shape) != (j, 1) or tuple(sc.shape) != (k, 1):
        raise ValueError(f"scales must be sb (J,1), sc (K,1); got {tuple(sb.shape)}, "
                         f"{tuple(sc.shape)}")
    for name, t, dt in (("qb", qb, torch.int8), ("qc", qc, torch.int8),
                        ("sb", sb, torch.float32), ("sc", sc, torch.float32)):
        if t.dtype != dt:
            raise TypeError(f"{name} must be {dt}, got {t.dtype}")
    if len({t.device for t in (x, qb, sb, qc, sc)}) != 1:
        raise ValueError("x, qb, sb, qc, sc must live on one device")
    return i, j, k, qb.shape[1]


def _require_layout(x):
    layout = _layout_of(x)
    if layout is None:
        raise ValueError(
            f"x (shape {tuple(x.shape)}, strides {x.stride()}) is not an unfolding of a "
            "contiguous 3-mode tensor that TMA can read in place (16-byte aligned base "
            "and rows); quantize its unfolding and use mttkrp_psram_fused")
    return layout


def drive_scales(x) -> torch.Tensor:
    """The row scales ``(Rw, 1)`` f32 of the view ``x`` (rows first) that
    :func:`quantize_symmetric` gives its unfolding, bit for bit: on the card
    one pass over the tensor in memory order for each row's ``max|x|``
    (``mttkrp_rowmax_launch``), on the CPU its plain twin
    ``x.abs().amax(...)``; then :func:`symmetric_scale`."""
    rw = x.shape[0]
    if not x.is_cuda:
        return symmetric_scale(x.abs().amax(dim=(1, 2)).reshape(rw, 1))
    a, rw, b = _require_layout(x)
    with torch.cuda.device(x.device):
        amax = torch.empty(rw, dtype=torch.int32, device=x.device)   # f32 bit patterns
        lib, fn = _entry("mttkrp_rowmax_launch", 2,
                         [ctypes.c_longlong, ctypes.c_int, ctypes.c_longlong, ctypes.c_int])
        err = fn(x.data_ptr(), amax.data_ptr(), a, rw, b, _sms(x.device),
                 torch.cuda.current_stream().cuda_stream)
    _build.check_launch(err, lib, "mttkrp")
    drive_scales.launches += 1
    return symmetric_scale(amax.view(torch.float32).view(rw, 1))


#: row-max passes launched by :func:`drive_scales` (CUDA path only)
drive_scales.launches = 0


def drive_codes(x, sx) -> torch.Tensor:
    """The checks' entry: the int8 codes ``(Rw, A*B)`` of the unfolding of
    the view ``x`` against the row scales ``sx`` as the ring's f32 front
    ends compute them (the same device function), written out; on the CPU
    ``round(x / sx)`` clamped, as :func:`quantize_symmetric` computes them.
    Used by the tests and ``chip_smoke.py``, never on the main path."""
    rw = x.shape[0]
    if tuple(sx.shape) != (rw, 1) or sx.dtype != torch.float32 or sx.device != x.device:
        raise ValueError(f"sx must be float32 (Rw, 1) = ({rw}, 1) on {x.device}; got "
                         f"{sx.dtype} {tuple(sx.shape)} on {sx.device}")
    if not x.is_cuda:
        return torch.round(x.reshape(rw, -1) / sx).clamp(-127, 127).to(torch.int8)
    a, rw, b = _require_layout(x)
    _require_contiguous(sx=sx)
    with torch.cuda.device(x.device):
        codes = torch.empty((rw, a * b), dtype=torch.int8, device=x.device)
        lib, fn = _entry("mttkrp_drive_codes_launch", 3,
                         [ctypes.c_longlong, ctypes.c_int, ctypes.c_longlong])
        err = fn(x.data_ptr(), sx.data_ptr(), codes.data_ptr(), a, rw, b,
                 torch.cuda.current_stream().cuda_stream)
    _build.check_launch(err, lib, "mttkrp")
    return codes


def mttkrp_psram_strided(x, qb, sb, qc, sc, bi: int = 128, bk: int = 128,
                         adc_bits: int = 16) -> torch.Tensor:
    """:func:`mttkrp_psram_fused` of the f32 tensor itself: ``x`` is the
    permuted view ``(Rw, J, K)`` of a contiguous 3-mode tensor whose
    unfolding ``x.reshape(Rw, J*K)`` is the driven operand; ``qb, sb, qc,
    sc`` the stored factors. On the card: the row scales
    (:func:`drive_scales`), then the ring reading ``x`` in place and
    drive-quantizing each tile as it stages it (the codes and scales of
    :func:`quantize_symmetric`), the splits and the ADC pass; ``(Rw, R)``
    f32 on the current stream, without synchronizing. A view TMA cannot take
    raises ``ValueError``. CPU tensors go through
    :func:`mttkrp_psram_strided_torch`."""
    rw, j, k, r = _check_strided(x, qb, sb, qc, sc)
    bi_eff, _ = _tiles(rw, k, bi, bk)
    if not x.is_cuda:
        return mttkrp_psram_strided_torch(x, qb, sb, qc, sc, bi=bi, adc_bits=adc_bits)
    _check_adc_bits(adc_bits)
    _require_contiguous(qb=qb, sb=sb, qc=qc, sc=sc)
    a, rw, b = _require_layout(x)
    front = "cols" if b == 1 else "rows"
    out = _ring(front, x, drive_scales(x), qb, sb, qc, sc, a, rw, b, bi_eff, adc_bits)
    mttkrp_psram_strided.launches += 1
    mttkrp_psram_strided.routes[front] += 1
    return out


#: calls of :func:`mttkrp_psram_strided` that launched the ring (CUDA only)
mttkrp_psram_strided.launches = 0
#: the same by staging
mttkrp_psram_strided.routes = {route: 0 for route in STRIDED_ROUTES}
