"""Fused streaming sparse MTTKRP: one function, three lowerings.

Per execution chunk of ``E`` blocks × ``rows`` nonzeros of the sorted stream
the function is (reference: ``src/repro/kernels/stream_mttkrp.py``,
``_chunk_partials`` + the scatter of ``_stream_kernel``):

1. **int8 factor-row gathers**: the non-target factors are pre-quantized per
   row (``quantize_symmetric(f, axis=-1)``), so each nonzero gathers ``R``
   int8 per factor.
2. **exact integer Hadamard**: two-factor chains multiply in int16
   (``127² < 2¹⁵``), longer ones in f32 (exact below 2²⁴); the combined
   scale ``value · Π_d s_d[idx_d]`` is formed in f32, mode-ascending,
   starting from the value.
3. **per-segment sums** of ``scale · float(hadamard)`` inside every block.
4. **ADC transfer** of the partials over the *chunk-wide* ``max|partial|``
   (so the chunking — ``exec_blocks`` — is numerics, and the port cuts the
   same chunks as the reference).
5. **accumulation** of the digitized partials into their output rows.

Lowerings (``backends.lowering``):

* ``"cuda"``  — :func:`stream_mttkrp_fused`, the wrapper of the hand-written
  Hopper kernel ``csrc/stream_mttkrp.cu`` (replaces the TPU kernel
  ``_stream_kernel``). It reads the stream once, gathers factor rows from
  L2, keeps only the compact per-segment partials in device memory, and
  adds them per output row in stream order — deterministic, no atomics on
  the output. Two routes, one contract, chosen by :func:`_route` from shapes
  and alignment alone: ``"chunk"`` (one CTA per chunk: ``cp.async`` row
  gathers, the partials and the chunk-wide ADC in shared memory) where the
  rank is 16, 32, 64 or 128, the codes are 16-byte aligned and the chunk
  fits shared memory, else ``"three_pass"`` (partials, digitize, fold).
  ``stream_mttkrp_fused.routes`` counts them. Design notes are in the
  ``.cu`` file.
* ``"torch"`` — :func:`stream_mttkrp_fused_torch`, the plain PyTorch
  version (``index_add_`` segment sums). What the wrapper uses for CPU
  tensors, and what the CPU tests hold against the reference package.
* ``"ref"``   — ``kernels.ref.stream_mttkrp_fused_ref``, the literal one-hot
  gather-mask contraction.

All three sum a segment's f32 contributions in their own order (the kernel
and the CPU plain version in stream order; ``index_add_`` on a CUDA device
and the mask contraction in no fixed order), so they agree within float
reassociation *before* the ADC and therefore within one ADC code of the
chunk's full scale after it.
"""
from __future__ import annotations

import ctypes
import dataclasses
import weakref

import numpy as np
import torch

from repro_torch.core.quantization import adc_transfer, quantize_symmetric

from . import _build, ref

MAX_MODES = 8   # MAX_MODES of csrc/stream_mttkrp.cu
#: the routes of kernel 1, as ``stream_mttkrp_fused.routes`` counts them
ROUTES = ("chunk", "three_pass")
_ROUTE_IDS = {"three_pass": 0, "chunk": 1}   # enum Route of the .cu
CHUNK_RANKS = (16, 32, 64, 128)   # the ranks csrc/stream_mttkrp.cu's chunk kernel is built for
LONG_RUN = 256         # the row fold gives a run of more segments a CTA of its own
MAX_SMEM = 232_448     # opt-in dynamic shared memory of one CTA on sm_90 (227 KB)


def quantize_stream_factors(factors, mode: int):
    """Per-row int8 quantization of the non-target factors.

    Returns ``(qs, ss)`` tuples ordered like ``factors`` with the target
    mode's slots holding size-(1,1) placeholders (never gathered — the
    chain skips ``mode``); ``ss[d]`` is ``(I_d, 1)`` f32.
    """
    qs, ss = [], []
    for d, f in enumerate(factors):
        if d == mode:
            qs.append(torch.zeros((1, 1), dtype=torch.int8, device=f.device))
            ss.append(torch.zeros((1, 1), dtype=torch.float32, device=f.device))
        else:
            q, s = quantize_symmetric(f, axis=-1)
            qs.append(q)
            ss.append(s.to(torch.float32))
    return tuple(qs), tuple(ss)


_FACTOR_QUANT_CACHE: dict = {}
_FACTOR_QUANT_CACHE_MAX = 32


def stream_factor_quants(factors, mode: int):
    """Store-side quantization cache: the array *stores* the quantized
    factors once (the store-then-drive split of §III/§IV), so the per-row
    int8 conversion is keyed on factor identity and paid once per factor
    set, not once per drive. Weakref-guarded against id reuse. Identity
    keying means a factor must never be updated in place — an ALS sweep
    builds a new tensor per update, which naturally misses and re-stores."""
    key = (mode,) + tuple(id(f) for f in factors)
    hit = _FACTOR_QUANT_CACHE.get(key)
    if hit is not None and all(r() is f for r, f in zip(hit[0], factors)):
        return hit[1]
    val = quantize_stream_factors(tuple(factors), mode)
    if len(_FACTOR_QUANT_CACHE) >= _FACTOR_QUANT_CACHE_MAX:
        _FACTOR_QUANT_CACHE.clear()
    _FACTOR_QUANT_CACHE[key] = (
        tuple(weakref.ref(f) for f in factors), val)
    return val


def clear_factor_quant_cache() -> None:
    """Forget every stored factor set's cached quantization."""
    _FACTOR_QUANT_CACHE.clear()


# ------------------------------------------------------------ plain version


def stream_mttkrp_fused_torch(ip, vp, lp, sp, qs, ss, mode, n_seg, adc_bits,
                              out_rows, return_chunk_max: bool = False):
    """Plain PyTorch version of the fused kernel, all chunks at once.

    The per-segment sums are an ``index_add_`` of the per-nonzero
    contributions into the ``(nb·E·n_seg, R)`` stack padded to the widest
    block (fine as a yardstick; the kernel keeps a compact scratch). With
    ``return_chunk_max`` also returns the ``(nb,)`` pre-ADC ``max|partial|``
    per chunk.
    """
    nb, e, rows, nmodes = ip.shape
    others = [d for d in range(nmodes) if d != mode]
    acc_t = torch.int16 if len(others) <= 2 else torch.float32
    had = None
    scale = vp                                          # (nb, E, rows)
    for d in others:
        idx = ip[..., d].long()
        g = qs[d][idx].to(acc_t)                        # (nb, E, rows, R)
        had = g if had is None else had * g
        scale = scale * ss[d][idx, 0]
    contrib = scale[..., None] * had.to(torch.float32)  # (nb, E, rows, R)
    rank = contrib.shape[-1]
    block = torch.arange(nb * e, device=lp.device).view(nb, e, 1)
    slot = (block * n_seg + lp).reshape(-1)             # stream order
    parts = torch.zeros((nb * e * n_seg, rank), dtype=torch.float32,
                        device=contrib.device)
    parts.index_add_(0, slot, contrib.reshape(-1, rank))
    parts = parts.view(nb, e * n_seg, rank)
    chunk_max = parts.abs().amax(dim=(1, 2))            # (nb,)
    if adc_bits:
        full_scale = chunk_max.clamp_min(1e-30).view(nb, 1, 1)
        parts = adc_transfer(parts, 2 ** adc_bits, full_scale)
    out = torch.zeros((out_rows + 1, rank), dtype=torch.float32,
                      device=parts.device)
    out.index_add_(0, sp.reshape(-1).long(), parts.reshape(-1, rank))
    out = out[:out_rows]
    return (out, chunk_max) if return_chunk_max else out


# ------------------------------------------------------------- CUDA kernel


@dataclasses.dataclass(frozen=True)
class SegmentPlan:
    """Compact addressing of a layout's segments for the CUDA kernel — pure
    index arithmetic on ``(lp, sp, n_seg)``, built on the host once per
    layout (``fused_stream_mttkrp`` caches it on the CSF).

    The layout's ``sp`` pads every block to ``n_seg`` slots; only
    ``lp[b, -1] + 1`` of them exist. Numbering the existing segments in
    stream order gives a list whose output rows are non-decreasing (the
    stream is sorted; pad segments map to ``out_rows`` and sort last), so
    the segments of one output row are one contiguous run.
    """

    seg_ptr: torch.Tensor     # (nb*E + 1,) int32: first compact row of a block
    seg_chunk: torch.Tensor   # (total,) int32: chunk of each compact segment
    row_ptr: torch.Tensor     # (out_rows + 1,) int32: run of segments per row
    total: int                # number of segments that exist
    chunk_segs: int           # the most segments one chunk holds
    long_rows: torch.Tensor   # (n,) int32: rows whose run exceeds long_run segments
    long_run: int             # the fold's warps leave a longer run to its own CTA

    @classmethod
    def build(cls, lp, sp, n_seg: int, out_rows: int) -> "SegmentPlan":
        device = lp.device
        lp_np = lp.detach().cpu().numpy()
        nb, e, _ = lp_np.shape
        step = np.diff(lp_np, axis=-1)
        if (lp_np[..., 0] != 0).any() or ((step != 0) & (step != 1)).any():
            raise ValueError(
                "lp is not a sorted block layout: block-local segment ids "
                "must start at 0 and rise by at most 1 per nonzero")
        nseg = lp_np[..., -1].reshape(-1).astype(np.int64) + 1      # (nb*E,)
        if nseg.max() > n_seg:
            raise ValueError(f"a block holds {nseg.max()} segments, n_seg={n_seg}")
        seg_ptr = np.concatenate(([0], np.cumsum(nseg)))
        total = int(seg_ptr[-1])
        if total >= 2 ** 31:
            raise ValueError(f"{total} segments exceed the kernel's int32 addressing")
        sp_np = sp.detach().cpu().numpy().reshape(nb * e, n_seg)
        exists = np.arange(n_seg)[None, :] < nseg[:, None]
        seg_row = sp_np[exists]                                      # stream order
        if (np.diff(seg_row) < 0).any():
            raise ValueError(
                "sp is not the segment→row map of a sorted stream: output "
                "rows must be non-decreasing in stream order")
        seg_chunk = np.repeat(np.arange(nb * e) // e, nseg)
        row_ptr = np.searchsorted(seg_row, np.arange(out_rows + 1), side="left")

        def up(a):
            return torch.as_tensor(a.astype(np.int32), device=device)

        return cls(seg_ptr=up(seg_ptr), seg_chunk=up(seg_chunk),
                   row_ptr=up(row_ptr), total=total,
                   chunk_segs=int(np.diff(seg_ptr[::e]).max()),
                   long_rows=up(np.flatnonzero(np.diff(row_ptr) > LONG_RUN)),
                   long_run=LONG_RUN)


def _entry():
    lib = _build.load("stream_mttkrp")
    fn = lib.stream_mttkrp_launch
    if not fn.argtypes:
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * 11 + [ctypes.c_int] * 11 \
            + [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
        lib.stream_chunk_smem_bytes.restype = ctypes.c_longlong
        lib.stream_chunk_smem_bytes.argtypes = [ctypes.c_int] * 3
    return lib, fn


def _chunk_smem(rank: int, nmodes: int, chunk_segs: int) -> int:
    """Dynamic shared memory of a chunk-route CTA, as the library lays it
    out (``stream_chunk_smem_bytes``: the warps' gather rings, 16 warp
    maxima, the chunk's compact partials)."""
    lib, _ = _entry()
    return int(lib.stream_chunk_smem_bytes(nmodes, rank, chunk_segs))


def _chunk_takes(rank: int, smem: int, aligned: bool) -> bool:
    """Whether the chunk route can take a layout: a rank it is built for
    (:data:`CHUNK_RANKS`: 16-byte factor rows that a warp's lanes cover four
    columns each), ``aligned`` codes, and a CTA of ``smem`` bytes
    (:func:`_chunk_smem`) that fits shared memory."""
    return aligned and rank in CHUNK_RANKS and smem <= MAX_SMEM


def _route(rank: int, smem: int, aligned: bool) -> str:
    """The route of a launch: ``"chunk"`` where :func:`_chunk_takes`, else
    ``"three_pass"``."""
    return "chunk" if _chunk_takes(rank, smem, aligned) else "three_pass"


def plan_route(qs, mode: int, plan: SegmentPlan) -> str:
    """The route a launch over ``plan`` with the codes ``qs`` takes
    (:func:`_route` of the rank, the chunk CTA's shared memory and the codes'
    alignment) — what the autotune sweep reports beside each trial."""
    others = [d for d in range(len(qs)) if d != mode]
    rank = qs[others[0]].shape[-1]
    aligned = all(qs[d].data_ptr() % 16 == 0 for d in others)
    return _route(rank, _chunk_smem(rank, len(qs), plan.chunk_segs), aligned)


def _check_layout(ip, vp, lp, sp, qs, ss, mode, n_seg):
    if ip.ndim != 4:
        raise ValueError(f"ip must be (nb, E, rows, nmodes), got {tuple(ip.shape)}")
    nb, e, rows, nmodes = ip.shape
    if not 2 <= nmodes <= MAX_MODES or not 0 <= mode < nmodes:
        raise ValueError(f"need 2..{MAX_MODES} modes and a mode among them; "
                         f"got nmodes={nmodes}, mode={mode}")
    if tuple(vp.shape) != (nb, e, rows) or tuple(lp.shape) != (nb, e, rows):
        raise ValueError("vp/lp must be (nb, E, rows) like ip")
    if tuple(sp.shape) != (nb, e * n_seg):
        raise ValueError(f"sp must be (nb, E*n_seg)={nb, e * n_seg}, got {tuple(sp.shape)}")
    if len(qs) != nmodes or len(ss) != nmodes:
        raise ValueError("qs/ss must hold one entry per mode")
    for name, t, dt in (("ip", ip, torch.int32), ("vp", vp, torch.float32),
                        ("lp", lp, torch.int32), ("sp", sp, torch.int32)):
        if t.dtype != dt:
            raise TypeError(f"{name} must be {dt}, got {t.dtype}")
    rank = next(q.shape[-1] for d, q in enumerate(qs) if d != mode)
    for d in range(nmodes):
        if d == mode:
            continue
        if qs[d].dtype != torch.int8 or ss[d].dtype != torch.float32:
            raise TypeError(f"qs[{d}]/ss[{d}] must be int8/float32")
        if qs[d].ndim != 2 or qs[d].shape[1] != rank \
                or tuple(ss[d].shape) != (qs[d].shape[0], 1):
            raise ValueError(f"qs[{d}] must be (I_d, R) and ss[{d}] (I_d, 1)")
    return nb, e, rows, nmodes, rank


def stream_mttkrp_fused(ip, vp, lp, sp, qs, ss, mode, n_seg, adc_bits,
                        out_rows, plan: SegmentPlan | None = None,
                        return_chunk_max: bool = False):
    """The fused streaming MTTKRP of one layout: ``(out_rows, R)`` f32.

    ``(ip, vp, lp, sp, n_seg)`` is ``sparse.stream.stream_layout``'s tuple,
    ``(qs, ss)`` :func:`quantize_stream_factors`'s. CUDA tensors go through
    the kernel on the current stream without synchronizing (or raise), on
    the route :func:`_route` names; CPU tensors — only because they lie on
    the CPU — through :func:`stream_mttkrp_fused_torch`. ``plan`` is the
    layout's :class:`SegmentPlan`; without one it is built here, which
    copies ``lp`` and ``sp`` to the host — callers that reuse a layout pass
    it in.
    """
    if not ip.is_cuda:
        _check_layout(ip, vp, lp, sp, qs, ss, mode, n_seg)
        return stream_mttkrp_fused_torch(
            ip, vp, lp, sp, qs, ss, mode, n_seg, adc_bits, out_rows,
            return_chunk_max=return_chunk_max)
    return _launch(ip, vp, lp, sp, qs, ss, mode, n_seg, adc_bits, out_rows,
                   plan=plan, return_chunk_max=return_chunk_max)


def _launch(ip, vp, lp, sp, qs, ss, mode, n_seg, adc_bits, out_rows,
            plan: SegmentPlan | None = None, return_chunk_max: bool = False,
            route: str | None = None):
    """One launch of kernel 1 on CUDA tensors. ``route`` None takes the
    route :func:`stream_mttkrp_fused` takes; the checks name ``"chunk"`` or
    ``"three_pass"`` to hold one route against the other. It only chooses
    how the same result is computed; a route that cannot take the layout
    raises."""
    if route not in (None, *ROUTES):
        raise ValueError(f"route must be one of {ROUTES}, got {route!r}")
    nb, e, rows, nmodes, rank = _check_layout(ip, vp, lp, sp, qs, ss, mode, n_seg)
    if not ip.is_cuda:
        raise ValueError("kernel 1 launches on CUDA tensors only")
    if not 0 <= adc_bits <= 24:
        raise ValueError(f"adc_bits must be in 0..24 for the kernel, got {adc_bits}")
    others = [d for d in range(nmodes) if d != mode]
    live = [ip, vp, lp, sp] + [t for d in others for t in (qs[d], ss[d])]
    for t in live:
        if t.device != ip.device:
            raise ValueError("layout and quantized factors must live on one device")
        if not t.is_contiguous():
            raise ValueError("layout and quantized factors must be contiguous")
    # every coordinate the kernel gathers with must be in range: the layout
    # is trusted to come from stream_layout over factors of these shapes
    if plan is None:
        plan = SegmentPlan.build(lp, sp, n_seg, out_rows)
    if plan.seg_ptr.shape[0] != nb * e + 1 or plan.row_ptr.shape[0] != out_rows + 1:
        raise ValueError("plan does not belong to this layout")
    aligned = all(qs[d].data_ptr() % 16 == 0 for d in others)
    smem = _chunk_smem(rank, nmodes, plan.chunk_segs)
    if route is None:
        route = _route(rank, smem, aligned)
    if route == "chunk" and not _chunk_takes(rank, smem, aligned):
        raise ValueError(
            f"the chunk route needs 16-byte aligned codes, a rank in {CHUNK_RANKS} "
            f"and {smem} <= {MAX_SMEM} bytes of shared memory; got rank {rank}, "
            f"{nmodes} modes, {plan.chunk_segs} segments a chunk, aligned={aligned}")

    with torch.cuda.device(ip.device):
        try:
            parts = torch.empty((max(plan.total, 1), rank), dtype=torch.float32,
                                device=ip.device)
            chunk_max = torch.empty((nb,), dtype=torch.int32, device=ip.device)
            out = torch.empty((out_rows, rank), dtype=torch.float32,
                              device=ip.device)
        except torch.OutOfMemoryError as oom:
            raise RuntimeError(
                f"fused stream kernel needs {plan.total * rank * 4 / 2**20:.0f} "
                f"MiB of scratch for {plan.total} segments x rank {rank} and it "
                "does not fit device memory: the stream has too many short "
                "fibers for one launch") from oom
        ptr_array = ctypes.c_void_p * nmodes
        q_ptrs = ptr_array(*[qs[d].data_ptr() if d != mode else None
                             for d in range(nmodes)])
        s_ptrs = ptr_array(*[ss[d].data_ptr() if d != mode else None
                             for d in range(nmodes)])
        lib, fn = _entry()
        err = fn(ip.data_ptr(), vp.data_ptr(), lp.data_ptr(),
                 ctypes.cast(q_ptrs, ctypes.c_void_p),
                 ctypes.cast(s_ptrs, ctypes.c_void_p),
                 plan.seg_ptr.data_ptr(), plan.seg_chunk.data_ptr(),
                 plan.row_ptr.data_ptr(), parts.data_ptr(), chunk_max.data_ptr(),
                 out.data_ptr(), nb, e, rows, nmodes, mode, rank, out_rows,
                 plan.total, int(adc_bits), _ROUTE_IDS[route], plan.chunk_segs,
                 plan.long_rows.data_ptr(), plan.long_rows.numel(), plan.long_run,
                 torch.cuda.current_stream().cuda_stream)
    _build.check_launch(err, lib, "stream_mttkrp")
    stream_mttkrp_fused.launches += 1
    stream_mttkrp_fused.routes[route] += 1
    if return_chunk_max:
        # the scratch holds the bits of the non-negative f32 max per chunk
        return out, chunk_max.view(torch.float32)
    return out


#: kernel launches made by :func:`stream_mttkrp_fused` (CUDA path only), all routes
stream_mttkrp_fused.launches = 0
#: the same launches by route
stream_mttkrp_fused.routes = {route: 0 for route in ROUTES}


# ----------------------------------------------------------- front door


_LOWERING_FNS = {
    "cuda": stream_mttkrp_fused,
    "torch": stream_mttkrp_fused_torch,
    "ref": ref.stream_mttkrp_fused_ref,
}


def fused_stream_mttkrp(csf, factors, config=None, adc_bits: int = 16,
                        lowering: str = "torch",
                        exec_blocks: int | None = None) -> torch.Tensor:
    """Fused streaming MTTKRP over a mode-rooted CSF: (out_rows, R).

    Reuses ``sparse.stream``'s cached block layout, quantizes the
    non-target factors per row (cached on identity), and drains the stream
    through the requested lowering. ``lowering`` must already be resolved
    (``backends.lowering.resolve_lowering``); ``exec_blocks=None`` asks
    ``kernels.autotune`` for its deterministic heuristic.
    """
    from repro_torch.backends.base import resolve_config
    from repro_torch.backends.lowering import require_cuda
    from repro_torch.kernels.autotune import stream_params
    from repro_torch.sparse.stream import stream_layout

    try:
        fn = _LOWERING_FNS[lowering]
    except KeyError:
        raise RuntimeError(
            f"no fused-stream dispatch for resolved lowering {lowering!r}; "
            f"known: {', '.join(_LOWERING_FNS)}"
        ) from None
    cfg = resolve_config(config)
    mode = csf.mode_order[0]
    out_rows = csf.shape[mode]
    if exec_blocks is None:
        exec_blocks = stream_params(csf, tuple(factors), cfg)["exec_blocks"]
    ip, vp, lp, sp, n_seg = stream_layout(csf, cfg.rows, exec_blocks)
    qs, ss = stream_factor_quants(tuple(factors), mode)
    require_cuda(lowering, ip)
    if lowering != "cuda":
        return fn(ip, vp, lp, sp, qs, ss, mode, n_seg, adc_bits, out_rows)
    return fn(ip, vp, lp, sp, qs, ss, mode, n_seg, adc_bits, out_rows,
              plan=segment_plan(csf, cfg.rows, lp, sp, n_seg))


def segment_plan(csf, rows: int, lp, sp, n_seg: int) -> SegmentPlan:
    """The :class:`SegmentPlan` of ``csf``'s layout ``(lp, sp, n_seg)`` at
    ``rows``: index arithmetic on the layout, so it is cached on the CSF
    beside it and rebuilt only when the layout is."""
    key = ("_stream_segment_plan", rows)
    cached = csf.__dict__.get(key)
    if cached is None or cached[0] is not lp:
        cached = (lp, SegmentPlan.build(lp, sp, n_seg, csf.shape[csf.mode_order[0]]))
        csf.__dict__[key] = cached
    return cached[1]
