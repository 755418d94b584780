"""Flash attention (online softmax), GQA + causal + logit softcap.

The hand-written Hopper kernel lives in ``csrc/flash_attention.cu`` (CUDA
C++, ``sm_90a``); it replaces the TPU kernel
``src/repro/kernels/flash_attention.py:_kernel`` (launched by
``flash_attention``). The TPU's sequential kv grid axis, which carried the
running max, denominator and accumulator in VMEM scratch, becomes a loop
inside one CTA per (batch*head, q tile) that keeps them in registers; tiles
wholly above the causal diagonal are skipped. bf16 inputs run their products
on the tensor cores through ``wgmma``, fed by TMA loads of K and V tiles
(exact bf16 products, f32 accumulation; the softmax weights as a two-term
bf16 split, 2^-17 relative); f32 inputs run IEEE f32 FMAs, no TF32. Head
dims above 256 run on a third kernel, the slab kernel: f32 on the CUDA
cores, a grid axis over 256-column slabs of the output, each CTA forming
the whole score itself. What bounds it on the card is operations — see the
source note in the ``.cu`` file.

The causal mask is top-left aligned, as the reference kernel's
``rows >= cols`` on global indices: row ``i`` sees keys ``0..i`` whether
``Sq`` equals ``Skv`` or not.

:func:`flash_attention` is the wrapper: for CUDA tensors it launches the
kernel (or raises); for CPU tensors — and only because they lie on the CPU —
it uses :func:`flash_attention_torch`, the plain PyTorch version: an exact
softmax in f32 over blocks of q rows, per kv head, never materialising more
than one block's logits, rounded once to q's dtype at the end.

Layouts are the reference's: q ``(B, H, Sq, D)``, k/v ``(B, Hkv, Skv, D)``,
out ``(B, H, Sq, D)`` in q's dtype.

The wrapper takes what the reference takes: any float dtype (f32 and bf16
run as they are; fp16 and f64 are staged to f32, run through the f32 kernel
and cast back — the reference's kernel computes in f32 whatever it is
given), and any head dim ``D >= 1`` (:func:`kernel_head_dim`). Up to 256 a
``D`` that is not one of :data:`KERNEL_HEAD_DIMS` is zero-padded to the next
one; above 256 it is zero-padded to a multiple of :data:`SLAB_MULTIPLE` and
runs on the slab kernel, in f32 (bf16 is staged to f32 and rounded once at
the end). Zero q/k columns add nothing to ``QKᵀ``, zero v columns are
sliced off, and the softmax scale is formed from the true ``D``. The
kernels launched are counted in ``flash_attention.routes`` by
:func:`kernel_route`. ``bq``/``bkv`` are the reference's tile
sizes: they are validated as the reference does (``Sq % min(bq, Sq) == 0``,
``Skv % min(bkv, Skv) == 0``) but they are not numerics — only the order of
sums depends on them — so the CUDA tile is the kernel's own.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build

NEG_INF = -1e30

#: head dims the bf16 and f32 kernels are instantiated for
KERNEL_HEAD_DIMS = (16, 32, 64, 128, 256)
#: head dims above 256 run on the slab kernel, padded to a multiple of this
SLAB_MULTIPLE = 64
#: the kernels of ``csrc/flash_attention.cu``, as ``flash_attention.routes``
#: counts their launches
ROUTES = ("wgmma", "f32", "slab")

# elements of one block's f32 logits in the plain version (256 MB)
_PLAIN_BLOCK_ELEMS = 1 << 26


def check_shapes(q, k, v, causal: bool = True, bq: int = 128, bkv: int = 128):
    """Validate the operands as the reference does; returns
    ``(b, h, hkv, sq, skv, d)``."""
    if q.ndim != 4 or k.ndim != 4 or v.ndim != 4:
        raise ValueError(
            f"q, k, v must be (B, H, S, D); got {tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    b, h, sq, d = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    if tuple(k.shape) != (b, hkv, skv, d) or tuple(v.shape) != tuple(k.shape):
        raise ValueError(
            f"k and v must be (B, Hkv, Skv, D) = {(b, hkv, skv, d)}; got "
            f"{tuple(k.shape)} / {tuple(v.shape)}")
    if hkv < 1 or h % hkv:
        raise ValueError(f"query heads {h} are not a multiple of kv heads {hkv}")
    bq, bkv = min(bq, sq), min(bkv, skv)
    if bq < 1 or bkv < 1 or sq % bq or skv % bkv:
        raise ValueError(
            f"Sq={sq} must be a multiple of bq={bq} and Skv={skv} of bkv={bkv} "
            "(the reference's tiling)")
    if q.dtype != k.dtype or q.dtype != v.dtype:
        raise TypeError(f"q, k, v must share a dtype; got {q.dtype}, {k.dtype}, {v.dtype}")
    if len({q.device, k.device, v.device}) != 1:
        raise ValueError("q, k, v must live on one device")
    return b, h, hkv, sq, skv, d


def _scale(d: int, scale):
    return d ** -0.5 if scale is None else float(scale)


def flash_attention_torch(q, k, v, causal: bool = True, softcap: float = 0.0,
                          scale: float | None = None, bq: int = 128, bkv: int = 128):
    """Plain PyTorch version of the kernel: the same function with an exact
    (not online) softmax in f32, chunked over kv heads and q blocks so that
    at most one block's logits exist at a time."""
    b, h, hkv, sq, skv, d = check_shapes(q, k, v, causal, bq, bkv)
    rep = h // hkv
    sc = _scale(d, scale)
    out = torch.empty((b, h, sq, d), dtype=q.dtype, device=q.device)
    rows = max(1, _PLAIN_BLOCK_ELEMS // (rep * skv))
    for bi in range(b):
        for g in range(hkv):
            heads = slice(g * rep, (g + 1) * rep)
            kf = k[bi, g].to(torch.float32)                       # (Skv, D)
            vf = v[bi, g].to(torch.float32)
            for r0 in range(0, sq, rows):
                r1 = min(sq, r0 + rows)
                kend = min(r1, skv) if causal else skv            # keys any row here sees
                qf = q[bi, heads, r0:r1].to(torch.float32)        # (rep, n, D)
                s = (qf @ kf[:kend].T) * sc                       # (rep, n, kend)
                if softcap > 0:
                    s = torch.tanh(s / softcap) * softcap
                if causal:
                    qi = torch.arange(r0, r1, device=q.device)[:, None]
                    ki = torch.arange(kend, device=q.device)[None, :]
                    s = s.masked_fill(ki > qi, NEG_INF)
                m = s.amax(dim=-1, keepdim=True)
                e = torch.exp(s - m)
                den = e.sum(dim=-1, keepdim=True).clamp_min(1e-30)
                out[bi, heads, r0:r1] = ((e @ vf[:kend]) / den).to(q.dtype)
    return out


def _entry():
    lib = _build.load("flash_attention")
    fn = lib.flash_attention_launch
    if not fn.argtypes:
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 7 \
            + [ctypes.c_float] * 2 + [ctypes.c_int, ctypes.c_void_p]
    return lib, fn


def kernel_head_dim(d: int) -> int:
    """The head dim a true head dim ``d >= 1`` runs at: the smallest of
    :data:`KERNEL_HEAD_DIMS` that holds it; above 256 the next multiple of
    :data:`SLAB_MULTIPLE` (the slab kernel's)."""
    if d < 1:
        raise ValueError(f"a head dim is at least 1, got {d}")
    for dk in KERNEL_HEAD_DIMS:
        if d <= dk:
            return dk
    return -(-d // SLAB_MULTIPLE) * SLAB_MULTIPLE


def kernel_route(d: int, dtype: torch.dtype) -> str:
    """The kernel that runs a true head dim ``d`` of ``dtype``: ``"wgmma"``
    (bf16 up to 256), ``"f32"`` (any other float dtype up to 256, staged to
    f32) or ``"slab"`` (above 256, every dtype staged to f32)."""
    if kernel_head_dim(d) > KERNEL_HEAD_DIMS[-1]:
        return "slab"
    return "wgmma" if dtype == torch.bfloat16 else "f32"


def padded_attention(fn, q, k, v, causal: bool = True, softcap: float = 0.0,
                     scale: float | None = None, **kw):
    """``fn`` (an attention of this module's signature) at the kernel's head
    dim: q/k/v zero-padded from ``D`` to :func:`kernel_head_dim`, the scale
    formed from the true ``D``, the padded output columns sliced off. Zero
    q/k columns add nothing to ``QKᵀ`` and zero v columns only make zero
    output columns, so this is ``fn`` at ``D`` up to the order of its sums."""
    d = q.shape[-1]
    dk = kernel_head_dim(d)
    sc = _scale(d, scale)
    if dk == d:
        return fn(q, k, v, causal=causal, softcap=softcap, scale=sc, **kw)
    pad = lambda t: torch.nn.functional.pad(t, (0, dk - d)).contiguous()
    out = fn(pad(q), pad(k), pad(v), causal=causal, softcap=softcap, scale=sc, **kw)
    return out[..., :d].contiguous()


def _launch(q, k, v, causal, softcap, scale):
    """One launch of a kernel on contiguous f32/bf16 q/k/v whose head dim is
    one of :data:`KERNEL_HEAD_DIMS`, or on f32 ones whose head dim is a
    larger multiple of :data:`SLAB_MULTIPLE`."""
    b, h, sq, d = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous and 16-byte aligned")
    out = torch.empty_like(q)
    lib, fn = _entry()
    with torch.cuda.device(q.device):
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 b, h, hkv, sq, skv, d, int(q.dtype == torch.bfloat16),
                 float(scale), float(softcap), int(bool(causal)),
                 torch.cuda.current_stream().cuda_stream)
    _build.check_launch(err, lib, "flash_attention")
    flash_attention.launches += 1
    flash_attention.routes[kernel_route(d, q.dtype)] += 1
    return out


def flash_attention(q, k, v, causal: bool = True, softcap: float = 0.0,
                    scale: float | None = None, bq: int = 128, bkv: int = 128):
    """Attention ``(B, H, Sq, D)`` in q's dtype. CUDA tensors (any float
    dtype, any ``D``; see the module note on staging and padding) go
    through one kernel launch on the current stream, without synchronizing;
    CPU tensors through :func:`flash_attention_torch`."""
    b, h, hkv, sq, skv, d = check_shapes(q, k, v, causal, bq, bkv)
    if not q.is_cuda:
        return flash_attention_torch(q, k, v, causal, softcap, scale, bq, bkv)
    if not q.dtype.is_floating_point:
        raise TypeError(f"the flash kernel takes float tensors, got {q.dtype}")
    if q.dtype == torch.float32 or kernel_route(d, q.dtype) == "wgmma":
        return padded_attention(_launch, q, k, v, causal, softcap, scale)
    f32 = lambda t: t.to(torch.float32)
    return padded_attention(_launch, f32(q), f32(k), f32(v), causal, softcap,
                            scale).to(q.dtype)


#: kernel launches made by :func:`flash_attention` (CUDA path only)
flash_attention.launches = 0
#: the same launches by kernel (:func:`kernel_route`)
flash_attention.routes = {route: 0 for route in ROUTES}
