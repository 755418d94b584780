"""Shared layers: param-def machinery, RMSNorm, RoPE variants, GQA attention
(full / sliding-window / softcapped; einsum and memory-chunked paths; KV-cache
decode), and gated MLPs with the optional pSRAM (photonic-offload) projection
path.

Param-def pattern, as in the reference: every block exposes ``defs(cfg)``
returning a nested dict of ``{"shape", "axes", "init", "scale", "dtype"}``
leaves (lists stand for the repeated layer groups); :func:`init_params`
builds tensors from defs with an explicit ``torch.Generator``, one draw per
leaf in tree order. Parameters are plain nested dicts of tensors.

Tensor layouts and casts are the reference's: activations ``(B, S, d)``,
q/k/v ``(B, S, H, hd)``; logits are formed in the input dtype and cast to
f32, softmax weights are cast to ``v``'s dtype before the PV product.

Ported: ``ddef``/``wdef``/``is_quantized``/``init_params``, ``rmsnorm``,
``apply_rope`` (full, partial, none and M-RoPE over three position streams),
``_mask_bias``, ``_sdpa``, ``_sdpa_chunked``, ``attention_fwd``, ``_new_kv``,
``attention_decode_append``, ``attention_decode`` (the write-through decode:
the encoder-decoder family's cross attention, and the self branch, which
writes the cache in place), ``attention_cache_defs``, ``mlp_defs``,
``mlp_fwd``. The reference's ``attention_decode`` options
``precomputed_q`` and ``skip_kv_write`` have no caller there or here and
are left out until one needs them. ``specs_of`` gives a def tree's
logical-axis tree in the port's layout (lists kept), ``shapes_of`` its
tensors on the ``meta`` device (the counterpart of ``ShapeDtypeStruct``).
The reference's ``stack_defs`` (its scanned layout, a leading ``"layers"``
axis) has no counterpart: the port keeps a list of groups. The
``dist.sharding.hint`` annotations sit where the reference's do.

On a model mesh the parameters are DTensors (``dist.placement``) and the
activations follow them through DTensor's own rules; three places reach
the local blocks: :func:`_proj` (kernel 2 on each card's block, and the
tensor-parallel layout of every exact projection fixed, so DTensor never
gathers a weight), the head splits (:func:`_split`: where the heads do not
divide over the model axis the activation is replicated first) and the
FSDP gather of a weight sharded over the data axes (``placement.gathered``).
"""
from __future__ import annotations

import functools
import math

import torch
import torch.nn.functional as F

from repro_torch._device import as_device
from repro_torch.core.photonic_layer import maybe_psram_matmul, psram_linear
from repro_torch.core.quantization import quantize_symmetric
from repro_torch.dist import placement
from repro_torch.dist.sharding import hint

from .config import ArchConfig

NEG_INF = -1e30

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16, "int8": torch.int8}


def as_dtype(name) -> torch.dtype:
    """A config's dtype string (or a torch dtype) as a torch dtype."""
    return name if isinstance(name, torch.dtype) else _DTYPES[str(name)]


# ---------------------------------------------------------------------------
# param defs
# ---------------------------------------------------------------------------

def ddef(shape, axes, init="normal", scale=None, dtype=None):
    if len(shape) != len(axes):
        raise ValueError(f"shape {shape} and axes {axes} differ in rank")
    return {"shape": tuple(shape), "axes": tuple(axes), "init": init,
            "scale": scale, "dtype": dtype}


def _is_def(x):
    return isinstance(x, dict) and set(x) == {"shape", "axes", "init", "scale", "dtype"}


def wdef(cfg, shape, axes):
    """Projection-weight def: int8 words + per-column scale when the pSRAM
    stored-weight path is on (weights stationary in the array), else a plain
    dense def."""
    if cfg.psram_projections and cfg.psram_stored_int8:
        scale_shape = (1,) * (len(shape) - 1) + (shape[-1],)
        scale_axes = (None,) * (len(shape) - 1) + (axes[-1],)
        return {
            "q": ddef(shape, axes, init="qnormal", dtype="int8"),
            "scale": ddef(scale_shape, scale_axes, init="qscale", dtype="float32"),
        }
    return ddef(shape, axes)


def is_quantized(w) -> bool:
    return isinstance(w, dict) and set(w) == {"q", "scale"} and not _is_def(w)


def _map_defs(fn, defs):
    if _is_def(defs):
        return fn(defs)
    if isinstance(defs, dict):
        return {name: _map_defs(fn, d) for name, d in defs.items()}
    if isinstance(defs, (list, tuple)):
        return [_map_defs(fn, d) for d in defs]
    raise TypeError(f"not a param def tree: {type(defs).__name__}")


def specs_of(defs):
    """The logical-axis tree of ``defs`` (a tuple of names a leaf)."""
    return _map_defs(lambda d: d["axes"], defs)


def dtypes_of(defs):
    """Each leaf's own dtype name (None: the model's dtype)."""
    return _map_defs(lambda d: d["dtype"], defs)


def shapes_of(defs, dtype, device="meta"):
    """The tensors ``defs`` describe, empty on ``device`` (``meta``: shapes
    and dtypes, no memory), each in its def's dtype or ``dtype``."""
    return _map_defs(lambda d: torch.empty(d["shape"], dtype=as_dtype(d["dtype"] or dtype),
                                           device=device), defs)


def _init_leaf(gen, d, dtype, device):
    dt = as_dtype(d["dtype"] or dtype)
    shape = d["shape"]
    if d["init"] == "zeros":
        return torch.zeros(shape, dtype=dt, device=device)
    if d["init"] == "ones":
        return torch.ones(shape, dtype=dt, device=device)
    fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
    if d["init"] == "qnormal":  # pre-programmed array words
        w = torch.randn(shape, generator=gen, device=device) / math.sqrt(fan_in)
        q, _ = quantize_symmetric(w, axis=tuple(range(len(shape) - 1)))
        return q
    if d["init"] == "qscale":
        # matches qnormal: scale ~= max|w| / 127 per output column; the
        # reference takes fan_in = shape[-1] here, kept as it is
        fan_in = shape[-1]
        return torch.full(shape, 4.0 / math.sqrt(max(fan_in, 2)) / 127.0, dtype=dt,
                          device=device)
    scale = d["scale"] if d["scale"] is not None else 1.0 / math.sqrt(fan_in)
    return (torch.randn(shape, generator=gen, device=device) * scale).to(dt)


def init_params(gen, defs, dtype=torch.float32, device="cuda", place=None):
    """Tensors for ``defs`` (nested dicts and lists of defs), drawn from
    ``gen`` (a seed, or a generator on ``device``, the card unless the
    caller asks for the CPU) one leaf after another in tree order. The
    values are not the reference's (a torch generator is not a JAX key);
    ``convert.model_params`` carries the reference's own over.

    ``place(leaf, axes)``, where given, takes each full leaf as it is drawn
    (a DTensor's block on a mesh: ``dist.placement``), so every rank draws
    the same stream and the peak is one leaf."""
    device = as_device(device)
    if gen is not None and not isinstance(gen, torch.Generator):
        gen = torch.Generator(device=device).manual_seed(int(gen))
    if _is_def(defs):
        leaf = _init_leaf(gen, defs, dtype, device)
        return leaf if place is None else place(leaf, defs["axes"])
    if isinstance(defs, dict):
        return {name: init_params(gen, d, dtype, device, place) for name, d in defs.items()}
    if isinstance(defs, (list, tuple)):
        return [init_params(gen, d, dtype, device, place) for d in defs]
    raise TypeError(f"not a param def tree: {type(defs).__name__}")


# ---------------------------------------------------------------------------
# norm
# ---------------------------------------------------------------------------

def rmsnorm_defs(d):
    return {"w": ddef((d,), ("embed",), init="ones")}


def rmsnorm(p, x, eps):
    xf = x.to(torch.float32)
    var = xf.square().mean(dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * placement.gathered(p["w"], keep=()).to(torch.float32)).to(x.dtype)


def _split(x, *shape):
    """``x.reshape(shape)``; on a mesh through ``placement.reshape`` (heads
    that do not divide over the model axis replicate the activation)."""
    if type(x) is torch.Tensor:
        return x.reshape(*shape)
    return placement.reshape(x, *shape)


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------

def _rot_half(x):
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([-x2, x1], dim=-1)


@functools.lru_cache(maxsize=None)
def _mrope_streams(sections: tuple, half: int, device: torch.device) -> torch.Tensor:
    """(half,) int64: the position stream (0 = t, 1 = h, 2 = w) each
    frequency takes, the sections splitting the frequency axis in order
    (the reference's ``searchsorted(cumsum(sections)[1:], i, side="right")``).
    Kept per device: a decode step would otherwise copy it to the card at
    every layer."""
    sec = torch.cumsum(torch.tensor((0,) + sections), 0)
    return torch.searchsorted(sec[1:], torch.arange(half), right=True).to(device)


@functools.lru_cache(maxsize=None)
def _inv_freq(theta: float, rot: int, device: torch.device) -> torch.Tensor:
    """(rot/2,) f32 inverse frequencies ``theta ** (-2i / rot)``, computed on
    the CPU (the reference's bits there) and kept per device, so the card's
    angles are the CPU's bits too."""
    return (theta ** (-torch.arange(0, rot, 2, dtype=torch.float32) / rot)).to(device)


def _rope_angles(pos, rot: int, cfg: ArchConfig) -> torch.Tensor:
    """(B, S, rot/2) f32 rotation angles. An M-RoPE angle (``pos`` of shape
    (3, B, S)) is the one product ``pos[stream[i]] * inv[i]``, which is what
    the reference's one-hot contraction sums to (its other two terms are
    exact zeros), so the angles are the same bits."""
    inv = _inv_freq(float(cfg.rope_theta), rot, pos.device)
    if cfg.rope == "mrope":
        # sections split the frequency axis across the t/h/w position streams
        stream = _mrope_streams(tuple(cfg.mrope_sections), rot // 2, pos.device)
        return pos.to(torch.float32)[stream].permute(1, 2, 0) * inv
    return pos.to(torch.float32)[..., None] * inv


def apply_rope(x, pos, cfg: ArchConfig):
    """x: (B, S, H, hd); pos: (B, S) int32, or (3, B, S) for M-RoPE. cos/sin
    are formed in f32 and cast to ``x``'s dtype before the products, as in
    the reference (whose CPU cos/sin differ from PyTorch's by up to one f32
    ulp; the angles are the reference's bits, on the card too)."""
    if cfg.rope == "none":
        return x
    hd = x.shape[-1]
    rot = int(hd * cfg.rope_partial_frac) if cfg.rope == "partial" else hd
    rot -= rot % 2
    x_rot, x_pass = x[..., :rot], x[..., rot:]
    angles = _rope_angles(pos, rot, cfg)                              # (B, S, rot/2)
    cos = torch.cos(angles)[..., None, :]
    sin = torch.sin(angles)[..., None, :]
    cos = torch.cat([cos, cos], dim=-1).to(x.dtype)                   # (B, S, 1, rot)
    sin = torch.cat([sin, sin], dim=-1).to(x.dtype)
    y = x_rot * cos + _rot_half(x_rot) * sin
    return torch.cat([y, x_pass], dim=-1)


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------

def attention_defs(cfg: ArchConfig):
    d = cfg.d_model
    return {
        "wq": wdef(cfg, (d, cfg.q_dim), ("embed", "qdim")),
        "wk": wdef(cfg, (d, cfg.kv_dim), ("embed", "kvdim")),
        "wv": wdef(cfg, (d, cfg.kv_dim), ("embed", "kvdim")),
        "wo": wdef(cfg, (cfg.q_dim, d), ("qdim", "embed")),
    }


def _proj(x, w, cfg: ArchConfig):
    if is_quantized(w):  # stored-int8 array words (weights stationary)
        return psram_linear(x, w, adc_bits=cfg.adc_bits).to(x.dtype)
    if type(w) is not torch.Tensor and placement.is_dtensor(w):
        return _proj_placed(x, w, cfg)
    return maybe_psram_matmul(x, w, cfg.psram_projections, cfg.adc_bits)


def _proj_placed(x, w, cfg: ArchConfig):
    """A projection on a model mesh. The weight is gathered over the data
    axes (FSDP) and keeps its model-axis block; the input is laid out for it
    (replicated on ``"model"`` for a column-parallel weight, its last dim
    sharded there for a row-parallel one), and a row-parallel product's
    partial sums are all-reduced."""
    from repro_torch.core.photonic_layer import _model_split, _psram_linear_placed
    if cfg.psram_projections:
        return _psram_linear_placed(x, adc_bits=cfg.adc_bits, w=w, out_dtype=x.dtype).to(x.dtype)
    w = placement.gathered(w)
    split = _model_split(w)
    names = w.device_mesh.mesh_dim_names
    if "model" in names and placement.is_dtensor(x):
        want = list(x.placements)
        want[names.index("model")] = (placement.Shard(x.ndim - 1) if split == "k"
                                      else placement.Replicate())
        if tuple(want) != tuple(x.placements):
            x = x.redistribute(x.device_mesh, want)
    return placement.settled(x @ w)


def _mask_bias(q_pos, k_pos, causal, window):
    """(..., Sq, Sk) additive f32 bias from position grids."""
    ok = torch.ones(torch.broadcast_shapes(q_pos.shape, k_pos.shape), dtype=torch.bool,
                    device=q_pos.device)
    if causal:
        ok &= q_pos >= k_pos
    if window:
        ok &= (q_pos - k_pos) < window
    zero = torch.zeros((), dtype=torch.float32, device=q_pos.device)
    return torch.where(ok, zero, torch.full_like(zero, NEG_INF))


def _scale(cfg: ArchConfig, hd: int) -> float:
    return cfg.query_scale if cfg.query_scale is not None else hd ** -0.5


def _sdpa_placed(q, k, v, bias, cfg: ArchConfig):
    """:func:`_sdpa` on each rank's block where q, k and v lie alike, split
    over the batch and the heads only: each (row, kv-head group) is
    independent, and a block of q's heads uses exactly the same block of
    kv heads (kv-major groups). None where they lie otherwise (a cache
    split over its sequence): DTensor's own rules take it."""
    from torch.distributed.tensor import DTensor
    pls = tuple(q.placements)
    if not (isinstance(k, DTensor) and isinstance(v, DTensor) and tuple(k.placements) == pls
            and tuple(v.placements) == pls
            and all(not isinstance(p, placement.Shard) or p.dim % 4 in (0, 2) for p in pls)
            and not any(isinstance(p, placement.Partial) for p in pls)):
        return None
    if isinstance(bias, DTensor):
        bias = bias.full_tensor()
    out = _sdpa(q.to_local(), k.to_local(), v.to_local(), bias, cfg)
    return DTensor.from_local(out, q.device_mesh, pls)


def _sdpa(q, k, v, bias, cfg: ArchConfig):
    """Grouped-query attention core. q:(B,Sq,H,hd) k/v:(B,Sk,Hkv,hd); heads
    are grouped kv-major (``q.reshape(b, sq, hkv, rep, hd)``)."""
    if type(q) is not torch.Tensor and placement.is_dtensor(q):
        out = _sdpa_placed(q, k, v, bias, cfg)
        if out is not None:
            return out
    b, sq, h, hd = q.shape
    hkv = k.shape[2]
    rep = h // hkv
    qg = _split(q, b, sq, hkv, rep, hd)
    logits = torch.einsum("bqkrd,bskd->bkrqs", qg, k).to(torch.float32) * _scale(cfg, hd)
    if cfg.attn_softcap > 0:
        logits = torch.tanh(logits / cfg.attn_softcap) * cfg.attn_softcap
    logits = logits + bias  # bias broadcasts over (b, hkv, rep)
    if cfg.attn_probs_bf16:
        # flash-style: f32 max/sum statistics, bf16 weights
        m = logits.amax(dim=-1, keepdim=True)
        e = torch.exp(logits - m).to(torch.bfloat16)
        denom = e.to(torch.float32).sum(dim=-1, keepdim=True).clamp_min(1e-30)
        p = e / denom.to(torch.bfloat16)
    else:
        p = torch.softmax(logits, dim=-1)
    out = torch.einsum("bkrqs,bskd->bqkrd", p.to(v.dtype), v)
    return _split(out, b, sq, h, hd)


def _sdpa_chunked(q, k, v, cfg: ArchConfig, causal, window, q0: int = 0):
    """Memory-bounded attention: a loop over q chunks (exact softmax)."""
    b, s, h, hd = q.shape
    cq = min(cfg.attn_chunk, s)
    if s % cq:
        raise ValueError(f"sequence {s} is not a multiple of the q chunk {cq}")
    k_pos = torch.arange(k.shape[1], device=q.device)[None, :]
    outs = []
    for i in range(s // cq):
        q_pos = (q0 + i * cq + torch.arange(cq, device=q.device))[:, None]
        bias = _mask_bias(q_pos, k_pos, causal, window)  # (cq, Sk)
        outs.append(_sdpa(q[:, i * cq:(i + 1) * cq], k, v, bias, cfg))
    return torch.cat(outs, dim=1)


def attention_fwd(
    p, x, cfg: ArchConfig, pos, *, layer_local: bool = False,
    kv_override=None, causal: bool = True,
):
    """Full-sequence attention (train / prefill). Returns (y, (k, v))."""
    b, s, d = x.shape
    q = _split(_proj(x, p["wq"], cfg), b, s, cfg.n_heads, cfg.head_dim)
    if kv_override is None:
        k = _split(_proj(x, p["wk"], cfg), b, s, cfg.n_kv_heads, cfg.head_dim)
        v = _split(_proj(x, p["wv"], cfg), b, s, cfg.n_kv_heads, cfg.head_dim)
        k = apply_rope(k, pos, cfg)
    else:  # cross attention: kv precomputed from the encoder
        k, v = kv_override
    q = apply_rope(q, pos, cfg)
    q = hint(q, ("batch", "seq", "heads", None))
    k = hint(k, ("batch", "seq", "kv_heads", None))
    v = hint(v, ("batch", "seq", "kv_heads", None))
    window = cfg.sliding_window if layer_local else 0
    if cfg.attention_impl == "chunked" and s > cfg.attn_chunk:
        out = _sdpa_chunked(q, k, v, cfg, causal, window)
    else:
        qp = torch.arange(s, device=x.device)[:, None]
        kp = torch.arange(k.shape[1], device=x.device)[None, :]
        out = _sdpa(q, k, v, _mask_bias(qp, kp, causal, window), cfg)
    out = hint(out, ("batch", "seq", "heads", None))
    y = _proj(_split(out, b, s, cfg.q_dim), p["wo"], cfg)
    return y, (k, v)


def _cache_pos(cache_pos, device) -> torch.Tensor:
    """``cache_pos`` (an int, or a ``(b,)`` tensor of per-row lengths) as a
    (1 or b, 1) int32 tensor on ``device``. An int is filled in on the device:
    ``torch.as_tensor(int, device="cuda")`` is a blocking host-to-device copy,
    which would wait for the card at every layer of every decode step."""
    if isinstance(cache_pos, torch.Tensor):
        return cache_pos.to(device=device, dtype=torch.int32).reshape(-1, 1)
    return torch.full((1, 1), int(cache_pos), dtype=torch.int32, device=device)


def _decode_pos(cache_pos, b: int, device) -> torch.Tensor:
    """``cache_pos`` (a scalar, or ``(b,)`` per-row lengths) as a (b, 1)
    int32 position grid."""
    return _cache_pos(cache_pos, device).expand(b, 1)


def _new_kv(p, x, cfg: ArchConfig, cache_pos):
    """Project + rope the decode token's q/k/v (shared by both decode paths).

    ``cache_pos`` is a scalar (whole batch at one position) or a ``(b,)``
    vector (continuous batching: every row decodes at its own length).
    """
    b = x.shape[0]
    q = _split(_proj(x, p["wq"], cfg), b, 1, cfg.n_heads, cfg.head_dim)
    pos = _decode_pos(cache_pos, b, x.device)
    if cfg.rope == "mrope":
        pos = pos[None].expand(3, b, 1)
    q = apply_rope(q, pos, cfg)
    kn = _split(_proj(x, p["wk"], cfg), b, 1, cfg.n_kv_heads, cfg.head_dim)
    kn = apply_rope(kn, pos, cfg)
    vn = _split(_proj(x, p["wv"], cfg), b, 1, cfg.n_kv_heads, cfg.head_dim)
    return kn, vn, q


def attention_decode_append(
    p, x, cfg: ArchConfig, k_old, v_old, cache_pos, *, layer_local: bool = False,
    precomputed=None,
):
    """Decode against a *stale* cache slice plus the explicit new token.

    k_old/v_old hold positions < cache_pos (position cache_pos may be
    stale); the new token's kn/vn enter through a two-block softmax combine
    (history logits, new-token logit) instead of a write into the cache
    first. ``o_h`` is in ``v``'s dtype, the combine weights in f32.
    """
    b = x.shape[0]
    kn, vn, q = precomputed if precomputed is not None else _new_kv(p, x, cfg, cache_pos)
    if type(k_old) is not torch.Tensor and placement.is_dtensor(k_old):
        out = _decode_placed(q, kn, vn, k_old, v_old, cache_pos, cfg, layer_local)
    else:
        out = _decode_core(_split(q, b, 1, cfg.n_kv_heads, cfg.n_heads // cfg.n_kv_heads,
                                  cfg.head_dim), kn, vn, k_old, v_old, cache_pos, cfg,
                           layer_local)
    return _proj(_split(out, b, 1, cfg.q_dim).to(x.dtype), p["wo"], cfg)


def _decode_placed(q, kn, vn, k_old, v_old, cache_pos, cfg: ArchConfig, layer_local):
    """:func:`_decode_core` on each rank's block of a placed cache (split
    over its batch, its kv heads and, ``seq_kv``, its sequence): q and the
    new token's k / v are laid out as the cache with the sequence whole;
    where the sequence is split, each rank's block of the history is
    combined across its axis (the max, then the rescaled sums: the
    two-block softmax combine over the blocks). The result is q-shaped,
    laid out as q's heads."""
    from torch.distributed.tensor import DTensor
    mesh = k_old.device_mesh
    pls = tuple(k_old.placements)
    if (tuple(v_old.placements) != pls
            or any(isinstance(p, placement.Partial) for p in pls)
            or any(isinstance(p, placement.Shard) and p.dim % 4 == 3 for p in pls)):
        raise ValueError(f"a placed KV cache lies as {pls}: its head dim is never split")
    want = tuple(placement.Replicate() if isinstance(p, placement.Shard) and p.dim == 1 else p
                 for p in pls)
    q, kn, vn = (t.redistribute(mesh, want) if tuple(t.placements) != want else t
                 for t in (q, kn, vn))
    ql = q.to_local()
    b, _, h, hd = ql.shape
    hkv_l = kn.to_local().shape[2]
    seq_axes = [i for i, p in enumerate(pls) if isinstance(p, placement.Shard) and p.dim == 1]
    if len(seq_axes) > 1:
        raise ValueError(f"a cache's sequence split over several mesh axes: {pls}")
    k0, group = 0, None
    if seq_axes:
        i = seq_axes[0]
        k0 = mesh.get_coordinate()[i] * k_old.to_local().shape[1]
        group = mesh.get_group(i)
    out = _decode_core(ql.reshape(b, 1, hkv_l, h // hkv_l, hd), kn.to_local(), vn.to_local(),
                       k_old.to_local(), v_old.to_local(), cache_pos, cfg, layer_local,
                       k0=k0, group=group)
    return DTensor.from_local(out.reshape(b, 1, h, hd), mesh, want)


def _decode_core(qg, kn, vn, k_old, v_old, cache_pos, cfg: ArchConfig, layer_local,
                 k0: int = 0, group=None):
    """The two-block softmax combine of :func:`attention_decode_append` on
    plain tensors: ``(b, 1, kv, rep, hd)`` in ``v``'s dtype. ``k_old`` /
    ``v_old`` may be the block of the cache's positions ``k0 ..`` whose
    other blocks lie on the ranks of ``group``."""
    b = qg.shape[0]
    s_k = k_old.shape[1]
    hd = qg.shape[-1]
    scale = _scale(cfg, cfg.head_dim)
    lg_h = torch.einsum("bqkrd,bskd->bkrqs", qg, k_old).to(torch.float32) * scale
    lg_n = torch.einsum("bqkrd,bskd->bkrqs", qg, kn).to(torch.float32) * scale
    if cfg.attn_softcap > 0:
        lg_h = torch.tanh(lg_h / cfg.attn_softcap) * cfg.attn_softcap
        lg_n = torch.tanh(lg_n / cfg.attn_softcap) * cfg.attn_softcap
    dev = qg.device
    k_pos = (k0 + torch.arange(s_k, device=dev))[None, :]
    # cache_pos: scalar -> (1, 1); per-row -> (b, 1). Strict: slot
    # cache_pos is stale in k_old either way.
    cp = _cache_pos(cache_pos, dev)
    valid = k_pos < cp
    if layer_local and cfg.sliding_window:
        valid &= (cp - k_pos) < cfg.sliding_window
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    lg_h = lg_h + torch.where(valid[:, None, None, None, :], zero, torch.full_like(zero, NEG_INF))
    m_h = lg_h.amax(dim=-1, keepdim=True)
    e_h = torch.exp(lg_h - m_h)
    s_h = e_h.sum(dim=-1, keepdim=True)
    o_h = torch.einsum("bkrqs,bskd->bqkrd", e_h.to(v_old.dtype), v_old)
    if group is not None:          # the history's blocks on the other ranks
        import torch.distributed as dist
        m_all = m_h.clone()
        dist.all_reduce(m_all, op=dist.ReduceOp.MAX, group=group)
        w = torch.exp(m_h - m_all)                          # (b,kv,rep,1,1)
        s_h = placement.all_reduce_(s_h * w, group)
        o_h = placement.all_reduce_((o_h.to(torch.float32) * w.permute(0, 3, 1, 2, 4)),
                                    group).to(o_h.dtype)
        m_h = m_all
    m = torch.maximum(m_h, lg_n)
    alpha = torch.exp(m_h - m)                              # (b,kv,rep,1,1)
    beta = torch.exp(lg_n - m)
    aw = alpha.permute(0, 3, 1, 2, 4)                       # -> (b,1,kv,rep,1)
    bw = beta.permute(0, 3, 1, 2, 4)
    denom = s_h * alpha + beta
    dw = denom.permute(0, 3, 1, 2, 4)
    return (o_h * aw + bw * vn[:, :, :, None, :].to(o_h.dtype)) / dw


def attention_decode(p, x, cfg: ArchConfig, cache, cache_pos, *, layer_local: bool = False,
                     cross: bool = False, precomputed_q=None, skip_kv_write: bool = False):
    """One-token decode against a (B, S, Hkv, hd) KV cache.

    cache: {"k": ..., "v": ...}; cache_pos: an int (or a 0-d tensor), the
    write position. For cross attention the cache is the (static) encoder
    KV: non-rotary, every position valid, nothing written. Otherwise the new
    token's k/v are written into the cache IN PLACE at ``cache_pos`` (the
    reference returns an updated copy). ``precomputed_q`` (B, 1, H, hd), the
    token's rotated q, skips the token's projections; ``skip_kv_write``
    reads the cache as the caller left it (the token already written), so
    the two together project nothing. Returns (y, cache).
    """
    b = x.shape[0]
    if cross:
        q = _split(_proj(x, p["wq"], cfg), b, 1, cfg.n_heads, cfg.head_dim)
    else:
        if precomputed_q is not None:
            q = precomputed_q
        else:
            kn, vn, q = _new_kv(p, x, cfg, cache_pos)
        if not skip_kv_write:
            if precomputed_q is not None:
                raise ValueError("precomputed_q leaves no k/v to write: pass "
                                 "skip_kv_write=True with it")
            p0 = int(cache_pos)
            cache["k"][:, p0:p0 + 1] = kn.to(cache["k"].dtype)
            cache["v"][:, p0:p0 + 1] = vn.to(cache["v"].dtype)
    k, v = cache["k"], cache["v"]
    k_pos = torch.arange(k.shape[1], device=x.device)[None, :]
    if cross:
        valid = torch.ones_like(k_pos, dtype=torch.bool)
    else:
        cp = _cache_pos(cache_pos, x.device)
        valid = k_pos <= cp
        if layer_local and cfg.sliding_window:
            valid &= (cp - k_pos) < cfg.sliding_window
    zero = torch.zeros((), dtype=torch.float32, device=x.device)
    bias = torch.where(valid, zero, torch.full_like(zero, NEG_INF))    # (1, Sk)
    k = hint(k, ("batch", "seq_kv", "kv_heads", None))
    v = hint(v, ("batch", "seq_kv", "kv_heads", None))
    out = _sdpa(q, k, v, bias, cfg)
    return _proj(_split(out, b, 1, cfg.q_dim), p["wo"], cfg), cache


def attention_cache_defs(cfg: ArchConfig, batch: int, seq: int):
    shape = (batch, seq, cfg.n_kv_heads, cfg.head_dim)
    axes = ("batch", "seq_kv", "kv_heads", None)
    return {"k": ddef(shape, axes, init="zeros"), "v": ddef(shape, axes, init="zeros")}


# ---------------------------------------------------------------------------
# MLP
# ---------------------------------------------------------------------------

def mlp_defs(cfg: ArchConfig, d_ff=None):
    d, ff = cfg.d_model, d_ff or cfg.d_ff
    if cfg.act in ("swiglu", "geglu"):
        return {
            "wi": wdef(cfg, (d, ff), ("embed", "ff")),
            "wg": wdef(cfg, (d, ff), ("embed", "ff")),
            "wo": wdef(cfg, (ff, d), ("ff", "embed")),
        }
    return {"wi": wdef(cfg, (d, ff), ("embed", "ff")),
            "wo": wdef(cfg, (ff, d), ("ff", "embed"))}


def mlp_fwd(p, x, cfg: ArchConfig):
    """Gated MLP. GELU is the tanh form (``jax.nn.gelu``'s default)."""
    h = _proj(x, p["wi"], cfg)
    if cfg.act == "swiglu":
        h = F.silu(_proj(x, p["wg"], cfg)) * h
    elif cfg.act == "geglu":
        h = F.gelu(_proj(x, p["wg"], cfg), approximate="tanh") * h
    else:
        h = F.gelu(h, approximate="tanh")
    h = hint(h, ("batch", "seq", "ff"))
    return _proj(h, p["wo"], cfg)
