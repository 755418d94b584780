"""Mamba-2 (SSD — state-space duality) block, chunked.

The SSD form computes the selective state-space recurrence

    h_t = exp(dt_t A) h_{t-1} + dt_t B_t x_t ;   y_t = C_t h_t + D x_t

as chunk-local products (a quadratic-in-chunk "attention" term) plus an
inter-chunk recurrence over the compressed state (H, P, N) — the standard
Mamba-2 algorithm (arXiv:2405.21060 listing 1 semantics), in plain PyTorch.

Used both by mamba2-370m and for the Mamba layers of jamba. Decode is the
O(1) recurrent update with a (conv window, state) cache.

Port of the reference module whole: ``ssm_defs``, ``_split_in``,
``_conv_full``, ``_segsum``, ``ssd_chunked``, ``ssm_fwd``, ``xbc_tail``,
``ssm_cache_defs``, ``ssm_decode``. The reference's inter-chunk
``lax.scan`` is a loop over the chunks; its ``dist.sharding.hint`` sits
where the reference's does. Every SSD contraction is f32 with TF32 off (``_device.ieee_f32``),
so the card keeps the reference's ~1e-5. The reference's four-operand
einsums are taken two operands at a time, and where autograd is not
recording (serving runs under ``torch.inference_mode``) the ``(B, chunks,
H, q, q)`` weights are built in place: at most two such tensors live at
once (in ``_segsum``, the differences and their masked copy). While
autograd records, they are built out of place, since ``exp``'s backward
reads its output.
"""
from __future__ import annotations

import torch

from repro_torch.dist.sharding import hint
import torch.nn.functional as F

from repro_torch._device import ieee_f32

from .config import ArchConfig
from .layers import _proj, ddef, rmsnorm, rmsnorm_defs, wdef


def ssm_defs(cfg: ArchConfig):
    d, di, n, hds = cfg.d_model, cfg.d_inner_resolved, cfg.ssm_state, cfg.ssm_heads
    conv_ch = di + 2 * n  # x, B, C all pass the causal conv
    return {
        # fused input projection: [z (di), xBC (di+2n), dt (heads)]
        "in_proj": wdef(cfg, (d, 2 * di + 2 * n + hds), ("embed", "dinner")),
        "conv_w": ddef((cfg.ssm_conv, conv_ch), (None, "dinner"), scale=0.5),
        "conv_b": ddef((conv_ch,), ("dinner",), init="zeros"),
        "a_log": ddef((hds,), (None,), init="zeros"),
        "d_skip": ddef((hds,), (None,), init="ones"),
        "dt_bias": ddef((hds,), (None,), init="zeros"),
        "norm": rmsnorm_defs(di),
        "out_proj": wdef(cfg, (di, d), ("dinner", "embed")),
    }


def _split_in(p, x, cfg: ArchConfig):
    di, n = cfg.d_inner_resolved, cfg.ssm_state
    zxbcdt = _proj(x, p["in_proj"], cfg)
    z, xbc, dt = torch.split(zxbcdt, [di, di + 2 * n, zxbcdt.shape[-1] - 2 * di - 2 * n],
                             dim=-1)
    return z, xbc, dt


def _softplus(x):
    """``jax.nn.softplus``: ``logaddexp(x, 0)`` (no linear cut-over)."""
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype, device=x.device))


def _conv_full(p, xbc, cfg: ArchConfig):
    """Causal depthwise conv over the sequence (train/prefill path): the K
    taps summed in the reference's order, from 0, in ``xbc``'s dtype."""
    w = p["conv_w"]  # (K, C)
    k = w.shape[0]
    pad = F.pad(xbc, (0, 0, k - 1, 0))
    out = sum(pad[:, i:i + xbc.shape[1], :] * w[i] for i in range(k))
    return F.silu(out + p["conv_b"])


def _segsum(x):
    """exp-friendly segment sums: out[..., i, j] = sum_{j<t<=i} x[..., t];
    ``-inf`` above the diagonal (exactly 0 after ``exp``)."""
    t = x.shape[-1]
    cs = torch.cumsum(x, dim=-1)
    out = cs[..., :, None] - cs[..., None, :]
    mask = torch.tril(torch.ones((t, t), dtype=torch.bool, device=x.device), 0)
    return torch.where(mask, out, torch.full((), float("-inf"), dtype=out.dtype,
                                             device=out.device))


@ieee_f32()
def ssd_chunked(x, dt, a, b, c, chunk: int):
    """SSD scan. x:(B,S,H,P) dt:(B,S,H) a:(H,)<0 b,c:(B,S,N) (ngroups=1).

    Returns y:(B,S,H,P), final_state:(B,H,P,N).
    """
    bsz, s, h, p = x.shape
    n = b.shape[-1]
    q = min(chunk, s)
    if s % q:  # zero-pad the tail: dt=0 ⇒ decay 1, contribution 0 (inert)
        pad = q - s % q
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        b = F.pad(b, (0, 0, 0, pad))
        c = F.pad(c, (0, 0, 0, pad))
    s_pad = x.shape[1]
    nc = s_pad // q
    xc = x.reshape(bsz, nc, q, h, p)
    dtc = dt.reshape(bsz, nc, q, h)
    bc = b.reshape(bsz, nc, q, n)
    cc = c.reshape(bsz, nc, q, n)

    da = dtc * a  # (B, nc, q, H)
    da_cum = torch.cumsum(da, dim=2)

    # 1. intra-chunk (diagonal blocks): quadratic attention-like term,
    #    "bcqk,bchqk,bckh,bckhp->bcqhp" as one (B,nc,H,q,q) weight tensor
    #    and a batched product over k
    wts = _segsum(da.permute(0, 1, 3, 2))                         # (B,nc,H,q,q)
    cb = torch.einsum("bcqn,bckn->bcqk", cc, bc)[:, :, None]      # (B,nc,1,q,q)
    dtk = dtc.permute(0, 1, 3, 2)[:, :, :, None, :]               # (B,nc,H,1,q)
    if torch.is_grad_enabled():  # autograd saves exp's output: no writes into it
        wts = wts.exp() * cb * dtk
    else:
        wts.exp_().mul_(cb).mul_(dtk)
    y_diag = torch.einsum("bchqk,bckhp->bcqhp", wts, xc)
    del wts

    # 2. chunk states: what each chunk contributes to the running state
    decay_states = torch.exp(da_cum[:, :, -1:, :] - da_cum)       # (B,nc,q,H)
    xw = xc * (decay_states * dtc)[..., None]                     # (B,nc,q,H,P)
    states = torch.einsum("bckn,bckhp->bchpn", bc, xw)

    # 3. inter-chunk recurrence on the compressed state: the state entering
    #    each chunk, and the final state
    chunk_decay = torch.exp(da_cum[:, :, -1, :])                  # (B,nc,H)
    carry = torch.zeros((bsz, h, p, n), dtype=x.dtype, device=x.device)
    prev = []
    for i in range(nc):
        prev.append(carry)
        carry = carry * chunk_decay[:, i, :, None, None] + states[:, i]
    prev_states = torch.stack(prev, dim=1)                        # (B,nc,H,P,N)

    # 4. state -> output within each chunk
    state_decay = torch.exp(da_cum)                               # (B,nc,q,H)
    y_off = torch.einsum("bcqn,bchpn->bcqhp", cc, prev_states) * state_decay[..., None]
    y = (y_diag + y_off).reshape(bsz, s_pad, h, p)[:, :s]
    return y, carry


def _ssd_placed(x, dt, a, b, c, chunk: int):
    """:func:`ssd_chunked` on each rank's block: the scan is independent
    for each (row, head), so x (B, S, H, P) and dt (B, S, H) keep their
    split over the batch and the heads, b and c (B, S, N) their batch
    split (whole on a head axis, their gradients summed over it), a (H,)
    the heads'. Where x lies otherwise (its sequence split) DTensor's own
    rules run :func:`ssd_chunked`."""
    from torch.distributed.tensor import DTensor

    from repro_torch.dist.placement import Partial, Replicate, Shard
    mesh = x.device_mesh
    pls = tuple(x.placements)
    if any(isinstance(p, Partial) or (isinstance(p, Shard) and p.dim % 4 not in (0, 2))
           for p in pls):
        return ssd_chunked(x, dt, a, b, c, chunk)

    def moved(t, want):
        if not isinstance(t, DTensor):
            t = DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim)
        return t.redistribute(mesh, want) if tuple(t.placements) != tuple(want) else t

    heads = [isinstance(p, Shard) and p.dim % 4 == 2 for p in pls]
    bc_pls = tuple(p if isinstance(p, Shard) and p.dim % 4 == 0 else Replicate() for p in pls)
    bc_grad = tuple(Partial() if h else p for h, p in zip(heads, bc_pls))
    a_pls = tuple(Shard(0) if h else Replicate() for h in heads)
    dt, b, c, a = moved(dt, pls), moved(b, bc_pls), moved(c, bc_pls), moved(a, a_pls)
    y, final = ssd_chunked(x.to_local(), dt.to_local(), a.to_local(),
                           b.to_local(grad_placements=bc_grad),
                           c.to_local(grad_placements=bc_grad), chunk)
    f_pls = tuple(Shard(1) if h else p for h, p in zip(heads, pls))
    return DTensor.from_local(y, mesh, pls), DTensor.from_local(final, mesh, f_pls)


def ssm_fwd(p, x, cfg: ArchConfig):
    """Full-sequence SSD block. x: (B, S, D) -> (B, S, D), plus final cache."""
    bsz, s, d = x.shape
    di, n, hds, hp = cfg.d_inner_resolved, cfg.ssm_state, cfg.ssm_heads, cfg.ssm_headdim
    z, xbc, dt = _split_in(p, x, cfg)
    xbc = _conv_full(p, xbc, cfg)
    xin, b, c = torch.split(xbc, [di, n, n], dim=-1)
    xin = hint(xin.reshape(bsz, s, hds, hp), ("batch", "seq", "heads", None))
    dt = _softplus(dt + p["dt_bias"])                             # (B,S,H)
    a = -torch.exp(p["a_log"].to(torch.float32))                  # (H,)
    f32 = torch.float32
    scan = ssd_chunked
    if type(xin) is not torch.Tensor:
        from repro_torch.dist.placement import is_dtensor
        if is_dtensor(xin):
            scan = _ssd_placed
    y, final = scan(xin.to(f32), dt.to(f32), a, b.to(f32), c.to(f32), cfg.ssm_chunk)
    y = y + xin.to(f32) * p["d_skip"][None, None, :, None]
    y = y.reshape(bsz, s, di).to(x.dtype)
    y = rmsnorm(p["norm"], y * F.silu(z), cfg.norm_eps)
    out = _proj(y, p["out_proj"], cfg)
    cache = {
        "state": final.to(f32),                                   # (B,H,P,N)
        "conv": xbc_tail(p, x, cfg),                              # (B,K-1,C)
    }
    return out, cache


def xbc_tail(p, x, cfg: ArchConfig):
    """Last K-1 pre-conv channels, seeding the decode conv cache."""
    _, xbc, _ = _split_in(p, x[:, -(cfg.ssm_conv - 1):, :], cfg)
    return xbc


def ssm_cache_defs(cfg: ArchConfig, batch: int):
    di, n = cfg.d_inner_resolved, cfg.ssm_state
    return {
        "state": ddef((batch, cfg.ssm_heads, cfg.ssm_headdim, n),
                      ("batch", "heads", None, None), init="zeros"),
        "conv": ddef((batch, cfg.ssm_conv - 1, di + 2 * n),
                     ("batch", None, "dinner"), init="zeros"),
    }


def ssm_decode(p, x, cfg: ArchConfig, cache):
    """One-token recurrent update. x: (B, 1, D). Returns (y, new cache) with
    the new state in f32 and the conv window in ``x``'s dtype; the caller
    casts them to its cache's dtypes."""
    bsz = x.shape[0]
    di, n, hds, hp = cfg.d_inner_resolved, cfg.ssm_state, cfg.ssm_heads, cfg.ssm_headdim
    f32 = torch.float32
    z, xbc, dt = _split_in(p, x, cfg)                             # (B,1,*)
    window = torch.cat([cache["conv"], xbc], dim=1)               # (B,K,C)
    with ieee_f32():
        conv_out = torch.einsum("bkc,kc->bc", window, p["conv_w"]) + p["conv_b"]
    xbc1 = F.silu(conv_out)[:, None, :]
    xin, b, c = torch.split(xbc1, [di, n, n], dim=-1)
    xin = xin.reshape(bsz, hds, hp).to(f32)
    dt1 = _softplus(dt[:, 0] + p["dt_bias"]).to(f32)              # (B,H)
    a = -torch.exp(p["a_log"].to(f32))
    decay = torch.exp(dt1 * a)                                    # (B,H)
    bt = b[:, 0].to(f32)                                          # (B,N)
    ct = c[:, 0].to(f32)
    with ieee_f32():
        new_state = (cache["state"] * decay[:, :, None, None]
                     + (dt1[:, :, None] * xin)[..., None] * bt[:, None, None, :])
        y = torch.einsum("bhpn,bn->bhp", new_state, ct)
    y = y + xin * p["d_skip"][None, :, None]
    y = y.reshape(bsz, 1, di).to(x.dtype)
    y = rmsnorm(p["norm"], y * F.silu(z), cfg.norm_eps)
    out = _proj(y, p["out_proj"], cfg)
    return out, {"state": new_state, "conv": window[:, 1:, :]}
