"""Plain oracles for the ported kernels — the mathematical definition, written
with no regard for performance (the ``"ref"`` lowering).

Ported: :func:`psram_matmul_ref`, the dense MTTKRP pair
(:func:`mttkrp_ref`, :func:`mttkrp_psram_ref`), the blocked segment sum
(:func:`blocked_segment_sum_ref`), the flat fused-stream oracle
:func:`stream_mttkrp_fused_ref` and the attention oracle
:func:`attention_ref`.
"""
from __future__ import annotations

import torch

from repro_torch.core.quantization import (
    ADCConfig,
    QMAX,
    adc_requantize,
    adc_transfer,
    exact_int_matmul,
)


def psram_matmul_ref(
    qx: torch.Tensor,     # (M, K) int8 — intensity-encoded inputs
    qw: torch.Tensor,     # (K, N) int8 — programmed array words
    sx: torch.Tensor,     # (M, 1) float32 per-row input scale
    sw: torch.Tensor,     # (1, N) float32 per-column weight scale
    adc_bits: int = 16,
) -> torch.Tensor:
    """ADC(int8 @ int8) * scales — the pSRAM array transfer function."""
    acc = exact_int_matmul(qx, qw)
    full_scale = float(QMAX) * float(QMAX) * qx.shape[-1]
    acc = adc_requantize(acc, ADCConfig(bits=adc_bits), full_scale)
    return acc * (sx * sw)


def mttkrp_ref(x0: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """Dense mode-0 MTTKRP from the unfolding: A = X_(0) @ (B ⊙row-major C).

    x0: (I, J*K) row-major over (j, k); b: (J, R); c: (K, R) -> (I, R).
    """
    j, r = b.shape
    k = c.shape[0]
    kr = (b[:, None, :] * c[None, :, :]).reshape(j * k, r)
    return x0 @ kr


def mttkrp_psram_ref(
    qx0: torch.Tensor,    # (I, J*K) int8 per-row-quantized unfolding
    sx: torch.Tensor,     # (I, 1) f32
    qb: torch.Tensor,     # (J, R) int8
    sb: torch.Tensor,     # (J, 1) f32
    qc: torch.Tensor,     # (K, R) int8
    sc: torch.Tensor,     # (K, 1) f32
    bi: int = 128,
    adc_bits: int = 16,
) -> torch.Tensor:
    """Quantized matricized-KR MTTKRP + per-output-tile observed-range ADC —
    the oracle of ``mttkrp_psram_fused`` / ``mttkrp_psram_torch``."""
    i = qx0.shape[0]
    j, r = qb.shape
    k = qc.shape[0]
    kr = (qb.to(torch.float32)[:, None] * qc.to(torch.float32)[None]
          ) * (sb[:, None] * sc[None])
    out = (qx0.to(torch.float32) * sx) @ kr.reshape(j * k, r)
    bi = min(bi, i)
    tiles = out.reshape(i // bi, bi, r)
    full_scale = tiles.abs().amax(dim=(1, 2), keepdim=True).clamp_min(1e-30)
    return adc_transfer(tiles, 2 ** adc_bits, full_scale).reshape(i, r)


def blocked_segment_sum_ref(
    data: torch.Tensor,     # (B, bn, R) chain-row blocks
    seg_ids: torch.Tensor,  # (B, bn) block-local segment ids in [0, n_seg)
    n_seg: int,
) -> torch.Tensor:
    """Per-block partial segment sums via a one-hot einsum: (B, n_seg, R)."""
    sids = torch.arange(n_seg, device=seg_ids.device)
    onehot = (seg_ids[:, None, :] == sids[None, :, None]).to(torch.float32)
    return torch.einsum("bsn,bnr->bsr", onehot, data.to(torch.float32))


def stream_mttkrp_fused_ref(ip, vp, lp, sp, qs, ss, mode, n_seg, adc_bits,
                            out_rows) -> torch.Tensor:
    """Flat oracle of the fused streaming MTTKRP: every chunk at once, the
    per-segment sums as the literal one-hot gather-mask contraction
    ``(nb, E, S, rows) @ (nb, E, rows, R)`` (the per-nonzero chain scale
    folded into the mask), the ADC over each chunk's own ``max|partial|``,
    one scatter-add. Memory grows with ``n_seg * rows`` per block — small
    inputs only.
    """
    nmodes = ip.shape[-1]
    others = [d for d in range(nmodes) if d != mode]
    # two-factor chains multiply exactly in int16 (127^2 < 2^15); longer
    # chains stay f32 (exact below 2^24)
    acc_t = torch.int16 if len(others) <= 2 else torch.float32
    had = None
    scale = vp                                          # (nb, E, rows)
    for d in others:
        idx = ip[..., d].long()
        g = qs[d][idx].to(acc_t)                        # (nb, E, rows, R)
        had = g if had is None else had * g
        scale = scale * ss[d][idx, 0]
    had = had.to(torch.float32)
    sids = torch.arange(n_seg, device=lp.device).view(1, 1, n_seg, 1)
    mask = (sids == lp[:, :, None, :]).to(torch.float32)
    mask = mask * scale[:, :, None, :]
    parts = mask @ had                                  # (nb, E, n_seg, R)
    if adc_bits:
        full_scale = parts.abs().amax(dim=(1, 2, 3), keepdim=True).clamp_min(1e-30)
        parts = adc_transfer(parts, 2 ** adc_bits, full_scale)
    rank = parts.shape[-1]
    out = torch.zeros((out_rows + 1, rank), dtype=torch.float32,
                      device=parts.device)
    out.index_add_(0, sp.reshape(-1).long(), parts.reshape(-1, rank))
    return out[:out_rows]


def attention_ref(
    q: torch.Tensor,      # (B, H, S, D)
    k: torch.Tensor,      # (B, Hkv, S, D)
    v: torch.Tensor,      # (B, Hkv, S, D)
    causal: bool = True,
    softcap: float = 0.0,
    scale: float | None = None,
) -> torch.Tensor:
    """Vanilla softmax attention with GQA broadcast, fp32 softmax; the
    weights are cast to ``v``'s dtype before the PV product, as in the
    reference. The causal mask is ``tril((S, S))``: it assumes Sq == Skv."""
    b, h, s, d = q.shape
    hkv = k.shape[1]
    rep = h // hkv
    k = torch.repeat_interleave(k, rep, dim=1)
    v = torch.repeat_interleave(v, rep, dim=1)
    scale = (d ** -0.5) if scale is None else scale
    logits = torch.einsum("bhqd,bhkd->bhqk", q, k).to(torch.float32) * scale
    if softcap > 0:
        logits = torch.tanh(logits / softcap) * softcap
    if causal:
        mask = torch.ones((s, s), dtype=torch.bool, device=q.device).tril()
        logits = torch.where(mask[None, None], logits,
                             torch.full_like(logits, -1e30))
    p = torch.softmax(logits, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", p.to(v.dtype), v)
