"""Plain oracles for the ported kernels — the mathematical definition, written
with no regard for performance (the ``"ref"`` lowering).

Ported: :func:`psram_matmul_ref` and the flat fused-stream oracle
:func:`stream_mttkrp_fused_ref`. The oracles of the dense MTTKRP pair, the
blocked segment sum and attention come with their kernels.
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
