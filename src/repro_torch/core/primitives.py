"""The paper's three MTTKRP computational primitives (§IV), on the pSRAM array.

All three are expressed twice:
  * ``cp{1,2,3}_exact``  — plain float (the mathematical definition);
  * ``cp{1,2,3}_psram``  — through the array's quantized numerics
    (intensity-encoded inputs, 8-bit words, ADC), vectorized over the grid.

The *array-level* mapping (Figs. 3-4) is also simulated faithfully in
:func:`cp1_on_array` for one array tile, wavelength interleaving included —
the vectorized forms agree with driving the crossbar.
"""
from __future__ import annotations

import torch

from .psram import PsramArray, PsramConfig
from .quantization import ADCConfig, QMAX, adc_requantize, quantize_symmetric


# ---------------------------------------------------------------------------
# CP 1 — Hadamard product of factor matrix rows:  b_j ∘ c_k
# ---------------------------------------------------------------------------

def cp1_exact(b_row: torch.Tensor, c_row: torch.Tensor) -> torch.Tensor:
    return b_row * c_row


def cp1_psram(b_row: torch.Tensor, c_row: torch.Tensor,
              adc: ADCConfig | None = None) -> torch.Tensor:
    """Hadamard product through the array numerics.

    The row of B is *stored* (8-bit words, per-element column scale — each
    element of b sits in its own array column per Fig. 3), the row of C is
    *driven* as intensities. Wavelength interleaving means no cross-element
    accumulation, so each output is a 1-element "dot product" through the ADC.
    """
    adc = adc or ADCConfig()
    qb, sb = quantize_symmetric(b_row, axis=-1)   # stored: per-row scale
    qc, sc = quantize_symmetric(c_row, axis=-1)   # driven: per-row intensity scale
    prod = qb.to(torch.int32) * qc.to(torch.int32)
    full_scale = float(QMAX) * float(QMAX)        # single product per channel
    prod = adc_requantize(prod, adc, full_scale)
    return prod * (sb * sc)


def cp1_on_array(b_row: torch.Tensor, c_row: torch.Tensor,
                 config: PsramConfig | None = None) -> torch.Tensor:
    """Drive CP 1 on an actual simulated crossbar tile (Fig. 3 layout), on
    ``b_row``'s device.

    b_row is stored down one array *column* (one element per word/row); c_row
    is fed on the word-lines with interleaved wavelengths so that the bit-line
    sum never mixes two elements: row r uses channel r mod wavelengths, and we
    issue ceil(R / wavelengths) optical cycles.
    """
    from repro_torch.backends.base import resolve_config

    cfg = resolve_config(config)
    r = b_row.shape[0]
    if r > cfg.rows:
        raise ValueError(f"rank {r} exceeds array rows {cfg.rows}")
    dev = b_row.device
    arr = PsramArray(cfg, device=dev).store(b_row.reshape(-1, 1))
    out = torch.zeros((r,), dtype=torch.float32, device=dev)
    rows = torch.arange(cfg.rows, device=dev)
    channels = rows % cfg.wavelengths
    padded = torch.nn.functional.pad(c_row.to(torch.float32), (0, cfg.rows - r))
    for cycle in range((r + cfg.wavelengths - 1) // cfg.wavelengths):
        lo = cycle * cfg.wavelengths
        hi = min(lo + cfg.wavelengths, r)
        mask = (rows >= lo) & (rows < hi)
        drive = torch.where(mask, padded, 0.0)
        acc = arr.multiply_accumulate(drive, channels)  # (word_cols, wavelengths)
        out[lo:hi] = acc[0, torch.arange(lo, hi, device=dev) % cfg.wavelengths]
    return out


# ---------------------------------------------------------------------------
# CP 2 — scale with a tensor element:  x * (b_j ∘ c_k)
# ---------------------------------------------------------------------------

def cp2_exact(x: torch.Tensor, had: torch.Tensor) -> torch.Tensor:
    return x * had


def cp2_psram(x: torch.Tensor, had: torch.Tensor, adc: ADCConfig | None = None) -> torch.Tensor:
    """Tensor-element scaling through the array (Fig. 4: x stored, y driven)."""
    adc = adc or ADCConfig()
    qx, sx = quantize_symmetric(torch.atleast_1d(torch.as_tensor(x, dtype=torch.float32,
                                                                 device=had.device)), axis=-1)
    qh, sh = quantize_symmetric(had, axis=-1)
    prod = qx.to(torch.int32) * qh.to(torch.int32)
    prod = adc_requantize(prod, adc, float(QMAX) * float(QMAX))
    return (prod * (sx * sh)).reshape(had.shape)


# ---------------------------------------------------------------------------
# CP 3 — elementwise vector addition:  A_i + x * (b_j ∘ c_k)
# ---------------------------------------------------------------------------

def cp3_exact(a_row: torch.Tensor, scaled: torch.Tensor) -> torch.Tensor:
    return a_row + scaled


def cp3_psram(a_row: torch.Tensor, scaled: torch.Tensor) -> torch.Tensor:
    """Accumulation happens in the electrical domain post-ADC (§III-C): the
    digitized partial products are summed by the on-chip CMOS accumulator at
    full precision, so CP 3 is exact addition of two already-quantized values."""
    return a_row + scaled


# ---------------------------------------------------------------------------
# fused row update — one nonzero's full CP1→CP2→CP3 chain
# ---------------------------------------------------------------------------

def row_update_exact(a_row, x, b_row, c_row):
    return cp3_exact(a_row, cp2_exact(x, cp1_exact(b_row, c_row)))


def row_update_psram(a_row, x, b_row, c_row, adc: ADCConfig | None = None):
    had = cp1_psram(b_row, c_row, adc)
    scaled = cp2_psram(x, had, adc)
    return cp3_psram(a_row, scaled)
